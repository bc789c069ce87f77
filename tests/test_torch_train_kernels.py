"""The port's training kernels (K1-K5) against the JAX package, on the CPU.

Each case feeds the same numpy-seeded inputs to the JAX kernel in interpret
mode (``training=True``: its dropout masks are the coordinate hash there)
and to the port's wrapper, whose CPU path is the plain PyTorch version. The
training forward and ``jax.vjp`` of the JAX kernel are compared with the
port's forward and its autograd backward, with dropout ON at fixed seeds and
DropPath factors: this is what shows that the port's masks are the JAX
kernels' bit for bit (a wrong coordinate shifts whole masks and fails by
orders of magnitude). The JAX kernels take the TPU's padded layouts (NP, TP);
the test pads on the JAX side, gives pad rows a zero cotangent and compares
the valid rows.

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance), except
where a case states a looser bound and its reason.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from multimodal_neuroimage_tpu.nn.swin2d import relative_position_index
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu.ops import fused_update as jfu
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu.nn.swin2d import shift_attn_mask
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl
from multimodal_neuroimage_tpu_torch.ops import fused_update as tfu
from multimodal_neuroimage_tpu_torch.ops import fusion_block as tfb

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
RATES = (0.25, 0.2)         # (attention, hidden/proj/MLP) dropout
SEED = 1234567


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


# ---- the mask hash itself ------------------------------------------------------

def test_mix_keep_is_the_jax_hash_bit_for_bit():
    """Against ``_mix_keep`` on the same int32 coordinates, including rows
    and columns past 2^31 / int32 wraparound of the products."""
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2 ** 31 - 1, size=(64, 1), dtype=np.int64)
    c = rng.integers(0, 2 ** 20, size=(1, 48), dtype=np.int64)
    for seed, draw, rate in ((0, 0, 0.1), (2 ** 31 - 2, 3, 0.25),
                             (987654321, 2, 0.5)):
        def kern(r_ref, c_ref, o_ref, seed=seed, draw=draw, rate=rate):
            o_ref[...] = jfb._mix_keep(r_ref[...], c_ref[...], rate,
                                       jnp.int32(seed), draw)

        want = pl.pallas_call(
            kern, out_shape=jax.ShapeDtypeStruct((64, 48), jnp.float32),
            interpret=True)(jnp.asarray(r, jnp.int32),
                            jnp.asarray(c, jnp.int32))
        got = tfb.mix_keep(torch.from_numpy(r), torch.from_numpy(c), rate,
                           seed, draw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        kept = float((got.numpy() > 0).mean())
        assert abs(kept - (1 - rate)) < 0.05


# ---- K2/K3: fusion blocks --------------------------------------------------------

B, RES, WS, C, HEADS = 2, 12, 6, 12, 6
N = WS * WS
NP = jfb.round_up(N, 8)
NW = (RES // WS) ** 2
DP = np.asarray([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], np.float32)


def _fusion_inputs(shift, cross):
    rng = np.random.default_rng(10 * shift + cross)
    shapes = jfb.param_shapes(C, 4 * C, cross)
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    for i in ((0, 2, 10) if cross else (0, 6)):     # LN scales positive
        params[i] = np.abs(params[i]) + 0.5
    x, y, g = (rng.normal(size=(B, NW, N, C)).astype(np.float32)
               for _ in range(3))
    table = (rng.normal(size=((2 * WS - 1) ** 2, HEADS)) * 0.1).astype(
        np.float32)
    return params, x, y, g, table, shift_attn_mask(RES, RES, WS, shift)


def _pad(t):
    return jnp.asarray(np.pad(t, ((0, 0), (0, 0), (0, NP - N), (0, 0))))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shift", [0, 3])
def test_fusion_block_training_matches_jax_vjp(shift, cross):
    params, x, y, g, table, mask = _fusion_inputs(shift, cross)
    rel = relative_position_index(WS, WS)
    maskp = (None if mask is None
             else np.pad(mask, ((0, 0), (0, NP - N), (0, NP - N))))

    def jax_fn(x, y, p, table):
        packed = jfb.packed_bias_from_table(table, WS, HEADS, NP, rel)
        if cross:
            return jfb.fused_cross_fusion_block(
                x, y, p, packed, maskp, jnp.asarray(DP), SEED, RATES, True,
                interpret=True)
        return jfb.fused_fusion_block(x, p, packed, maskp, jnp.asarray(DP),
                                      SEED, RATES, True, interpret=True)

    jp = tuple(jnp.asarray(t) for t in params)
    want, vjp = jax.vjp(jax_fn, _pad(x), _pad(y), jp, jnp.asarray(table))
    jdx, jdy, jdp, jdtable = vjp(_pad(g))

    tx, ty = (torch.from_numpy(t).requires_grad_() for t in (x, y))
    tp = [_to_port(p).requires_grad_() for p in params]
    ttable = torch.from_numpy(table).requires_grad_()
    bias = tfb.bias_from_table(
        ttable, torch.from_numpy(relative_position_index(WS, WS)), HEADS)
    tmask = None if mask is None else torch.from_numpy(mask)
    dp = torch.from_numpy(DP)
    if cross:
        got = tfb.fused_cross_fusion_block(tx, ty, tp, bias, tmask, dp, SEED,
                                           RATES, True)
    else:
        got = tfb.fused_fusion_block(tx, tp, bias, tmask, dp, SEED, RATES,
                                     True)
    assert got.grad_fn is not None and "FusionBlock" in type(
        got.grad_fn).__name__
    got.backward(torch.from_numpy(g))

    _close(got.detach(), np.asarray(want)[:, :, :N], msg="out")
    _close(tx.grad, np.asarray(jdx)[:, :, :N], msg="dx")
    if cross:
        _close(ty.grad, np.asarray(jdy)[:, :, :N], msg="dy")
    for i, (a, b) in enumerate(zip(tp, jdp)):
        _close(a.grad, _to_port(b), msg=f"dparams[{i}]")
    _close(ttable.grad, jdtable, msg="dtable")


def test_fusion_dropout_and_droppath_change_the_block():
    """The training forward is not the inference one, and the DropPath
    factor of 0 removes the MLP branch exactly (subject 0, dp2 = 0)."""
    params, x, _, _, table, _ = _fusion_inputs(0, False)
    bias = tfb.bias_from_table(
        torch.from_numpy(table),
        torch.from_numpy(relative_position_index(WS, WS)), HEADS)
    tp = [_to_port(p) for p in params]
    xt = torch.from_numpy(x)
    with torch.no_grad():
        train = tfb.fused_fusion_block(xt, tp, bias, None,
                                       torch.from_numpy(DP), SEED, RATES,
                                       True)
        infer = tfb.fused_fusion_block(xt, tp, bias)
        no_mlp = tfb.fusion_block_reference(
            xt, tp, bias, None, torch.from_numpy(DP), SEED, (RATES[0], 0.0),
            True)
    assert (train - infer).abs().max() > 1e-2
    # with hidden dropout off, subject 0 (dp2 = 0) is x + dp1 * attention
    # branch only; recompute that branch by zeroing the MLP output weights
    tp0 = list(tp)
    tp0[10] = torch.zeros_like(tp0[10])
    tp0[11] = torch.zeros_like(tp0[11])
    with torch.no_grad():
        attn_only = tfb.fusion_block_reference(
            xt, tp0, bias, None, torch.from_numpy(DP), SEED, (RATES[0], 0.0),
            True)
    _close(no_mlp[0], attn_only[0])


# ---- K1: BERT layer ----------------------------------------------------------------

BT, BH, BHEADS, BF = 37, 28, 4, 64          # hd 7: odd, like the flagship


@pytest.mark.parametrize("t_valid", [BT, 30])
def test_bert_layer_training_matches_jax_vjp(t_valid):
    rng = np.random.default_rng(t_valid)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(BH, BF)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    x = rng.normal(size=(2, BT, BH)).astype(np.float32)
    g = rng.normal(size=(2, BT, BH)).astype(np.float32)
    TP = jbl.round_up(BT, 8)
    pad = ((0, 0), (0, TP - BT), (0, 0))

    def jax_fn(x, p):
        return jbl.bert_layer_call(x, p, SEED, BHEADS, t_valid, RATES, True,
                                   interpret=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(np.pad(x, pad)),
                        tuple(jnp.asarray(t) for t in params))
    jdx, jdp = vjp(jnp.asarray(np.pad(g, pad)))

    tx = torch.from_numpy(x).requires_grad_()
    tp = [_to_port(p).requires_grad_() for p in params]
    got = tbl.bert_layer_call(tx, tp, BHEADS, t_valid, SEED, RATES, True)
    assert "BertLayer" in type(got.grad_fn).__name__
    got.backward(torch.from_numpy(g))
    _close(got.detach(), np.asarray(want)[:, :BT], msg="out")
    _close(tx.grad, np.asarray(jdx)[:, :BT], msg="dx")
    for i, (a, b) in enumerate(zip(tp, jdp)):
        _close(a.grad, _to_port(b), msg=f"dparams[{i}]")


def test_bert_layer_inference_ignores_the_seed():
    rng = np.random.default_rng(5)
    params = [_to_port(rng.normal(size=s).astype(np.float32) * 0.15)
              for s in jbl.param_shapes(BH, BF)]
    x = torch.from_numpy(rng.normal(size=(2, BT, BH)).astype(np.float32))
    with torch.no_grad():
        a = tbl.bert_layer_call(x, params, BHEADS, BT, 1, RATES, False)
        b = tbl.bert_layer_call(x, params, BHEADS, BT, 2, RATES, False)
        c = tbl.bert_layer_call(x, params, BHEADS, BT, 2, RATES, True)
    assert torch.equal(a, b) and (a - c).abs().max() > 1e-2


# ---- K4: window attention backward ---------------------------------------------------

@pytest.mark.parametrize("N4,nW,H,shift_res", [(36, 4, 3, 12), (36, 1, 6, 0),
                                               (9, 1, 12, 0)])
def test_window_attention_backward_matches_jax(N4, nW, H, shift_res):
    rng = np.random.default_rng(N4 + nW + H)
    D = 4
    ws = int(np.sqrt(N4))
    q, k, v, g = (rng.normal(size=(2, nW, H, N4, D)).astype(np.float32)
                  for _ in range(4))
    q *= 3
    bias = (16 / (1 + np.exp(-rng.normal(size=(H, N4, N4))))).astype(
        np.float32)
    mask = (shift_attn_mask(shift_res, shift_res, ws, ws // 2)
            if shift_res else None)
    want, vjp = jax.vjp(
        lambda q, k, v, b: jatt.fused_window_attention(q, k, v, b, mask,
                                                       interpret=True),
        *(jnp.asarray(t) for t in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    got = tatt.fused_window_attention(
        *ins, None if mask is None else torch.from_numpy(mask))
    assert "WindowAttention" in type(got.grad_fn).__name__
    got.backward(torch.from_numpy(g))
    _close(got.detach(), want)
    for name, a, b in zip("q k v bias".split(), ins, jgrads):
        _close(a.grad, b, msg=name)


# ---- K5: fused Adam -------------------------------------------------------------

def _schedule(t):
    return 1e-2 * 0.5 ** (t // 2)


@pytest.mark.parametrize("mode", ["adam", "adamw"])
@pytest.mark.parametrize("clip", [False, True])
def test_fused_adam_matches_jax_kernel_and_optax(mode, clip):
    """Three steps from the same params and gradients: the port's FusedAdam
    (plain version on the CPU) against the JAX ``fused_adam`` (interpret)
    and the optax chain it replaces. Clipping at max norm 0.5 is active."""
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in
              shapes.items()} for _ in range(3)]
    wd = 0.05

    def run_optax(tx):
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = tx.init(p)
        for gr in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()},
                                   state, p)
            p = optax.apply_updates(p, upd)
        return p

    kernel = jfu.fused_adam(_schedule, wd, mode=mode, gradient_clipping=clip,
                            clip_max_norm=0.5, interpret=True)
    parts = [optax.clip_by_global_norm(0.5)] if clip else []
    parts += ([optax.add_decayed_weights(wd), optax.scale_by_adam()]
              if mode == "adam"
              else [optax.scale_by_adam(), optax.add_decayed_weights(wd)])
    chain = optax.chain(*parts, optax.scale_by_learning_rate(_schedule))
    want_kernel, want_chain = run_optax(kernel), run_optax(chain)

    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in sorted(shapes)]
    opt = tfu.FusedAdam(tparams, _schedule, wd, mode, clip, 0.5)
    for gr in grads:
        opt.zero_grad()
        for p, k in zip(tparams, sorted(shapes)):
            p.grad.copy_(torch.from_numpy(gr[k]))
        opt.step()
    assert opt.count == 3
    for p, k in zip(tparams, sorted(shapes)):
        # the JAX kernel's ravel order is the sorted key order too
        _close(p.detach(), want_kernel[k], rtol=1e-5, atol=1e-6, msg=k)
        _close(p.detach(), want_chain[k], rtol=1e-5, atol=1e-6, msg=k)


def test_fused_adam_params_and_grads_are_views_of_flat_buffers():
    lin = torch.nn.Linear(3, 2)
    opt = tfu.FusedAdam(lin.parameters(), lambda t: 0.1, 0.0)
    lin(torch.ones(4, 3)).sum().backward()
    assert lin.weight.grad.data_ptr() == opt.grads.data_ptr()
    assert torch.equal(opt.grads[:6], lin.weight.grad.reshape(-1))
    before = opt.params.clone()
    opt.step()
    assert torch.equal(lin.weight.detach().reshape(-1), opt.params[:6])
    assert not torch.equal(before, opt.params)
    lin.weight.grad = torch.zeros(2, 3)
    with pytest.raises(RuntimeError, match="flat gradient"):
        opt.step()
    with pytest.raises(ValueError, match="adam/adamw"):
        tfu.FusedAdam(lin.parameters(), lambda t: 0.1, 0.0, mode="sgd")
