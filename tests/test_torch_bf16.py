"""The port at the bf16 policy against the JAX package, on the CPU.

The flagship's shipping configuration is ``compute_dtype="bfloat16"``:
parameters and batch cast to bf16, the temporal BERTs on a float32 stream
with bf16 products (K1's mm16 form), the SwinFusion backbone on float32
(std layout) or bf16 (bp layout, K7's bf16 form) streams. Each case feeds
the same numpy-seeded inputs to the JAX package (kernels in interpret mode,
dropout on at fixed seeds where a kernel is held alone) and to the port's
plain versions.

Tolerances. The JAX side rounds at the same points; what differs is the
order of float32 sums, which can move a value across a bf16 rounding
boundary (one bf16 ulp = 2^-8 relative), and that step then propagates:
the kernels' plain versions against the JAX kernels within 2e-3 +
2e-3 |ref| (forward; bf16 outputs 2^-7 relative, two ulps) and 5e-3
max|ref| (gradients). The modules around the kernels also round in their
framework's own elementwise arithmetic (JAX rounds a bf16 tanh' or GELU'
op by op, PyTorch's CPU kernels once), about one ulp: the fMRI embedder
(two BERTs, projection, diagonal) is held within 3e-2 max|ref| a gradient,
the SwinFusion backbone (float32 streams, bf16 weights) within 1e-2. In the
whole tiny flagship the backbone amplifies those ulps (near-constant
LayerNorm rows of the diagonal embedding), so the whole-model test holds
logits and loss within 1e-3 + 1e-3 |ref| and each gradient within a share
of its component's largest gradient: SwinV2 head 5e-3, backbone 0.05, fMRI
embedder 0.15 (measured on the std and bp layouts, JAX's loss_fn given the
batch as device arrays so that ``_cast_tree`` rounds it to bf16: logits
6.1e-6 and 1.3e-4, loss 1.2e-7 and 3.7e-6, shares 0.0008 and 0.0032,
0.0046 and 0.018, 0.012 and 0.061; a numpy batch stays float32 under
``_cast_tree``, and on it the shares were 0.003, 0.043-0.093, 0.14-0.16).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.nn import swinfusion as jsf
from multimodal_neuroimage_tpu.nn.swin2d import (relative_position_index,
                                                 shift_attn_mask)
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu.ops import fusion_block_bp as jfbp
from multimodal_neuroimage_tpu.serve.predictor import (
    make_predict_step as jpredict_step)
from multimodal_neuroimage_tpu.train.losses import bce_with_logits as jbce
from multimodal_neuroimage_tpu.train.state import _cast_tree
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn import swin2d as tsw
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl
from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as tfbp
from multimodal_neuroimage_tpu_torch.serve.predictor import make_predict_step
from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.state import (batch_to_device,
                                                         bf16_weights,
                                                         flatten_parameters,
                                                         forward_at)
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RATES = (0.25, 0.2)         # (attention, hidden/proj/MLP) dropout
SEED = 1234567
FWD_RTOL = FWD_ATOL = 2e-3
GRAD_REL = 5e-3
# a bf16 stream (K7's bf16 outputs and input gradients) holds 8 bits: one
# rounding step either side of a boundary is 2^-8 relative
BF16_RTOL = 2.0 ** -7


def _close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _close_grad(got, want, rel=GRAD_REL, msg=""):
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    _close(got, want, rtol=0.0, atol=rel * scale + 1e-6, msg=msg)


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


# ---- K1 mm16 --------------------------------------------------------------------

BT, BH, BHEADS, BF = 37, 28, 4, 64          # hd 7: odd, like the flagship


@pytest.mark.parametrize("t_valid,training", [(BT, True), (30, True),
                                              (BT, False)])
def test_bert_layer_mm16_matches_jax_vjp(t_valid, training):
    """K1's mm16 plain forward and its written-out backward against
    ``bert_layer_call(..., mm16=True, interpret=True)`` and its VJP, dropout
    on at a fixed seed; parameters bf16-valued as the bf16 policy gives
    them, and the stream float32."""
    rng = np.random.default_rng(t_valid + 7 * training)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(BH, BF)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    params = [np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
              for p in params]
    x = rng.normal(size=(2, BT, BH)).astype(np.float32)
    g = rng.normal(size=(2, BT, BH)).astype(np.float32)
    TP = jbl.round_up(BT, 8)
    pad = ((0, 0), (0, TP - BT), (0, 0))

    def jax_fn(x, p):
        return jbl.bert_layer_call(x, p, SEED, BHEADS, t_valid, RATES,
                                   training, interpret=True, mm16=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(np.pad(x, pad)),
                        tuple(jnp.asarray(t) for t in params))
    jdx, jdp = vjp(jnp.asarray(np.pad(g, pad)))

    tx = torch.from_numpy(x).requires_grad_()
    tp = [_to_port(p).requires_grad_() for p in params]
    got = tbl.bert_layer_call(tx, tp, BHEADS, t_valid, SEED, RATES, training,
                              mm16=True)
    assert "BertLayer" in type(got.grad_fn).__name__
    got.backward(torch.from_numpy(g))
    _close(got.detach(), np.asarray(want)[:, :BT], msg="out")
    _close_grad(tx.grad, np.asarray(jdx)[:, :BT], msg="dx")
    for i, (a, b) in enumerate(zip(tp, jdp)):
        if i == 3:
            # the key bias's gradient is zero in exact arithmetic (each
            # query's ds sums to 0 over the keys): what remains is the
            # rounding of the bf16 ds, held at the scale of the key
            # weight's gradient, a product of the same dk rows
            scale = float(np.abs(np.asarray(jdp[2])).max())
            _close(a.grad, _to_port(b), rtol=0.0, atol=GRAD_REL * scale,
                   msg="dparams[3]")
        else:
            _close_grad(a.grad, _to_port(b), msg=f"dparams[{i}]")


def test_bert_layer_mm16_differs_from_f32_and_rounds_its_products():
    """The mm16 form is not the float32 layer (its products round), and its
    plain forward is unchanged by pre-rounding x and the weights to bf16
    (each product rounds them anyway)."""
    rng = np.random.default_rng(3)
    params = [torch.from_numpy(_to_port(rng.normal(size=s).astype(
        np.float32) * 0.15).numpy()) for s in jbl.param_shapes(BH, BF)]
    x = torch.from_numpy(rng.normal(size=(2, BT, BH)).astype(np.float32))
    f32 = tbl.bert_layer_reference(x, params, BHEADS, BT)
    m16 = tbl.bert_layer_reference(x, params, BHEADS, BT, mm16=True)
    assert (f32 - m16).abs().max() > 1e-3
    rounded = [p if p.ndim == 1 else tbl.bf16_round(p) for p in params]
    again = tbl.bert_layer_reference(x, rounded, BHEADS, BT, mm16=True)
    torch.testing.assert_close(again, m16, rtol=0, atol=0)


# ---- K7 with bf16 streams -------------------------------------------------------

FC, FH, FCH, FWS, FRES = 8, 2, 32, 4, 8      # C, heads, hidden, window, side
FN = FWS * FWS
FNP = jfb.round_up(FN, 8)
DP = np.array([[1.25, 0.0], [1.0, 1.25], [0.0, 1.0], [1.25, 1.25]],
              np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("cross,shift", [(False, 0), (True, 2)])
def test_fusion_block_bp_bf16_matches_jax(cross, shift, monkeypatch):
    """K7's bf16 form (bf16 streams, mm16 products): the plain forward and
    its written-out backward against ``fused_[cross_]fusion_block_bp`` on
    bf16 group-major streams (interpret mode, dropout and DropPath on, two
    groups of two subjects); gradients of bf16-valued float32 parameters."""
    monkeypatch.setenv("FUSION_BP_GROUP", "2")
    rng = np.random.default_rng(11 + shift)
    B, nW = 4, (FRES // FWS) ** 2
    table = _bf16(rng.normal(size=((2 * FWS - 1) ** 2, FH)) * 0.3)
    rel = relative_position_index(FWS, FWS)
    bias_t = table[rel.reshape(-1)].reshape(FN, FN, FH).transpose(2, 0, 1)
    jbias = jfb.packed_bias_from_table(jnp.asarray(table), FWS, FH, FNP,
                                       rel)
    mask = shift_attn_mask(FRES, FRES, FWS, shift)
    mask = None if mask is None else mask.astype(np.float32)
    shapes = ([(1, FC), (1, FC)]
              + ([(1, FC), (1, FC), (FC, FC), (1, FC), (FC, 2 * FC),
                  (1, 2 * FC)] if cross else [(FC, 3 * FC), (1, 3 * FC)])
              + [(FC, FC), (1, FC), (1, FC), (1, FC), (FC, FCH), (1, FCH),
                 (FCH, FC), (1, FC)])
    params = [_bf16(rng.normal(size=s) * 0.3) for s in shapes]
    for i in ([0, 2] if cross else [0]) + [len(shapes) - 6]:
        params[i] = _bf16(np.abs(params[i]) + 0.5)
    x = _bf16(rng.normal(size=(B, nW, FN, FC)))
    y = _bf16(rng.normal(size=(B, nW, FN, FC)))
    g = _bf16(rng.normal(size=(B, nW, FN, FC)))
    G = 2

    def to4(t):          # (B, nW, N, C) -> padded group-major (B/G, nW, NP, G*C)
        t = np.pad(t, ((0, 0), (0, 0), (0, FNP - FN), (0, 0)))
        return jnp.asarray(t.reshape(B // G, G, nW, FNP, FC).transpose(
            0, 2, 3, 1, 4).reshape(B // G, nW, FNP, G * FC), jnp.bfloat16)

    def from4(t):
        t = np.asarray(jnp.asarray(t, jnp.float32))
        return t.reshape(B // G, nW, FNP, G, FC).transpose(
            0, 3, 1, 2, 4).reshape(B, nW, FNP, FC)[:, :, :FN]

    jmask = (None if mask is None else
             np.pad(mask, ((0, 0), (0, FNP - FN), (0, FNP - FN))))
    jp = tuple(jnp.asarray(p) for p in params)
    if cross:
        fn = lambda x, y, p, b: jfbp.fused_cross_fusion_block_bp(
            x, y, p, b, jmask, DP, SEED, RATES, True, interpret=True)
        want, vjp = jax.vjp(fn, to4(x), to4(y), jp, jbias)
        jdx, jdy, jdp, jdb = vjp(to4(g))
    else:
        fn = lambda x, p, b: jfbp.fused_fusion_block_bp(
            x, p, b, jmask, DP, SEED, RATES, True, interpret=True)
        want, vjp = jax.vjp(fn, to4(x), jp, jbias)
        jdx, jdp, jdb = vjp(to4(g))

    def port4(t):
        return tfbp.to_groups(torch.from_numpy(t.copy()), G).to(torch.bfloat16)

    tx = port4(x).requires_grad_()
    ty = port4(y).requires_grad_() if cross else None
    tp = [_to_port(p).requires_grad_() for p in params]
    tb = torch.from_numpy(np.ascontiguousarray(bias_t)).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    args = (tp, tb, tm, torch.from_numpy(DP), SEED, RATES, True)
    got = (tfbp.fused_cross_fusion_block_bp(tx, ty, *args) if cross
           else tfbp.fused_fusion_block_bp(tx, *args))
    assert got.dtype == torch.bfloat16
    got.backward(port4(g))
    unport = lambda t: tfbp.from_groups(t.float(), G).numpy()
    _close(unport(got.detach()), from4(want), rtol=BF16_RTOL, msg="out")
    _close_grad(unport(tx.grad), from4(jdx), rel=2 * BF16_RTOL, msg="dx")
    if cross:
        _close_grad(unport(ty.grad), from4(jdy), rel=2 * BF16_RTOL, msg="dy")
    for i, (a, b) in enumerate(zip(tp, jdp)):
        _close_grad(a.grad, _to_port(b), msg=f"dparams[{i}]")
    jdb = np.asarray(jdb, np.float32).reshape(FNP, FH, FNP)[:FN, :, :FN]
    _close_grad(tb.grad, jdb.transpose(1, 0, 2), msg="dbias")


# ---- the tiny flagship at the bf16 policy ----------------------------------------

NO_DROPOUT = dict(transformer_dropout_rate=0.0, bert_attn_dropout=0.0,
                  fusion_drop_rate=0.0, fusion_attn_drop_rate=0.0,
                  fusion_drop_path_rate=0.0)
MODEL_RTOL = MODEL_ATOL = 1e-3
MODEL_GRAD_REL = {"swin": 5e-3, "fusion": 0.05, "fmri_embed": 0.15}


def _record(monkeypatch, module, name, seen, key):
    """Wrap module.name so that each call records its stream's dtype and
    what its parameters hold: their dtype (JAX), or "bf16 values" for the
    port's float32 tensors that hold bf16 values."""
    orig = getattr(module, name)

    def wrapped(*args, **kwargs):
        params = next(a for a in args if isinstance(a, (tuple, list)))
        held = str(params[0].dtype).replace("torch.", "")
        if isinstance(params[0], torch.Tensor) and all(
                torch.equal(p, p.to(torch.bfloat16).float()) for p in params):
            held = "bf16 values"
        seen.setdefault(key, set()).add(
            (str(args[0].dtype).replace("torch.", ""), held))
        return orig(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def _record_k4(monkeypatch, module, seen, key):
    orig = module.fused_window_attention

    def wrapped(q, *args, **kwargs):
        seen.setdefault(key, set()).add(str(q.dtype).replace("torch.", ""))
        return orig(q, *args, **kwargs)

    monkeypatch.setattr(module, "fused_window_attention", wrapped)


@pytest.mark.parametrize("layout", ["std", "bp"])
def test_tiny_flagship_bf16_matches_jax(layout, monkeypatch):
    """The tiny flagship at compute_dtype="bfloat16", dropout off: the port's
    predict step's logits, and its training forward's loss and every
    parameter gradient (the float32 masters' gradients through the bf16
    casts), against JAX's make_predict_step and the JAX train step's
    loss_fn (_cast_tree of parameters and batch, outputs widened) under
    jax.value_and_grad, the fused kernels in interpret mode; the batch
    reaches ``_cast_tree`` as device arrays, which it rounds to bf16 (a
    numpy batch it leaves float32). Records the
    dtypes reaching the fusion kernels and K4 on both sides: float32 std
    streams (K2/K3) and bf16 bp streams (K7, JAX's _stream16_active
    patched on as on the TPU), bf16 parameters, a float32 K4 input."""
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="bfloat16", preprocess="host",
                               batch_size=2, **NO_DROPOUT).validate()
    model = jcreate(jcfg)
    batch = _example_batch(2, t=32, r=jcfg.intermediate_vec)
    batch["target"] = np.asarray([0.0, 1.0], np.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    monkeypatch.setattr(jsf, "_LAYOUT", layout)
    monkeypatch.setattr(tsf, "_LAYOUT", layout)
    if layout == "bp":
        monkeypatch.setattr(jsf, "_stream16_active", lambda: True)
    seen = {}
    names = (("fused_fusion_block_bp", "fused_cross_fusion_block_bp")
             if layout == "bp"
             else ("fused_fusion_block", "fused_cross_fusion_block"))
    jmod = jfbp if layout == "bp" else jfb
    for n in names:
        _record(monkeypatch, jmod, n, seen, "jax fusion")
        _record(monkeypatch, tsf, n, seen, "port fusion")
    _record_k4(monkeypatch, jatt, seen, "jax K4")
    _record_k4(monkeypatch, tsw, seen, "port K4")

    def loss_fn(p):
        out = model.apply({"params": _cast_tree(p, jnp.bfloat16)},
                          _cast_tree(jax.tree_util.tree_map(jnp.asarray, batch),
                                     jnp.bfloat16), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1),
                                "droppath": jax.random.PRNGKey(2)})
        logits = _cast_tree(out, jnp.float32)["binary_classification"]
        return jbce(logits.squeeze(-1), jnp.asarray(batch["target"]))

    jatt.set_fused_attention(True)    # the kernels, interpreted
    try:
        want_logits = jpredict_step(model, "bfloat16")(
            params, batch)["binary_classification"]
        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    finally:
        jatt.set_fused_attention(None)

    cfg = Config(**dataclasses.asdict(jcfg))
    port = create_model(cfg)
    port.load_state_dict(jax_params_to_state_dict(params))
    got_logits = make_predict_step(port, "bfloat16", "cpu")(
        batch)["binary_classification"]
    _close(got_logits, want_logits, rtol=MODEL_RTOL, atol=MODEL_ATOL,
           msg="logits")

    port.train()
    inputs = batch_to_device(batch, "cpu")
    with bf16_weights(port.parameters()):
        out = forward_at(port, inputs, "bfloat16",
                         torch.Generator().manual_seed(0))
        loss = compute_losses(out, inputs, active_losses(
            cfg.task, cfg.fine_tune_task))["total"]
        loss.backward()
    _round_grads(port)
    _close(loss.item(), float(want_loss), rtol=MODEL_RTOL, atol=MODEL_ATOL,
           msg="loss")
    want = jax_params_to_state_dict(want_grads)
    grads = dict(port.named_parameters())
    assert set(want) == set(grads)
    scale = {}
    for name, w in want.items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), float(w.abs().max()))
    worst = {}
    for name, p in grads.items():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        # a bf16 cotangent widened: exactly representable in bf16
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float()), name
        part = name.split(".")[0]
        err = float((p.grad - want[name]).abs().max()) / scale[part]
        worst[part] = max(worst.get(part, 0.0), err)
        assert err <= MODEL_GRAD_REL[part], (name, err)

    stream = "bfloat16" if layout == "bp" else "float32"
    assert seen["jax fusion"] == {(stream, "bfloat16")}
    assert seen["port fusion"] == {(stream, "bf16 values")}
    assert seen["jax K4"] == seen["port K4"] == {"float32"}


def _tiny_bf16_parts():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="bfloat16", preprocess="host",
                               batch_size=2, **NO_DROPOUT).validate()
    model = jcreate(jcfg)
    batch = _example_batch(2, t=32, r=jcfg.intermediate_vec)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    port = create_model(Config(**dataclasses.asdict(jcfg)))
    port.load_state_dict(jax_params_to_state_dict(params))
    return jcfg, params, batch, port, rng


def _round_grads(module):
    """The step builders' round_grads on each parameter's gradient."""
    for p in module.parameters():
        p.grad = p.grad.to(torch.bfloat16).float()


def _port_grads(module, args, cotangent):
    """Gradients of sum(module(*args) * cotangent) wrt module's float32
    parameters, run on them rounded to bf16 (the step builders' policy)."""
    with bf16_weights(module.parameters()):
        out = module(*args)
        out = out[0] if isinstance(out, tuple) else out
        (out.float() * torch.from_numpy(cotangent)).sum().backward()
    _round_grads(module)
    return {n: p.grad for n, p in module.named_parameters()}


def test_fusion_backbone_bf16_matches_jax():
    """The SwinFusion backbone (std layout) under the bf16 policy: float32
    streams, bf16 weights in every kernel and conv, against JAX's
    SwinFusionBackbone on _cast_tree'd parameters; every parameter gradient
    and the input gradient within 1e-2 max|ref|."""
    from multimodal_neuroimage_tpu.models.swinfusion_net import (
        SwinFusionBackbone)
    jcfg, params, _, port, rng = _tiny_bf16_parts()
    S = jcfg.intermediate_vec
    a, b, ct = (rng.normal(size=(2, S, S)).astype(np.float32)
                for _ in range(3))
    jb = SwinFusionBackbone(
        embed_dim=jcfg.fusion_embed_dim,
        ex_depths=tuple(jcfg.fusion_ex_depths),
        fusion_depths=tuple(jcfg.fusion_depths),
        re_depths=tuple(jcfg.fusion_re_depths),
        ex_heads=tuple(jcfg.fusion_ex_heads),
        fusion_heads=tuple(jcfg.fusion_heads),
        re_heads=tuple(jcfg.fusion_re_heads), img_size=S,
        window_size=jcfg.window_size, drop_rate=0.0, attn_drop_rate=0.0,
        drop_path_rate=0.0)

    def f(p, a):
        o = jb.apply({"params": _cast_tree(p, jnp.bfloat16)}, a,
                     jnp.asarray(b, jnp.bfloat16), deterministic=True)
        return jnp.sum(o.astype(jnp.float32) * ct)

    jatt.set_fused_attention(True)
    try:
        jgp, jga = jax.grad(f, argnums=(0, 1))(
            params["fusion"], jnp.asarray(a, jnp.bfloat16))
    finally:
        jatt.set_fused_attention(None)
    from multimodal_neuroimage_tpu_torch.utils.jax_import import (
        swinfusion_backbone_state)
    want = swinfusion_backbone_state(jgp)
    ta = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    got = _port_grads(port.fusion,
                      (ta, torch.from_numpy(b).to(torch.bfloat16)), ct)
    assert set(want) == set(got)
    for name, g in got.items():
        _close_grad(g, want[name], rel=1e-2, msg=name)
    _close_grad(ta.grad.float(), np.asarray(jga, np.float32), rel=1e-2,
                msg="da")


def test_fmri_embedder_bf16_matches_jax():
    """The fMRI embedder (two temporal BERTs on K1's mm16 form, the CLS
    projection and the diagonal embedding) under the bf16 policy against
    JAX's FmriDiagEmbed on _cast_tree'd parameters and a bf16 batch: the
    embedding within 3e-2 + 3e-2 |ref|, every parameter gradient within
    3e-2 max|ref|; the key biases' gradients, zero in exact arithmetic, at
    the scale of their key weights'."""
    from multimodal_neuroimage_tpu.models.func_struct import FmriDiagEmbed
    jcfg, params, batch, port, rng = _tiny_bf16_parts()
    S = jcfg.intermediate_vec
    ct = rng.normal(size=(2, S, S)).astype(np.float32)
    je = FmriDiagEmbed(intermediate_vec=S,
                       transformer_hidden_layers=jcfg.transformer_hidden_layers,
                       num_heads_2DBert=jcfg.num_heads_2DBert,
                       sequence_length=jcfg.sequence_length,
                       transformer_dropout_rate=0.0,
                       bert_intermediate_size=jcfg.bert_intermediate_size)
    xl = batch["fmri_lowfreq_sequence"]
    xu = batch["fmri_ultralowfreq_sequence"]

    def f(p):
        e, _ = je.apply({"params": _cast_tree(p, jnp.bfloat16)}, None,
                        jnp.asarray(xl, jnp.bfloat16),
                        jnp.asarray(xu, jnp.bfloat16), True)
        return jnp.sum(e.astype(jnp.float32) * ct), e

    jatt.set_fused_attention(True)
    try:
        (_, want_e), jg = jax.value_and_grad(f, has_aux=True)(
            params["fmri_embed"])
    finally:
        jatt.set_fused_attention(None)
    want = jax_params_to_state_dict({"fmri_embed": jg,
                                     "fusion": params["fusion"],
                                     "swin": params["swin"]})
    emb = port.fmri_embed.eval()
    with bf16_weights(emb.parameters()):
        e, _ = emb(None, torch.from_numpy(xl).to(torch.bfloat16),
                   torch.from_numpy(xu).to(torch.bfloat16))
        assert e.dtype == torch.bfloat16
        _close(e.detach().float(), np.asarray(want_e, np.float32), rtol=3e-2,
               atol=3e-2, msg="embedding")
        (e.float() * torch.from_numpy(ct)).sum().backward()
    _round_grads(emb)
    for name, p in emb.named_parameters():
        ref = want["fmri_embed." + name]
        if name.endswith("attention.self.key.bias"):
            kw = want["fmri_embed." + name[:-len("bias")] + "weight"]
            _close(p.grad, ref, rtol=0.0,
                   atol=3e-2 * float(kw.abs().max()), msg=name)
        else:
            _close_grad(p.grad, ref, rel=3e-2, msg=name)


@pytest.mark.parametrize("flat", [False, True])
def test_bf16_weights_round_in_place_and_restore(flat):
    """bf16_weights: inside the block every float32 parameter holds its bf16
    rounding, after it the float32 masters exactly, whether the parameters
    view one buffer (rounded and restored as one tensor) or not (gathered
    and written back)."""
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(7, 5), torch.nn.LayerNorm(5),
                                torch.nn.Linear(5, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    if flat:
        flatten_parameters(model)
        storages = {p.untyped_storage().data_ptr() for p in model.parameters()}
        assert len(storages) == 1
    masters = [p.detach().clone() for p in model.parameters()]
    with bf16_weights(model.parameters()):
        for p, m in zip(model.parameters(), masters):
            assert torch.equal(p, m.to(torch.bfloat16).float())
        y = model(torch.randn(2, 7, generator=gen)).sum()
        y.backward()
    for p, m in zip(model.parameters(), masters):
        assert torch.equal(p.detach(), m) and p.grad is not None
