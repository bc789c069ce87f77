"""K7 and the bp layout of the SwinFusion stacks against the JAX package, on
the CPU.

* The bp plain versions (what K7's wrappers run on CPU tensors) against the
  JAX ``fused_fusion_block_bp`` / ``fused_cross_fusion_block_bp`` with
  ``interpret=True`` (hash masks there), on the same group-major windows
  (padded to NP = 40 on the JAX side, bias from ``packed_bias_from_table``):
  forward, ``jax.vjp`` against the port's autograd for the stream(s), every
  parameter and the bias table, at rates 0 and at (0.1, 0.1) with DropPath
  and a fixed seed, for one group (FUSION_BP_GROUP 4 at B = 4) and two
  (FUSION_BP_GROUP 2). With dropout on this is what shows the port's bp masks
  are the JAX bp kernels' bit for bit.
* ``CRSTB`` with ``_LAYOUT = "bp"`` against the JAX ``CRSTB`` on its bp
  layout with the fused kernels on, dropout off; the port's bp stacks against
  its std stacks, dropout off (values and gradients); the tiny flagship on bp
  against the JAX ``FuncStructCross``, dropout off.
* ``bpr`` and ``xbp`` raise, naming ROADMAP.

Geometry: a 12 x 12 grid, windows of 6 (nW 4), C 12, 6 heads, B 4.
Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.nn import swinfusion as jsf
from multimodal_neuroimage_tpu.nn.swin2d import (relative_position_index,
                                                 shift_attn_mask)
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu.ops import fusion_block_bp as jfbp
from multimodal_neuroimage_tpu.ops.attention import set_fused_attention
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.ops import fusion_block as tfb
from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as tfbp
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
B, RES, WS, C, HEADS = 4, 12, 6, 12, 6


@pytest.fixture(autouse=True)
def _float32_streams(monkeypatch):
    """The bp stacks at the float32 policy, as JAX runs them on the CPU: a
    bf16 step built by an earlier test in this process leaves the port's
    policy (``nn/swinfusion.py`` ``_POLICY16``, a module global) on."""
    monkeypatch.setattr(tsf, "_POLICY16", False)
N = WS * WS
NP = jfb.round_up(N, 8)
NW = (RES // WS) ** 2
SEED = 7654321
DP = np.asarray([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9], [0.0, 1 / 0.9],
                 [1 / 0.9, 1 / 0.9]], np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


def _pad(t4):
    return jnp.asarray(np.pad(t4, ((0, 0), (0, 0), (0, NP - N), (0, 0))))


def test_group_helpers_match_jax(monkeypatch):
    for cap, want in (("8", (1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 8)),
                      ("2", (1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 2))):
        monkeypatch.setenv("FUSION_BP_GROUP", cap)
        Bs = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 16)
        assert tuple(tfbp.group_size(b) for b in Bs) == want
        assert all(tfbp.group_size(b) == jfbp.group_size(b) for b in Bs)
    x = np.random.default_rng(0).normal(size=(4, NW, N, C)).astype(np.float32)
    # the JAX package's 3-D bp stream (nW, NP, B*C) cut into groups of 2
    want = jfbp._to_groups(jfbp.to_bp(jnp.asarray(x)), 2)
    got = tfbp.to_groups(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tfbp.from_groups(got, 2).numpy(), x)
    # the stacks' entry and exit (JAX _bp_enter / _bp_exit, cap 2 above)
    tokens = x.reshape(4, NW * N, C)
    entered = tfbp.to_groups(torch.from_numpy(tokens), 2)
    np.testing.assert_array_equal(entered.numpy(), np.asarray(
        jsf._bp_enter(jnp.asarray(tokens))))
    np.testing.assert_array_equal(tfbp.from_groups(entered, 2).numpy(),
                                  np.asarray(jsf._bp_exit(
                                      jsf._bp_enter(jnp.asarray(tokens)), 4)))


def _inputs(shift, cross, seed):
    rng = np.random.default_rng(seed + 10 * shift + cross)
    shapes = jfb.param_shapes(C, 4 * C, cross)
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    for i in ((0, 2, 10) if cross else (0, 6)):     # LN scales positive
        params[i] = np.abs(params[i]) + 0.5
    x, y, g = (rng.normal(size=(B, NW, N, C)).astype(np.float32)
               for _ in range(3))
    table = (rng.normal(size=((2 * WS - 1) ** 2, HEADS)) * 0.1).astype(
        np.float32)
    return params, x, y, g, table, shift_attn_mask(RES, RES, WS, shift)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("G,shift", [(4, 3), (2, 3)])
def test_bp_block_matches_jax_bp_kernel(G, shift, cross, rates, monkeypatch):
    monkeypatch.setenv("FUSION_BP_GROUP", str(G))
    assert tfbp.group_size(B) == G
    params, x, y, g, table, mask = _inputs(shift, cross, seed=G)
    x4, y4, g4 = (tfbp.to_groups(torch.from_numpy(t), G).numpy()
                  for t in (x, y, g))
    training = rates != (0.0, 0.0)
    dp = DP if training else np.ones((B, 2), np.float32)
    rel = relative_position_index(WS, WS)
    maskp = (None if mask is None
             else np.pad(mask, ((0, 0), (0, NP - N), (0, NP - N))))

    def jax_fn(x_, y_, p, table_):
        packed = jfb.packed_bias_from_table(table_, WS, HEADS, NP, rel)
        if cross:
            return jfbp.fused_cross_fusion_block_bp(
                x_, y_, p, packed, maskp, jnp.asarray(dp), SEED, rates,
                training, interpret=True)
        return jfbp.fused_fusion_block_bp(x_, p, packed, maskp,
                                          jnp.asarray(dp), SEED, rates,
                                          training, interpret=True)

    jp = tuple(jnp.asarray(t) for t in params)
    want, vjp = jax.vjp(jax_fn, _pad(x4), _pad(y4), jp, jnp.asarray(table))
    jdx, jdy, jdp, jdtable = vjp(_pad(g4))

    tx, ty = (torch.from_numpy(t).requires_grad_() for t in (x4, y4))
    tp = [_to_port(p).requires_grad_() for p in params]
    ttable = torch.from_numpy(table).requires_grad_()
    bias = tfb.bias_from_table(ttable, torch.from_numpy(rel), HEADS)
    tmask = None if mask is None else torch.from_numpy(mask)
    tdp = torch.from_numpy(dp) if training else None
    args = (tp, bias, tmask, tdp, SEED, rates, training)
    if cross:
        got = tfbp.fused_cross_fusion_block_bp(tx, ty, *args, group=G)
    else:
        got = tfbp.fused_fusion_block_bp(tx, *args, group=G)
    assert "FusionBlockBp" in type(got.grad_fn).__name__
    _close(got.detach(), np.asarray(want)[:, :, :N], "forward")
    got.backward(torch.from_numpy(g4))
    _close(tx.grad, np.asarray(jdx)[:, :, :N], "dx")
    if cross:
        _close(ty.grad, np.asarray(jdy)[:, :, :N], "dy")
    for i, (a, w) in enumerate(zip(tp, jdp)):
        _close(a.grad, _to_port(w), f"dparams[{i}]")
    _close(ttable.grad, jdtable, "dtable")


def test_bp_masks_differ_from_std_and_overlap_across_groups():
    """With dropout on, the bp block is not the std block (its masks are the
    bp kernels'); the fc1 masks of group 1 are group 0's shifted by
    C / Ch subjects (the JAX bp kernel's G*C group offset)."""
    G, Ch = 2, 4 * C
    keys = tfbp.bp_keys(G, C, HEADS, Ch)
    rows, off_c, off_h, off_a = keys(4, NW, N, NP, None)
    assert off_c.flatten().tolist() == [0, C, 2 * C, 3 * C]
    assert off_h.flatten().tolist() == [0, Ch, G * C, G * C + Ch]
    assert off_a.flatten().tolist() == [0, HEADS * NP, G * HEADS * NP,
                                        (G + 1) * HEADS * NP]
    assert rows.shape == (1, NW, N, 1) and rows[0, 1, 0, 0] == NP
    params, x, _, _, table, mask = _inputs(3, False, seed=0)
    tp = [_to_port(p) for p in params]
    bias = tfb.bias_from_table(torch.from_numpy(table), torch.from_numpy(
        relative_position_index(WS, WS)), HEADS)
    xt, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    dp = torch.from_numpy(DP)
    for rates in ((0.0, 0.0), (0.1, 0.1)):
        std = tfb.fusion_block_reference(xt, tp, bias, tmask, dp, SEED,
                                         rates, True)
        bp = tfbp.from_groups(tfbp.fusion_block_bp_reference(
            tfbp.to_groups(xt, G), tp, bias, tmask, dp, SEED, rates, True),
            G)
        assert torch.allclose(std, bp, rtol=1e-5, atol=1e-6) == (
            rates == (0.0, 0.0))


def _crstb(depth=2):
    return dict(dim=C, input_resolution=(RES, RES), depth=depth,
                num_heads=HEADS, window_size=WS)


def test_crstb_on_bp_matches_jax_bp(monkeypatch):
    monkeypatch.setenv("FUSION_BP_GROUP", "2")       # two groups at B = 4
    monkeypatch.setattr(jsf, "_LAYOUT", "bp")
    monkeypatch.setattr(tsf, "_LAYOUT", "bp")
    rng = np.random.default_rng(21)
    x, y = (rng.normal(size=(B, RES * RES, C)).astype(np.float32)
            for _ in "xy")
    jmod = jsf.CRSTB(**_crstb(), drop_path=(0.0, 0.0))
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(y))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    set_fused_attention(True)
    try:
        wx, wy = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x),
                                     jnp.asarray(y))
    finally:
        set_fused_attention(None)
    tmod = tsf.CRSTB(C, (RES, RES), 2, HEADS, WS)
    tmod.load_state_dict(jax_import.crstb_state(params))
    with torch.no_grad():
        gx, gy = tmod.eval()(torch.from_numpy(x), torch.from_numpy(y))
    _close(gx, wx)
    _close(gy, wy)


def _stack_run(layout, monkeypatch, x, y, seed=0):
    monkeypatch.setattr(tsf, "_LAYOUT", layout)
    torch.manual_seed(seed)
    mod = tsf.CRSTB(C, (RES, RES), 2, HEADS, WS,
                    drop_path=(0.1, 0.2)).train()
    for p in mod.parameters():
        p.data.add_(0.05 * torch.randn(p.shape))
    xs, ys = (t.clone().requires_grad_() for t in (x, y))
    ox, oy = mod(xs, ys, torch.Generator().manual_seed(3))
    (ox.sin().sum() + oy.cos().sum()).backward()
    return (ox.detach(), oy.detach(), xs.grad, ys.grad,
            {n: p.grad for n, p in mod.named_parameters()})


@pytest.mark.parametrize("G", ["4", "2"])
def test_bp_stacks_match_std_stacks_dropout_off(G, monkeypatch):
    """DropPath on (drawn as on the std path), dropout rates 0: the two
    layouts are one function, values and every gradient."""
    monkeypatch.setenv("FUSION_BP_GROUP", G)
    rng = np.random.default_rng(5)
    x, y = (torch.from_numpy(rng.normal(size=(B, RES * RES, C))
                             .astype(np.float32)) for _ in "xy")
    std = _stack_run("std", monkeypatch, x, y)
    bp = _stack_run("bp", monkeypatch, x, y)
    for a, b in zip(std[:4], bp[:4]):
        _close(b, a)
    for n, a in std[4].items():
        _close(bp[4][n], a, n)


@pytest.mark.parametrize("layout", ["bpr", "xbp", "nonsense"])
def test_unported_layouts_raise_naming_roadmap(layout, monkeypatch):
    monkeypatch.setattr(tsf, "_LAYOUT", layout)
    mod = tsf.BasicLayerFusion(C, (RES, RES), 1, HEADS, WS)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mod(torch.zeros(2, RES * RES, C))


def test_tiny_flagship_on_bp_matches_jax(monkeypatch):
    """The tiny flagship (B = 2, one group) in the port's bp layout against
    the JAX FuncStructCross on its bp layout with the fused kernels
    (interpret mode), dropout off: logits."""
    from __graft_entry__ import _example_batch, _flagship_cfg
    from multimodal_neuroimage_tpu.models.registry import (
        create_model as jcreate)
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
    monkeypatch.setattr(jsf, "_LAYOUT", "bp")
    monkeypatch.setattr(tsf, "_LAYOUT", "bp")
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2).validate()
    model = jcreate(jcfg)
    batch = _example_batch(2, t=32, r=jcfg.intermediate_vec)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    set_fused_attention(True)
    try:
        want = jax.jit(model.apply)({"params": params},
                                    batch)["binary_classification"]
    finally:
        set_fused_attention(None)
    port = create_model(Config(**dataclasses.asdict(jcfg)))
    port.load_state_dict(jax_import.jax_params_to_state_dict(params))
    with torch.no_grad():
        got = port.eval()(batch_to_device(batch, "cpu"))
    _close(got["binary_classification"], want)
