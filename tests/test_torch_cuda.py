"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here is marked ``cuda`` and skips without a card. On a machine
with one (which has no jax, so skip tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small and deliberately ragged (odd head dim 7, keys masked past
t_valid, partial row tiles, N = 9 windows). Both sides run float32 on the
card with TF32 off; |kernel - plain| <= 1e-4 + 2e-4 * |plain|, the same
bound chip_smoke.py holds the kernels to at the flagship's shapes. The
backward kernels run with dropout on and are held against autograd through
the plain forward; a gradient that is a sum over many rows (weights,
biases, LayerNorm scales, the relative-position bias) is bounded relative
to its tensor's max-abs instead: |kernel - plain| <= 1e-4 * max|plain| +
1e-5, since both sides add thousands of terms in different orders.
"""

import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu_torch.nn.common import full_f32
from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
from multimodal_neuroimage_tpu_torch.ops import attention as att
from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
from multimodal_neuroimage_tpu_torch.ops import fused_update as fu

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-4, 2e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with full_f32():
        yield torch.device("cuda")


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _close_sum(got, want, what=""):
    """Bound for a gradient summed over many rows (module docstring)."""
    torch.cuda.synchronize()
    bound = 1e-4 * want.abs().max().item() + 1e-5
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= bound, (what, err, bound)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _lin(gen, o, i):
    return [_rand(gen, o, i, scale=i ** -0.5), _rand(gen, o, scale=0.1)]


def _ln(gen, c):
    return [1 + _rand(gen, c, scale=0.1), _rand(gen, c, scale=0.1)]


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (2, 37, 28, 4, 64, 37), (3, 45, 28, 4, 96, 30), (1, 369, 84, 12, 3072, 369)])
def test_bert_layer_kernel(dev, B, T, H, heads, F, t_valid):
    gen = torch.Generator().manual_seed(T + H)
    p = tuple(t.to(dev) for t in sum((_lin(gen, H, H) for _ in range(4)), [])
              + _ln(gen, H) + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H))
    x = _rand(gen, B, T, H).to(dev)
    before = bl.bert_layer_call.launches
    got = bl.bert_layer_call(x, p, heads, t_valid)
    assert bl.bert_layer_call.launches == before + 1
    _close(got, bl.bert_layer_reference(x, p, heads, t_valid))


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("res,heads,shift", [(12, 6, 0), (12, 6, 3),
                                             (12, 2, 3), (84, 6, 3)])
def test_fusion_block_kernel(dev, cross, res, heads, shift):
    gen = torch.Generator().manual_seed(res + heads + shift + cross)
    C, ws = 12, 6
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = tuple(t.to(dev) for t in _ln(gen, C) + qkv + _lin(gen, C, C)
              + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    x, y = (_rand(gen, 2, nW, N, C).to(dev) for _ in "xy")
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    if cross:
        got = fb.fused_cross_fusion_block(x, y, p, bias, mask)
        want = fb.cross_fusion_block_reference(x, y, p, bias, mask)
    else:
        got = fb.fused_fusion_block(x, p, bias, mask)
        want = fb.fusion_block_reference(x, p, bias, mask)
    _close(got, want)


@pytest.mark.parametrize("N,nW,heads,D,masked", [
    (36, 4, 3, 4, True), (36, 1, 6, 4, False), (9, 1, 12, 4, False),
    (16, 4, 2, 8, True)])
def test_window_attention_kernel(dev, N, nW, heads, D, masked):
    gen = torch.Generator().manual_seed(N + nW + heads)
    shape = (2, nW, heads, N, D)
    q, k, v = (_rand(gen, *shape).to(dev) for _ in "qkv")
    bias = _rand(gen, heads, N, N).to(dev)
    mask = (torch.where(torch.rand(nW, N, N, generator=gen) > 0.8, -100.0,
                        0.0).to(dev) if masked else None)
    _close(att.fused_window_attention(q, k, v, bias, mask),
           att.attention_reference(q, k, v, bias, mask))


RATES = (0.25, 0.2)


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (2, 37, 28, 4, 64, 37), (3, 45, 28, 4, 96, 30), (1, 369, 84, 12, 3072, 369)])
def test_bert_layer_backward_kernel(dev, B, T, H, heads, F, t_valid):
    gen = torch.Generator().manual_seed(T + H + 1)
    p = [t.to(dev).requires_grad_() for t in
         sum((_lin(gen, H, H) for _ in range(4)), []) + _ln(gen, H)
         + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H)]
    x = _rand(gen, B, T, H).to(dev).requires_grad_()
    g = _rand(gen, B, T, H).to(dev)
    before = bl.bert_layer_backward.launches
    out = bl.bert_layer_call(x, p, heads, t_valid, 99, RATES, True)
    _close(out.detach(), bl.bert_layer_reference(x.detach(), p, heads,
                                                  t_valid, 99, RATES, True))
    out.backward(g)
    assert bl.bert_layer_backward.launches == before + 1
    dx, dps = bl.bert_layer_reference_backward(g, x.detach(), p, heads,
                                               t_valid, 99, RATES, True)
    _close(x.grad, dx)
    for i, (a, b) in enumerate(zip(p, dps)):
        _close_sum(a.grad, b, f"dparams[{i}]")


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("res,heads,shift", [(12, 6, 0), (12, 2, 3),
                                             (84, 6, 3)])
def test_fusion_block_backward_kernel(dev, cross, res, heads, shift):
    gen = torch.Generator().manual_seed(res + heads + shift + cross + 7)
    C, ws, B = 12, 6, 2
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = [t.to(dev).requires_grad_() for t in _ln(gen, C) + qkv
         + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
         + _lin(gen, C, 4 * C)]
    x, y, g = (_rand(gen, B, nW, N, C).to(dev) for _ in "xyg")
    x.requires_grad_()
    y.requires_grad_()
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev).requires_grad_()
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    dp = torch.tensor([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], device=dev)
    args = (bias, mask, dp, 5, RATES, True)
    if cross:
        out = fb.fused_cross_fusion_block(x, y, p, *args)
        want = fb.cross_fusion_block_reference(x.detach(), y.detach(), p,
                                               *args)
    else:
        out = fb.fused_fusion_block(x, p, *args)
        want = fb.fusion_block_reference(x.detach(), p, *args)
    _close(out.detach(), want)
    out.backward(g)
    dx, dy, dbias, dps = fb.fusion_block_reference_backward(
        g, x.detach(), y.detach(), p, bias, mask, dp, 5, RATES, True, cross)
    _close(x.grad, dx)
    if cross:
        _close(y.grad, dy)
    _close_sum(bias.grad, dbias, "dbias")
    for i, (a, b) in enumerate(zip(p, dps)):
        _close_sum(a.grad, b, f"dparams[{i}]")


@pytest.mark.parametrize("N,nW,heads,D,masked", [
    (36, 4, 3, 4, True), (9, 1, 12, 4, False), (16, 4, 2, 8, True)])
def test_window_attention_backward_kernel(dev, N, nW, heads, D, masked):
    gen = torch.Generator().manual_seed(N + nW + heads + 3)
    shape = (2, nW, heads, N, D)
    q, k, v = (_rand(gen, *shape).to(dev).requires_grad_() for _ in "qkv")
    g = _rand(gen, *shape).to(dev)
    bias = _rand(gen, heads, N, N).to(dev).requires_grad_()
    mask = (torch.where(torch.rand(nW, N, N, generator=gen) > 0.8, -100.0,
                        0.0).to(dev) if masked else None)
    att.fused_window_attention(q, k, v, bias, mask).backward(g)
    want = att.attention_reference_backward(g, q, k, v, bias, mask)
    for name, a, b in zip("q k v".split(), (q, k, v), want[:3]):
        _close(a.grad, b)
    _close_sum(bias.grad, want[3], "dbias")


@pytest.mark.parametrize("N,nW,heads,D,masked", [
    (36, 4, 3, 4, True), (9, 1, 12, 4, False), (16, 4, 2, 8, True)])
def test_window_attention_dropout_kernel(dev, N, nW, heads, D, masked):
    """K4 at rate 0.1, forward and backward, against the plain version on
    the same hash masks."""
    gen = torch.Generator().manual_seed(N + nW + heads + 5)
    shape = (2, nW, heads, N, D)
    q, k, v = (_rand(gen, *shape).to(dev).requires_grad_() for _ in "qkv")
    g = _rand(gen, *shape).to(dev)
    bias = _rand(gen, heads, N, N).to(dev).requires_grad_()
    mask = (torch.where(torch.rand(nW, N, N, generator=gen) > 0.8, -100.0,
                        0.0).to(dev) if masked else None)
    out = att.fused_window_attention(q, k, v, bias, mask, 77, 0.1)
    _close(out.detach(), att.attention_reference(q.detach(), k.detach(),
                                                 v.detach(), bias.detach(),
                                                 mask, 77, 0.1))
    out.backward(g)
    want = att.attention_reference_backward(g, q, k, v, bias, mask, 77, 0.1)
    for a, b in zip((q, k, v), want[:3]):
        _close(a.grad, b)
    _close_sum(bias.grad, want[3], "dbias")


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("B,G,res,heads,shift", [(4, 2, 12, 6, 3),
                                                 (4, 4, 12, 2, 0),
                                                 (16, 8, 84, 6, 3)])
def test_fusion_block_bp_kernel(dev, cross, B, G, res, heads, shift):
    """K7 forward and backward (dropout and DropPath on) on group-major
    windows against the bp plain versions on the same masks."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(B + G + res + heads + shift + cross)
    C, ws = 12, 6
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = [t.to(dev).requires_grad_() for t in _ln(gen, C) + qkv
         + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
         + _lin(gen, C, 4 * C)]
    x, y, g = (_rand(gen, B // G, nW, N, G * C).to(dev) for _ in "xyg")
    x.requires_grad_()
    y.requires_grad_()
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev).requires_grad_()
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    dp = (torch.rand(B, 2, generator=gen) > 0.2).float().to(dev) / 0.8
    args = (bias, mask, dp, 9, RATES, True)
    before = (fbp.fused_cross_fusion_block_bp if cross
              else fbp.fused_fusion_block_bp).launches
    if cross:
        out = fbp.fused_cross_fusion_block_bp(x, y, p, *args)
        want = fbp.cross_fusion_block_bp_reference(x.detach(), y.detach(), p,
                                                   *args)
    else:
        out = fbp.fused_fusion_block_bp(x, p, *args)
        want = fbp.fusion_block_bp_reference(x.detach(), p, *args)
    assert (fbp.fused_cross_fusion_block_bp if cross
            else fbp.fused_fusion_block_bp).launches == before + 1
    _close(out.detach(), want)
    out.backward(g)
    dx, dy, dbias, dps = fbp.fusion_block_bp_reference_backward(
        g, x.detach(), y.detach(), p, bias, mask, dp, 9, RATES, True, cross)
    _close(x.grad, dx)
    if cross:
        _close(y.grad, dy)
    _close_sum(bias.grad, dbias, "dbias")
    for i, (a, b) in enumerate(zip(p, dps)):
        _close_sum(a.grad, b, f"dparams[{i}]")


@pytest.mark.parametrize("bf16", [False, True])
def test_dot_shapes_kernel(dev, bf16):
    """K8: a broadcast batched product against its plain version, then one
    chain of each variant (one cell) against the einsum chain."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    gen = torch.Generator().manual_seed(3)
    a = _rand(gen, 3, 70, 33).to(dev)
    b = _rand(gen, 2, 3, 33, 65).to(dev)
    before = ds.batched_matmul.launches
    got = ds.batched_matmul(a.unsqueeze(0).expand(2, 3, 70, 33), b, 0.5,
                            bf16)
    assert ds.batched_matmul.launches == before + 1
    want = ds.batched_matmul(a.cpu().unsqueeze(0).expand(2, 3, 70, 33),
                             b.cpu(), 0.5, bf16)
    _close(got.cpu(), want)
    for v in ds.VARIANTS:
        ops = ds.inputs(v, device=dev)
        out = ds.dot_chain(v, *ops, 2, bf16, cells=1)
        ref = ds.dot_chain_reference(v, *ops, 2, bf16, cells=1)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        assert err <= (5e-3 if bf16 else 1e-5) * ref.abs().max().item(), v


def _dot_close(got, want):
    """K8 against its plain version on one product: both sides multiply the
    same (bf16-rounded) operands exactly and add in f32 in other orders."""
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= 1e-5 * want.abs().max(), err


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("tile", range(6))
def test_dot_shapes_every_config(dev, monkeypatch, tile, splits, bf16):
    """Every block tile and split-K factor the wrapper can pick, on a
    product that spans several ragged tiles in M and N."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    gen = torch.Generator().manual_seed(tile + 10 * splits)
    a, b = _rand(gen, 2, 3, 150, 200), _rand(gen, 2, 3, 200, 170)
    want = ds.batched_matmul(a, b, 0.7, bf16)
    monkeypatch.setattr(ds, "_CONFIG", (tile, splits))
    _dot_close(ds.batched_matmul(a.to(dev), b.to(dev), 0.7, bf16), want)


@pytest.mark.parametrize("M,N,K", [(150, 170, 200), (37, 53, 29)])
@pytest.mark.parametrize("form", ["bf16 a", "bf16 out"])
@pytest.mark.parametrize("tile", range(6))
def test_dot_shapes_bf16_forms(dev, monkeypatch, tile, form, M, N, K):
    """The chain's two bf16 forms on every tile: a bfloat16 left operand
    (taken as rounded) and a bfloat16(out_scale * C) output; K 29 loads a
    bf16 row element by element. A bf16 output may differ by one rounding
    step (at most 2^-7 of the value) where the two f32 summation orders
    straddle it, and by their difference itself (1e-5 of the largest
    output bounds it) where the value is near zero."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    gen = torch.Generator().manual_seed(tile + M)
    a, b = _rand(gen, 2, M, K), _rand(gen, 2, K, N)
    monkeypatch.setattr(ds, "_CONFIG", (tile, 1))
    before = ds.batched_matmul.launches
    if form == "bf16 a":
        a = (0.7 * a).bfloat16()
        got = ds._launch(a.to(dev), b.to(dev), 1.0, ds.BF16_A)
        _dot_close(got, ds.batched_matmul(a.float(), b, 1.0, True))
    else:
        got = ds._launch(a.to(dev), b.to(dev), 1.0, ds.BF16_OUT, 1e-3)
        want = (ds.batched_matmul(a, b, 1.0, True) * 1e-3).bfloat16().float()
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        err = (got.float().cpu() - want).abs()
        ulp = 2 ** -7 * torch.maximum(got.float().cpu().abs(), want.abs())
        assert (err <= ulp + 1e-5 * want.abs().max()).all(), err.max()
    assert ds.batched_matmul.launches == before + 1


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("M,N,K", [(37, 53, 29), (37, 52, 44), (5, 7, 300),
                                   (130, 97, 16)])
def test_dot_shapes_ragged(dev, monkeypatch, M, N, K, bf16):
    """Ragged M, N and K (K not a multiple of 16 or of 4: element-wise
    loads), through the chooser and through the smallest and the largest
    tile with as many splits as K allows."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    gen = torch.Generator().manual_seed(M + N + K)
    a, b = _rand(gen, 3, M, K), _rand(gen, 3, K, N)
    want = ds.batched_matmul(a, b, 1.3, bf16)
    splits = len(ds.k_slices(K, -(-K // ds.K_CHUNK)))
    for config in (None, (0, splits), (5, 1)):
        monkeypatch.setattr(ds, "_CONFIG", config)
        _dot_close(ds.batched_matmul(a.to(dev), b.to(dev), 1.3, bf16), want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("which", ["a", "b", "both", "inner"])
def test_dot_shapes_broadcast(dev, which, bf16):
    """Stride-0 batch levels on either operand (outer or inner level)."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    gen = torch.Generator().manual_seed(len(which))
    a, b = _rand(gen, 3, 40, 96), _rand(gen, 3, 96, 64)
    if which == "inner":
        a = _rand(gen, 4, 1, 40, 96).expand(4, 3, 40, 96)
        b = b.unsqueeze(0).expand(4, 3, 96, 64)
    else:
        a = a.unsqueeze(0).expand(4, 3, 40, 96) if which != "b" else \
            _rand(gen, 4, 3, 40, 96)
        b = b.unsqueeze(0).expand(4, 3, 96, 64) if which != "a" else \
            _rand(gen, 4, 3, 96, 64)
    got = ds.batched_matmul(a.to(dev), b.to(dev), 0.5, bf16)
    _dot_close(got, ds.batched_matmul(a, b, 0.5, bf16))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("variant", ["cur", "sm", "st", "ffold", "flat"])
def test_dot_shapes_variant_chain(dev, variant, bf16):
    """Each formulation's chain at reps 1 over its 7 cells (the chooser's
    tiles and splits at the real shapes) against the einsum chain."""
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    ops = ds.inputs(variant, device=dev)
    before = ds.batched_matmul.launches
    out = ds.dot_chain(variant, *ops, 1, bf16)
    assert ds.batched_matmul.launches == before + 2
    ref = ds.dot_chain_reference(variant, *ops, 1, bf16)
    torch.cuda.synchronize()
    assert out.shape == (ds.NCH,) + ds.shapes(variant)[0]
    err = (out - ref).abs().max().item()
    assert err <= (5e-3 if bf16 else 1e-5) * ref.abs().max().item(), err


# (N, nW, heads, D): the SwinV2 head's three stages, then N = 49 windows
K4_CASES = [(36, 4, 3, 4), (36, 1, 6, 4), (9, 1, 12, 4), (49, 4, 3, 8),
            (49, 4, 3, 16), (49, 4, 3, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("N,nW,heads,D", K4_CASES)
def test_window_attention_head_groups(dev, N, nW, heads, D, masked, rate):
    """K4 forward (a block per window and group of heads, online softmax)
    against attention_reference, then K4 backward from its output."""
    gen = torch.Generator().manual_seed(N + nW + heads + D + masked)
    shape = (3, nW, heads, N, D)
    q, k, v = (_rand(gen, *shape).to(dev).requires_grad_() for _ in "qkv")
    g = _rand(gen, *shape).to(dev)
    bias = _rand(gen, heads, N, N).to(dev).requires_grad_()
    mask = (torch.where(torch.rand(nW, N, N, generator=gen) > 0.8, -100.0,
                        0.0).to(dev) if masked else None)
    before = att.fused_window_attention.launches
    out = att.fused_window_attention(q, k, v, bias, mask, 31, rate)
    assert att.fused_window_attention.launches == before + 1
    _close(out.detach(), att.attention_reference(q.detach(), k.detach(),
                                                 v.detach(), bias.detach(),
                                                 mask, 31, rate))
    out.backward(g)
    want = att.attention_reference_backward(g, q, k, v, bias, mask, 31, rate)
    for a, b in zip((q, k, v), want[:3]):
        _close(a.grad, b)
    _close_sum(bias.grad, want[3], "dbias")


def test_window_attention_wide_windows(dev):
    """Shapes past the 48 KB staging: bias read from device memory (N 96),
    one head a block with K and V over 48 KB (D 5 pads to 8, N 1200)."""
    gen = torch.Generator().manual_seed(8)
    for N, D in ((96, 16), (1200, 5)):
        shape = (1, 1, 2, N, D)
        q, k, v = (_rand(gen, *shape, scale=0.3).to(dev) for _ in "qkv")
        bias = _rand(gen, 2, N, N).to(dev)
        with torch.no_grad():
            _close(att.fused_window_attention(q, k, v, bias, None, 3, 0.1),
                   att.attention_reference(q, k, v, bias, None, 3, 0.1))


def test_k4_and_k8_launch_or_raise(dev, monkeypatch):
    """On CUDA tensors K4 and K8 launch or raise: a failing launch reaches
    the caller and the plain version never runs instead."""
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds

    class Failing:
        def call(self, name, *args):
            raise RuntimeError(f"{name} failed: cudaError 1 (invalid "
                               f"argument)")

    monkeypatch.setattr(build, "library", lambda: Failing())
    q = torch.zeros(1, 1, 2, 9, 4, device=dev)
    bias = torch.zeros(2, 9, 9, device=dev)
    with pytest.raises(RuntimeError, match="window_attention_forward failed"):
        att.fused_window_attention(q, q, q, bias)
    with pytest.raises(RuntimeError, match="batched_matmul failed"):
        ds.batched_matmul(torch.zeros(2, 8, 8, device=dev),
                          torch.zeros(2, 8, 8, device=dev))


@pytest.mark.parametrize("adamw,clip", [(True, False), (False, True)])
def test_fused_adam_kernel(dev, adamw, clip):
    gen = torch.Generator().manual_seed(11)
    n = 100_003
    p, g, mu = (_rand(gen, n).to(dev) for _ in range(3))
    nu = _rand(gen, n).abs().to(dev)
    c = torch.tensor([0.37], device=dev) if clip else None
    want = [t.clone() for t in (p, mu, nu)]
    args = (0.01, 1.9, 1.7, 0.9, 0.999, 1e-8, 0.05, adamw)
    fu.fused_adam_update(p, g, mu, nu, c, *args)
    fu.fused_adam_reference(*want[:1], g, *want[1:], c, *args)
    for a, b in zip((p, mu, nu), want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_wrappers_check_dtype_and_layout(dev):
    q = torch.zeros(1, 1, 1, 9, 4, device=dev)
    bias = torch.zeros(1, 9, 9, device=dev)
    with pytest.raises(TypeError, match="float32"):
        att.fused_window_attention(q.double(), q, q, bias)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 1, 1, 4, 9, device=dev).transpose(-1, -2)
        att.fused_window_attention(t, q, q, bias)
    with pytest.raises(ValueError, match="shape"):
        att.fused_window_attention(q, q, q, torch.zeros(2, 9, 9, device=dev))


def _tiny_cfg():
    """A small FuncStructCross (2 BERT layers, 4 fusion blocks a direction)
    at the Config's dropout rates."""
    from multimodal_neuroimage_tpu_torch.config import Config
    return Config(task="FuncStruct", dataset_name="multimodal",
                  transformer_hidden_layers=2, bert_intermediate_size=128,
                  num_heads_2DBert=4, intermediate_vec=48,
                  fusion_ex_depths=(2,), fusion_depths=(1,),
                  fusion_re_depths=(1,), fusion_ex_heads=(2,),
                  fusion_heads=(2,), fusion_re_heads=(2,),
                  size_of_model="small", batch_size=2,
                  compute_dtype="float32", preprocess="host").validate()


def _tiny_model(cfg, device):
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    return init_random_weights(create_model(cfg),
                               torch.Generator().manual_seed(0)).to(device)


def _tiny_batch(cfg):
    """A labelled host batch of two subjects, band-split on the host."""
    from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                             multimodal_item)
    rng = np.random.default_rng(1)
    items = []
    for i in range(cfg.batch_size):
        item = multimodal_item({"subject": f"s{i}",
                                "fmri": rng.normal(size=(48, 360)),
                                "struct": rng.normal(size=(48, 48))}, cfg)
        item["target"] = np.float32(i % 2)
        items.append(item)
    return collate(items)[0]


# card vs CPU gradients of the tiny model, per tensor relative to its
# max-abs: float32 summation-order drift carried back through its depth
GRAD_REL = 1e-3
# the kernels of the flagship on the std fusion layout (K1-K4)
STD_PATH = ("K1", "K2", "K3", "K4")


def test_every_parameter_gets_a_kernel_gradient_on_the_card(dev):
    """The autograd repair on the card: a training forward (dropout on)
    runs the forward kernels, backward runs the backward kernels, every
    parameter receives a gradient, and each gradient matches plain autograd
    on the CPU from the same weights, batch and generator state."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                              compute_losses)
    from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
    cfg = _tiny_cfg()
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch = _tiny_batch(cfg)
    models, losses = {}, {}
    for device in (dev, torch.device("cpu")):
        model = _tiny_model(cfg, device).train()
        inputs = batch_to_device(batch, device)
        ops.reset_launches()
        out = model(inputs, generator=torch.Generator().manual_seed(2))
        losses[device.type] = compute_losses(out, inputs, specs)["total"]
        losses[device.type].backward()
        torch.cuda.synchronize()
        models[device.type] = model
        if device.type == "cuda":
            counts = ops.launches()
    assert all(n > 0 for k, n in counts.items()
               if k.startswith(STD_PATH)), counts
    # T = 33: the K1 route; the std layout: no K7
    assert not any(n for k, n in counts.items()
                   if k.startswith(("K6", "K7", "K8"))), counts
    np.testing.assert_allclose(losses["cuda"].item(), losses["cpu"].item(),
                               rtol=1e-4, atol=1e-5)
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        assert p.grad is not None, name
        err = (p.grad.cpu() - want[name].grad).abs().max().item()
        bound = GRAD_REL * want[name].grad.abs().max().item() + 1e-7
        assert torch.isfinite(p.grad).all() and err <= bound, (name, err,
                                                               bound)


def test_bp_layout_with_attention_dropout_on_the_card_matches_the_cpu(
        dev, monkeypatch):
    """The tiny model on the bp fusion layout (two groups of one subject)
    with the SwinV2 head's attention dropout at 0.1: a training forward and
    backward runs K7 (never K2/K3) and K4 with dropout, and the loss and
    every gradient match plain autograd on the CPU."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
    from multimodal_neuroimage_tpu_torch.nn.swin2d import WindowAttentionV2
    from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                              compute_losses)
    from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
    monkeypatch.setattr(tsf, "_LAYOUT", "bp")
    monkeypatch.setenv("FUSION_BP_GROUP", "1")
    cfg = _tiny_cfg()
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch = _tiny_batch(cfg)
    models, losses = {}, {}
    for device in (dev, torch.device("cpu")):
        model = _tiny_model(cfg, device).train()
        for m in model.modules():
            if isinstance(m, WindowAttentionV2):
                m.attn_drop = 0.1
        inputs = batch_to_device(batch, device)
        ops.reset_launches()
        out = model(inputs, generator=torch.Generator().manual_seed(2))
        losses[device.type] = compute_losses(out, inputs, specs)["total"]
        losses[device.type].backward()
        torch.cuda.synchronize()
        models[device.type] = model
        if device.type == "cuda":
            counts = ops.launches()
    on = [k for k in counts if k.startswith(("K1", "K4", "K7"))]
    assert len(on) == 8 and all(counts[k] > 0 for k in on), counts
    assert not any(n for k, n in counts.items() if k not in on), counts
    np.testing.assert_allclose(losses["cuda"].item(), losses["cpu"].item(),
                               rtol=1e-4, atol=1e-5)
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        err = (p.grad.cpu() - want[name].grad).abs().max().item()
        bound = GRAD_REL * want[name].grad.abs().max().item() + 1e-7
        assert torch.isfinite(p.grad).all() and err <= bound, (name, err,
                                                               bound)


def test_tiny_training_step_on_the_card_matches_the_cpu(dev):
    """One K5 training step (AdamW, dropout on) on the card against the
    same step on the CPU through the plain versions. Adam's first step
    moves each parameter by about lr * sign(grad), so the updated
    parameters agree to 1e-5 wherever the gradient's sign is the same on
    both sides (|g_cpu| > 10 |g_card - g_cpu| + 1e-7), and by at most 2 lr
    where a gradient is so small that the two summation orders disagree on
    its sign."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    cfg = _tiny_cfg()
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch = _tiny_batch(cfg)
    lr = 1e-3
    models, losses = {}, {}
    for device in (dev.type, "cpu"):
        model = _tiny_model(cfg, device)
        opt = create_optimizer("AdamW", model.parameters(), lambda t: lr,
                               cfg.weight_decay)
        step = make_train_step(model, specs, opt, "float32", device)
        ops.reset_launches()
        losses[device] = step(batch, torch.Generator().manual_seed(3))[0]
        if device == "cuda":
            assert ops.launches()["K5 fused_adam"] == 1
        models[device] = model
    torch.cuda.synchronize()
    np.testing.assert_allclose(losses["cuda"]["total"].item(),
                               losses["cpu"]["total"].item(), rtol=1e-4,
                               atol=1e-5)
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        q = want[name]
        diff = (p.detach().cpu() - q.detach()).abs()
        stable = q.grad.abs() > 10 * (p.grad.cpu() - q.grad).abs() + 1e-7
        assert torch.isfinite(p).all(), name
        if stable.any():
            assert diff[stable].max() <= 1e-5, name
        assert diff.max() <= 2 * lr + 1e-5, name


def test_predictor_on_the_card_matches_the_cpu(dev, tmp_path):
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    cfg = _tiny_cfg()
    model = _tiny_model(cfg, "cpu")
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), model.state_dict(),
                           {"val_threshold": 0.5})
    rng = np.random.default_rng(0)
    reqs = [{"subject": f"s{i}", "fmri": rng.normal(size=(48, 360)),
             "struct": rng.normal(size=(48, 48))} for i in range(3)]
    ops.reset_launches()
    got = Predictor(cfg, ckpt, reqs, device="cuda").predict()
    forward = {k: n for k, n in ops.launches().items()
               if "backward" not in k and k.startswith(STD_PATH)}
    assert len(forward) == 4 and all(n > 0 for n in forward.values()), \
        ops.launches()
    assert sum(ops.launches().values()) == sum(forward.values()), \
        ops.launches()
    want = Predictor(cfg, ckpt, reqs, device="cpu").predict()
    for s in want:
        np.testing.assert_allclose(got[s]["score"], want[s]["score"],
                                   rtol=1e-4, atol=1e-5)


# ---- K6 and the HCP path ------------------------------------------------------

@pytest.mark.parametrize("B,H,T,D,rate", [
    (2, 2, 97, 11, 0.0), (2, 2, 97, 11, 0.25), (1, 3, 5, 7, 0.25),
    (1, 1, 1, 11, 0.0), (2, 2, 130, 24, 0.25), (1, 2, 64, 42, 0.0),
    (1, 1, 65, 64, 0.1), (8, 2, 1201, 11, 0.1)])
def test_mha_attention_kernel(dev, B, H, T, D, rate):
    """Forward and backward against the plain version on the same hash
    masks; ragged T (tail tiles), odd and both template-bound head dims."""
    gen = torch.Generator().manual_seed(B + H + T + D)
    q, k, v = (_rand(gen, B, H, T, D).to(dev).requires_grad_()
               for _ in "qkv")
    g = _rand(gen, B, H, T, D).to(dev)
    before = (att.fused_attention.launches,
              att.fused_attention_backward.launches)
    out = att.fused_attention(q, k, v, 77, rate)
    _close(out.detach(), att.mha_reference(q.detach(), k.detach(),
                                           v.detach(), 77, rate))
    out.backward(g)
    assert (att.fused_attention.launches,
            att.fused_attention_backward.launches) == (before[0] + 1,
                                                      before[1] + 1)
    want = att.mha_reference_backward(g, q, k, v, 77, rate)
    for a, b in zip((q, k, v), want):
        _close(a.grad, b)


def test_mha_attention_failing_launch_propagates(dev, monkeypatch):
    """On a CUDA tensor K6 launches or raises: a launch that fails reaches
    the caller, and the plain version is never run instead."""
    from multimodal_neuroimage_tpu_torch.ops import build

    class Failing:
        def call(self, name, *args):
            raise RuntimeError(f"{name} failed: cudaError 1 (invalid "
                               f"argument)")

    def plain(*args, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(build, "library", lambda: Failing())
    monkeypatch.setattr(att, "mha_reference", plain)
    q = torch.zeros(1, 2, 9, 11, device=dev)
    before = att.fused_attention.launches
    with pytest.raises(RuntimeError, match="mha_forward failed"):
        att.fused_attention(q, q, q)
    assert att.fused_attention.launches == before
    monkeypatch.undo()
    z = torch.zeros(1, 1, 9, 65, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        att.fused_attention(z, z, z)


def test_hcp_training_step_on_the_card_matches_the_cpu(dev):
    """A 2-layer HCP TransformerNet at T = 1201 (the K6 route), one K5 step
    with dropout on, card against CPU from the same weights, batch and
    generator state (updated parameters as in the flagship step test)."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data.loader import collate, hcp_item
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    cfg = Config(step=1, task="2DBERT", dataset_name="hcp",
                 transformer_hidden_layers=2, bert_intermediate_size=64,
                 batch_size=2, compute_dtype="float32").validate()
    rng = np.random.default_rng(2)
    batch, _ = collate([hcp_item({"subject": str(i), "fmri": rng.normal(
        size=(22, 1150 + i))}, cfg) for i in range(2)])
    batch["target"] = np.asarray([0.0, 1.0], np.float32)
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    lr = 1e-3
    models, losses = {}, {}
    for device in (dev.type, "cpu"):
        model = init_random_weights(create_model(cfg),
                                    torch.Generator().manual_seed(0))
        model.to(device)
        opt = create_optimizer("AdamW", model.parameters(), lambda t: lr,
                               cfg.weight_decay)
        step = make_train_step(model, specs, opt, "float32", device)
        ops.reset_launches()
        losses[device] = step(batch, torch.Generator().manual_seed(3))[0]
        if device == "cuda":
            counts = ops.launches()
            assert counts["K6 fused_attention"] == 2, counts
            assert counts["K6 fused_attention backward"] == 2, counts
            assert counts["K5 fused_adam"] == 1, counts
            assert counts["K1 bert_layer"] == 0, counts
        models[device] = model
    torch.cuda.synchronize()
    np.testing.assert_allclose(losses["cuda"]["total"].item(),
                               losses["cpu"]["total"].item(), rtol=1e-4,
                               atol=1e-5)
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        q = want[name]
        diff = (p.detach().cpu() - q.detach()).abs()
        stable = q.grad.abs() > 10 * (p.grad.cpu() - q.grad).abs() + 1e-7
        assert torch.isfinite(p).all(), name
        if stable.any():
            assert diff[stable].max() <= 1e-5, name
        assert diff.max() <= 2 * lr + 1e-5, name
