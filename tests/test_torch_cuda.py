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


def _close_sum(got, want, what="", rows=1476):
    """Bound for a gradient summed over many rows (module docstring). The
    1e-5 floor is for a gradient that is zero in exact arithmetic (the key
    bias: softmax ignores a shift shared by every key), whose computed
    value is rounding noise of a sum over ``rows`` rows: past the
    flagship's batch 4 (4 x 369 rows) the floor grows with them."""
    torch.cuda.synchronize()
    bound = 1e-4 * want.abs().max().item() + 1e-5 * max(1.0, rows / 1476)
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= bound, (what, err, bound)


def _rand(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _lin(gen, o, i):
    return [_rand(gen, o, i, scale=i ** -0.5), _rand(gen, o, scale=0.1)]


def _ln(gen, c):
    return [1 + _rand(gen, c, scale=0.1), _rand(gen, c, scale=0.1)]


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (2, 37, 28, 4, 64, 37), (3, 45, 28, 4, 96, 30), (1, 369, 84, 12, 3072, 369),
    (2, 45, 84, 4, 96, 40), (2, 70, 84, 3, 64, 66), (1, 45, 84, 1, 96, 45),
    (2, 37, 48, 2, 64, 37)])
def test_bert_layer_kernel(dev, B, T, H, heads, F, t_valid):
    """The float32 inference forward, at the flagship's width and at head
    dims 21, 28, 84 and 24 (above 16: the wide attention kernel, hd in
    chunks of 32, keys in tiles of 32)."""
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


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("B,res,heads,shift", [
    (1, 12, 6, 0), (3, 84, 6, 3), (5, 84, 6, 0), (16, 84, 6, 3),
    (64, 84, 6, 3), (3, 12, 2, 3), (5, 84, 2, 0)])
def test_fusion_forward_at_every_batch(dev, cross, B, res, heads, shift):
    """K2/K3's multi-window forward against the plain version where the
    subjects of a window position fill its work items and where they do not
    (B 1, 3, 5), at head dim 2 and 6: the training forward (dropout 0.1 on
    all four draws, DropPath) and its saved x2r (the plain block with fc2
    zeroed is x2r), the inference forward, and two training calls bitwise
    equal."""
    gen = torch.Generator().manual_seed(B + res + heads + shift + cross)
    C, ws = 12, 6
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = tuple(t.to(dev) for t in _ln(gen, C) + qkv + _lin(gen, C, C)
              + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    x, y = (_rand(gen, B, nW, N, C).to(dev) for _ in "xy")
    y = y if cross else None
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    dp = ((torch.rand(B, 2, generator=gen) > 0.2).float() / 0.8).to(dev)
    train = (dp, 29, (0.1, 0.1), True)
    counter = fb.fused_cross_fusion_block if cross else fb.fused_fusion_block
    before = counter.launches
    out, x2r = fb._launch_forward(x, y, p, bias, mask, *train, True, cross)
    assert counter.launches == before + 1
    _close(out, fb._block_reference(x, y, p, bias, mask, *train, cross))
    no_fc2 = p[:-2] + (torch.zeros_like(p[-2]), torch.zeros_like(p[-1]))
    _close(x2r, fb._block_reference(x, y, no_fc2, bias, mask, *train, cross))
    again, x2r_again = fb._launch_forward(x, y, p, bias, mask, *train, True,
                                          cross)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(x2r, x2r_again)
    infer, none = fb._launch_forward(x, y, p, bias, mask, None, 0, (0.0, 0.0),
                                     False, False, cross)
    assert none is None
    _close(infer, fb._block_reference(x, y, p, bias, mask, None, 0,
                                      (0.0, 0.0), False, cross))


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
    (2, 37, 28, 4, 64, 37), (3, 45, 28, 4, 96, 30),
    (1, 369, 84, 12, 3072, 369), (16, 369, 84, 12, 3072, 369),
    (3, 45, 84, 12, 3072, 30), (3, 45, 84, 4, 96, 30), (2, 70, 84, 3, 64, 66),
    (2, 37, 84, 1, 64, 37), (2, 37, 48, 2, 96, 33)])
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
        _close_sum(a.grad, b, f"dparams[{i}]", B * T)


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


def _k1_inputs(dev, seed, B, T=369, H=84, F=3072):
    gen = torch.Generator().manual_seed(seed)
    p = [t.to(dev) for t in sum((_lin(gen, H, H) for _ in range(4)), [])
         + _ln(gen, H) + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H)]
    x, g = (_rand(gen, B, T, H).to(dev) for _ in "xg")
    _, resid = bl._launch_forward(x, p, 12, T, 99, RATES, True, True)
    return x, g, p, resid


def test_bert_layer_backward_is_bitwise_repeatable(dev):
    """K1 backward twice on the same inputs: dx and every parameter
    gradient bitwise equal (split-K partials go through the ordered
    reduce, no float atomics)."""
    x, g, p, resid = _k1_inputs(dev, 21, 4)
    first, second = (bl.bert_layer_backward(g, x, p, resid, 12, 369, 99,
                                            RATES, True) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


def test_bert_layer_backward_float64_error_within_4x_simt(dev, monkeypatch):
    """K1 backward's products on 3xTF32 tensor cores against a float64
    backward of the same inputs: the worst error of dx and of every
    parameter gradient, each relative to its tensor's max-abs, is at most
    4x that of the float32 SIMT GEMM (the port's earlier route, kept as the
    yardstick) on the same inputs. The key bias's gradient is left out: it
    is zero in exact arithmetic, so its float64 value is rounding noise."""
    x, g, p, resid = _k1_inputs(dev, 22, 4)
    want = bl.bert_layer_reference_backward(
        g.double(), x.double(), [t.double() for t in p], 12, 369, 99, RATES,
        True)
    want = [want[0], *want[1]]
    scale = max(t.abs().max().item() for t in want)
    kept = [i for i, t in enumerate(want) if t.abs().max() > 1e-9 * scale]
    assert len(kept) == 16   # all but the key bias

    def worst(simt):
        monkeypatch.setattr(bl, "_GEMM_SIMT", simt)
        dx, dps = bl.bert_layer_backward(g, x, p, resid, 12, 369, 99, RATES,
                                         True)
        got = [dx, *dps]
        return max(((got[i].double() - want[i]).abs().max()
                    / want[i].abs().max()).item() for i in kept)
    tc, simt = worst(False), worst(True)
    assert tc <= 4 * simt, (tc, simt)


def _k1_forward_case(dev, seed, B, T=369, H=84, heads=12, F=3072):
    gen = torch.Generator().manual_seed(seed)
    p = [t.to(dev) for t in sum((_lin(gen, H, H) for _ in range(4)), [])
         + _ln(gen, H) + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H)]
    return p, _rand(gen, B, T, H).to(dev)


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (4, 369, 84, 12, 3072, 369), (16, 369, 84, 12, 3072, 369),
    (64, 369, 84, 12, 3072, 369), (3, 45, 28, 4, 96, 30),
    (2, 37, 96, 12, 64, 33)])
def test_bert_layer_forward_tensor_cores(dev, B, T, H, heads, F, t_valid):
    """K1's float32 forward (3xTF32 tensor cores) at the flagship's widths
    at batch 4, 16 and 64 and at ragged shapes (H 96: the 12-step padded
    width): the training forward (dropout 0.1) and every saved residual,
    then the inference forward, against the plain versions; two training
    calls bitwise equal."""
    p, x = _k1_forward_case(dev, B + T + H, B, T, H, heads, F)
    rates = (0.1, 0.1)
    before = bl.bert_layer_call.launches
    out, resid = bl._launch_forward(x, p, heads, t_valid, 99, rates, True,
                                    True)
    assert bl.bert_layer_call.launches == before + 1
    want = bl.bert_layer_reference_parts(x, p, heads, t_valid, 99, rates,
                                         True)
    _close(out, want["out"])
    for name, got in bl.resid_parts(resid, B, T, H, heads).items():
        _close(got, want[name])
    again, resid_again = bl._launch_forward(x, p, heads, t_valid, 99, rates,
                                            True, True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(resid, resid_again)
    infer, none = bl._launch_forward(x, p, heads, t_valid, 0, (0.0, 0.0),
                                     False, False)
    assert none is None
    _close(infer, bl.bert_layer_reference(x, p, heads, t_valid))


def test_bert_layer_forward_float64_error_within_4x_simt(dev, monkeypatch):
    """K1's float32 forward on 3xTF32 tensor cores against a float64
    forward of the same inputs: the worst error of the output and of every
    saved residual, each relative to its tensor's max-abs, is at most 4x
    that of the forward on float32 FMAs (the port's first forward, kept as
    the yardstick behind ``_GEMM_SIMT``) on the same inputs."""
    p, x = _k1_forward_case(dev, 23, 4)
    rates = (0.1, 0.1)
    want = bl.bert_layer_reference_parts(x.double(), [t.double() for t in p],
                                         12, 369, 99, rates, True)

    def worst(simt):
        monkeypatch.setattr(bl, "_GEMM_SIMT", simt)
        out, resid = bl._launch_forward(x, p, 12, 369, 99, rates, True, True)
        got = {"out": out, **bl.resid_parts(resid, 4, 369, 84, 12)}
        return max(((got[n].double() - want[n]).abs().max()
                    / want[n].abs().max()).item() for n in want)
    tc, simt = worst(False), worst(True)
    assert tc <= 4 * simt, (tc, simt)


# the SwinV2 head's three stages: N, resolution, heads, shift
K4_STAGES = ((36, 12, 3, 3), (36, 6, 6, 0), (9, 3, 12, 0))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B", [4, 16, 64])
def test_window_attention_backward_flagship_stages(dev, B, rate):
    """K4 backward at the SwinV2 head's three stages (head dim 4) at batch
    4, 16 and 64: dq, dk, dv and dbias against autograd through the plain
    forward, one kernel launch a call (``torch.profiler``), two calls
    bitwise equal, and the last blocks' counters left at zero."""
    from multimodal_neuroimage_tpu_torch.bench.k1_split import launch_split
    gen = torch.Generator().manual_seed(B + int(10 * rate))
    for N, res, heads, shift in K4_STAGES:
        ws = int(np.sqrt(N))
        shape = (B, (res // ws) ** 2, heads, N, 4)
        q, k, v, g = (_rand(gen, *shape).to(dev) for _ in "qkvg")
        bias = _rand(gen, heads, N, N).to(dev)
        m = shift_attn_mask(res, res, ws, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        out = att.fused_window_attention(q, k, v, bias, mask, 41, rate)

        def call():
            return att.window_attention_backward(g, q, k, v, bias, mask, out,
                                                 41, rate)
        got, again = call(), call()
        want = att.attention_reference_backward(g, q, k, v, bias, mask, 41,
                                                rate)
        for a, b in zip(got[:3], want[:3]):
            _close(a, b)
        _close_sum(got[3], want[3], "dbias")
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        # one kernel, launched once a call (the profiler can drop the first
        # event of a window: 9 of 10 calls read 0.9)
        split = launch_split(call)
        launched = sum(n for n, _ in split.values())
        assert len(split) == 1 and round(launched) == 1, split
        assert not att._K4_COUNTERS[q.device].any()


@pytest.mark.parametrize("B", [4, 16, 64])
def test_window_attention_backward_scale_and_nan(dev, B):
    """K4 backward's gradients do not depend on the gradient's scale: at
    g 2^-20 they are bitwise 2^-20 times those at g, and at g 1e-6 each is
    within 1e-4 of its max of a float64 backward, with no absolute floor.
    A NaN in g gives NaN where the plain version has it, dbias included."""
    gen = torch.Generator().manual_seed(B + 5)
    for N, res, heads, shift in K4_STAGES:
        ws = int(np.sqrt(N))
        shape = (B, (res // ws) ** 2, heads, N, 4)
        q, k, v, g = (_rand(gen, *shape).to(dev) for _ in "qkvg")
        bias = _rand(gen, heads, N, N).to(dev)
        m = shift_attn_mask(res, res, ws, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        out = att.fused_window_attention(q, k, v, bias, mask, 41, 0.1)

        def call(g):
            return att.window_attention_backward(g, q, k, v, bias, mask, out,
                                                 41, 0.1)
        unit, tiny = call(g), call(g * 2.0 ** -20)
        assert all(torch.equal(a * 2.0 ** -20, b) for a, b in zip(unit, tiny))
        small = call(g * 1e-6)
        want = att.attention_reference_backward(
            *(t.double() for t in (g * 1e-6, q, k, v, bias)),
            None if mask is None else mask.double(), 41, 0.1)
        for a, b in zip(small, want):
            err = (a.double() - b).abs().max().item()
            assert err <= 1e-4 * b.abs().max().item(), (err, b.abs().max())
        gn = g.clone()
        gn[-1, 0, 0, 2, 1] = float("nan")
        got = call(gn)
        plain = att.attention_reference_backward(gn, q, k, v, bias, mask, 41,
                                                 0.1)
        assert got[3].isnan().any()
        for a, b in zip(got, plain):
            assert torch.equal(a.isnan(), b.isnan())


def _fusion_backward_case(dev, layout, cross, B, G, shift, seed):
    """Inputs and the two backward calls (kernel, plain) of the flagship's
    fusion block (196 windows of 36 x 12, 6 heads) on ``layout``, dropout
    and DropPath on."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(seed)
    C, ws, heads, res = 12, 6, 6, 84
    nW, N = (res // ws) ** 2, ws * ws
    qkv = (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C) if cross
           else _lin(gen, 3 * C, C))
    p = tuple(t.to(dev) for t in _ln(gen, C) + qkv + _lin(gen, C, C)
              + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    shape = (B // G, nW, N, G * C) if layout == "bp" else (B, nW, N, C)
    x, y, g = (_rand(gen, *shape).to(dev) for _ in "xyg")
    bias = _rand(gen, heads, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    dp = (torch.rand(B, 2, generator=gen) > 0.2).float().to(dev) / 0.8
    train = (dp, 17, RATES, True)
    ys = y if cross else None
    if layout == "bp":
        _, x2r = fbp._launch_forward(x, ys, p, bias, mask, *train, True, cross,
                                     G)
        kernel = fbp._backward
        ref = fbp.fusion_block_bp_reference_backward
        extra = (G,)
    else:
        _, x2r = fb._launch_forward(x, ys, p, bias, mask, *train, True, cross)
        kernel = fb._backward
        ref = fb.fusion_block_reference_backward
        extra = ()

    def run():
        return kernel(g, x, ys, p, bias, mask, *train, x2r, cross, *extra)

    def plain():
        return ref(g, x, ys, p, bias, mask, *train, cross, *extra)
    return run, plain


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("layout,B,G,shift", [
    ("std", 16, 1, 0), ("std", 16, 1, 3), ("std", 5, 1, 3),
    ("bp", 16, 8, 0), ("bp", 16, 8, 3), ("bp", 12, 6, 3)])
def test_fusion_backward_at_batch_16_and_ragged(dev, layout, cross, B, G,
                                               shift):
    """The multi-window fusion backward (K2/K3 std, K7 bp) at the flagship's
    batch 16 and where the subjects of a window position do not fill the
    windows a block keeps in flight (std B 5; bp G 6), dropout and
    DropPath on, against the plain backward."""
    run, plain = _fusion_backward_case(dev, layout, cross, B, G, shift,
                                       B + G + shift + cross)
    dx, dy, dbias, dps = run()
    want = plain()
    _close(dx, want[0])
    if cross:
        _close(dy, want[1])
    _close_sum(dbias, want[2], "dbias")
    for i, (a, b) in enumerate(zip(dps, want[3])):
        _close_sum(a, b, f"dparams[{i}]")


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("layout", ["std", "bp"])
def test_fusion_backward_is_bitwise_repeatable(dev, layout, cross):
    """Two backward calls on the same inputs give bitwise-equal dx, dy,
    dbias and parameter gradients: each accumulator element has one owner
    thread that adds its windows in a fixed order, and the per-block
    partials go through the ordered reduce."""
    run, _ = _fusion_backward_case(dev, layout, cross, 16,
                                   8 if layout == "bp" else 1, 3, 40 + cross)
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first[:3], second[:3]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(first[3], second[3]))


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


def _f32_form(kernel: str) -> bool:
    """A float32 kernel form (not the bf16 policy's K1 mm16 / K7 bf16)."""
    return not kernel.endswith(("mm16", "bf16"))


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
               if k.startswith(STD_PATH) and _f32_form(k)), counts
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
    on = [k for k in counts
          if k.startswith(("K1", "K4", "K7")) and _f32_form(k)]
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
               if "backward" not in k and k.startswith(STD_PATH)
               and _f32_form(k)}
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


# ---- K6's float32 form on 3xTF32 tensor cores -------------------------------------
#
# Every product on mma.sync TF32 in 3xTF32 form, the scores computed alike
# in the forward and both backward kernels (tests/test_torch_k6_tf32.py
# models the arithmetic on the CPU). At head dims 7, 11, 24, 42 and 64 and
# ragged T, dropout 0 and 0.1: against the plain version at 1e-4 + 2e-4
# |ref| (as test_mha_attention_kernel); the worst float64 error of out, dq,
# dk and dv, each relative to its tensor's max-abs, within 4x that of the
# CUDA-core form (attention._K6_SIMT) on the same inputs; max over (b, h, d)
# of |sum_j dk_j|, zero in exact arithmetic, within 2x the CUDA-core form's
# or 1e-5, whichever is larger (a backward that rebuilt p from scores taken
# another way than the forward's would miss it: the CPU test shows one).

K6_SHAPES32 = [(1, 3, 5, 7), (2, 2, 97, 11), (1, 2, 200, 7), (2, 2, 130, 24),
               (1, 2, 64, 42), (1, 1, 65, 64), (8, 2, 1201, 11)]
K6_F64_MULT, K6_SUM_MULT, K6_SUM_FLOOR = 4.0, 2.0, 1e-5


def _k6_inputs32(dev, B, H, T, D):
    gen = torch.Generator().manual_seed(B + H + T + D + 1)
    q, k, v, g = (_rand(gen, B, H, T, D).to(dev) for _ in range(4))
    return q * D ** -0.5, k, v, g


def _k6_run32(q, k, v, g, rate):
    """(out, (dq, dk, dv)) of the float32 form at seed 77."""
    out, lse = att._launch_mha_forward(q, k, v, 77, rate)
    grads = att.fused_attention_backward(g, q, k, v, out, lse, 77, rate)
    torch.cuda.synchronize()
    return out, grads


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,T,D", K6_SHAPES32)
def test_mha_attention_tensor_cores_vs_plain_and_float64(dev, monkeypatch, B,
                                                         H, T, D, rate):
    q, k, v, g = _k6_inputs32(dev, B, H, T, D)
    forms = {}
    for simt in (False, True):
        monkeypatch.setattr(att, "_K6_SIMT", simt)
        forms[simt] = _k6_run32(q, k, v, g, rate)
    out, grads = forms[False]
    _close(out, att.mha_reference(q, k, v, 77, rate))
    for a, b in zip(grads, att.mha_reference_backward(g, q, k, v, 77, rate)):
        _close(a, b)
    d = [t.double() for t in (g, q, k, v)]
    truth = [att.mha_reference(*d[1:], 77, rate)] + list(
        att.mha_reference_backward(*d, 77, rate))
    errs = {simt: [((a.double() - t).abs().max() / t.abs().max()).item()
                   for a, t in zip((o,) + tuple(gr), truth)]
            for simt, (o, gr) in forms.items()}
    sums = {simt: gr[1].double().sum(2).abs().max().item()
            for simt, (_, gr) in forms.items()}
    print(f"K6 f32 {(B, H, T, D)} rate {rate}: float64 error / max|truth| "
          f"(out, dq, dk, dv) tensor cores {errs[False]}, CUDA cores "
          f"{errs[True]}; max |sum_j dk_j| {sums[False]:.3e} vs "
          f"{sums[True]:.3e}")
    assert max(errs[False]) <= K6_F64_MULT * max(errs[True]), errs
    assert sums[False] <= max(K6_SUM_MULT * sums[True], K6_SUM_FLOOR), sums


def test_mha_attention_backward_is_bitwise_repeatable(dev):
    q, k, v, g = _k6_inputs32(dev, 8, 2, 1201, 11)
    for rate in (0.0, 0.1):
        first, second = _k6_run32(q, k, v, g, rate), _k6_run32(q, k, v, g,
                                                               rate)
        assert torch.equal(first[0], second[0])
        assert all(torch.equal(a, b) for a, b in zip(first[1], second[1]))


def test_fused_attention_launches_the_tensor_core_kernels(dev, monkeypatch):
    """fused_attention on float32 CUDA tensors runs one tensor-core forward
    and, in the backward, the delta pass and the two tensor-core kernels
    (device kernels by name, ``torch.profiler``); their launches count.
    Under attention._K6_SIMT the CUDA-core kernels run instead, uncounted."""
    from multimodal_neuroimage_tpu_torch.bench.k1_split import launch_split
    q, k, v, g = _k6_inputs32(dev, 2, 2, 97, 11)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]

    def call():
        return torch.autograd.grad(att.fused_attention(*ins, 77, 0.1), ins, g)
    counters = (att.fused_attention, att.fused_attention_backward)
    for simt, want in ((False, ("mha_forward_t32_kernel", "mha_delta_kernel",
                                "mha_backward_dkdv_t32_kernel",
                                "mha_backward_dq_t32_kernel")),
                       (True, ("mha_forward_kernel", "mha_delta_kernel",
                               "mha_backward_dkdv_kernel",
                               "mha_backward_dq_kernel"))):
        monkeypatch.setattr(att, "_K6_SIMT", simt)
        before = [c.launches for c in counters]
        split = launch_split(call)
        names = sorted(key for key in split if "mha_" in key)
        assert len(names) == 4 and all(
            any(w + "<" in n for n in names) for w in want), split
        assert all(round(split[n][0]) == 1 for n in names), split
        assert len(split) == 4, split
        assert [c.launches for c in counters] == [
            n + 11 * (not simt) for n in before]


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


# ---- the bf16 policy's kernels: K1's mm16 form, K7 on bf16 streams ------------
#
# Both sides round the same operands to bf16 in other orders of float32
# sums, so a value can land on the other side of a bf16 rounding boundary
# (2^-8 relative) and carry that step on: K1's float32 output |kernel -
# plain| <= 1e-2 + 2^-7 |plain|; K7's bf16 outputs (the residual plus a
# branch that carries such a step at the branch's scale, then rounded to
# bf16) and every gradient within 1e-2 of their tensor's max-abs, the key
# bias's (zero in exact arithmetic) at the scale of the key weight's
# (chip_smoke.py ATOL16, RTOL16, REL16).
ATOL16, RTOL16, REL16 = 1e-2, 2.0 ** -7, 1e-2


def _close16(got, want, what=""):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    bound = ATOL16 + RTOL16 * want.float().abs()
    assert torch.isfinite(got).all() and (err <= bound).all(), (
        what, err.max().item())


def _close_rel16(got, want, what="", scale=None):
    torch.cuda.synchronize()
    scale = want.float().abs().max().item() if scale is None else scale
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all() and err <= REL16 * scale, (what, err,
                                                                scale)


def _k1_params16(gen, H, F, dev):
    p = (sum((_lin(gen, H, H) for _ in range(4)), []) + _ln(gen, H)
         + _lin(gen, F, H) + _lin(gen, H, F) + _ln(gen, H))
    return tuple(t.to(torch.bfloat16).float().to(dev) for t in p)


@pytest.mark.parametrize("B,T,H,heads,F,t_valid", [
    (4, 369, 84, 12, 3072, 369), (16, 369, 84, 12, 3072, 369),
    (3, 45, 28, 4, 96, 30), (1, 369, 84, 12, 3072, 300),
    (64, 369, 84, 12, 3072, 369), (2, 17, 96, 6, 64, 17),
    (3, 45, 84, 4, 96, 30), (2, 130, 84, 1, 64, 100), (2, 70, 48, 2, 64, 66),
    (2, 70, 84, 3, 96, 70), (1, 45, 96, 2, 64, 45)])
def test_bert_layer_mm16_kernels(dev, B, T, H, heads, F, t_valid):
    """K1's mm16 form forward (inference) and backward (dropout 0.1) against
    its plain versions: the flagship's full width at batches 1 (keys masked
    past t_valid), 4, 16 and 64, a ragged case (odd head dim, keys masked
    past t_valid, partial tiles), head dim 16 at the widest H with F under
    one slice and T under one tile, and head dims 21, 84, 24, 28 and 48
    (2, 6, 2, 2 and 3 k16 steps)."""
    gen = torch.Generator().manual_seed(B * T)
    p = _k1_params16(gen, H, F, dev)
    x, g = (_rand(gen, B, T, H).to(dev) for _ in "xg")
    before = bl.bert_layer_call16.launches
    got = bl.bert_layer_call(x, p, heads, t_valid, mm16=True)
    assert bl.bert_layer_call16.launches == before + 1
    _close16(got, bl.bert_layer_reference(x, p, heads, t_valid, mm16=True),
             "forward")
    seed, rates = 77, (0.1, 0.1)
    _, resid = bl._launch_forward(x, p, heads, t_valid, seed, rates, True,
                                  True, True)
    before = bl.bert_layer_backward16.launches
    dx, dps = bl.bert_layer_backward16(g, x, p, resid, heads, t_valid, seed,
                                       rates, True)
    assert bl.bert_layer_backward16.launches == before + 1
    wdx, wdps = bl.bert_layer_reference_backward16(g, x, p, heads, t_valid,
                                                   seed, rates, True)
    _close_rel16(dx, wdx, "dx")
    for i, (a, b) in enumerate(zip(dps, wdps)):
        _close_rel16(a, b, f"dparams[{i}]",
                     wdps[2].abs().max().item() if i == 3 else None)


def test_bert_layer_mm16_repeatable(dev):
    """Two calls of each mm16 entry (the training forward with dropout, the
    backward) on the same inputs are bitwise equal: every cross-block sum
    is added in a fixed order, with no float atomics."""
    gen = torch.Generator().manual_seed(29)
    B, T, H, heads, F = 16, 369, 84, 12, 3072
    p = _k1_params16(gen, H, F, dev)
    x, g = (_rand(gen, B, T, H).to(dev) for _ in "xg")
    seed, rates = 31, (0.1, 0.1)
    runs = []
    for _ in range(2):
        out, resid = bl._launch_forward(x, p, heads, T, seed, rates, True,
                                        True, True)
        dx, dps = bl.bert_layer_backward16(g, x, p, resid, heads, T, seed,
                                           rates, True)
        runs.append((out, resid, dx) + tuple(dps))
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


def _fusion_params16(gen, C, cross, dev):
    p = (_ln(gen, C) + (_ln(gen, C) + _lin(gen, C, C) + _lin(gen, 2 * C, C)
                        if cross else _lin(gen, 3 * C, C))
         + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
         + _lin(gen, C, 4 * C))
    return tuple(t.to(torch.bfloat16).float().to(dev) for t in p)


@pytest.mark.parametrize("B,shift", [(16, 0), (16, 3), (3, 3)])
@pytest.mark.parametrize("cross", [False, True])
def test_fusion_block_bp_bf16_kernels(dev, monkeypatch, B, shift, cross):
    """K7 on bf16 streams (mm16 products) at the flagship's window shapes,
    forward and backward with dropout and DropPath on, against the bf16
    plain versions: batch 16 (two groups of 8) and a ragged count of 3
    subjects (one group, fewer than the backward's four windows in
    flight)."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    monkeypatch.delenv("FUSION_BP_GROUP", raising=False)
    gen = torch.Generator().manual_seed(B + shift + cross)
    C, H, N, nW = 12, 6, 36, 196
    G = fbp.group_size(B)
    params = _fusion_params16(gen, C, cross, dev)
    bias = _rand(gen, H, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(84, 84, 6, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    x, y, g = (fbp.to_groups(_rand(gen, B, nW, N, C), G).contiguous()
               .to(dev).to(torch.bfloat16) for _ in range(3))
    y = y if cross else None
    dp = ((torch.rand(B, 2, generator=gen) > 0.2).float() * 1.25).to(dev)
    seed, rates = 5, (0.1, 0.1)
    counter = (fbp.fused_cross_fusion_block_bp16 if cross
               else fbp.fused_fusion_block_bp16)
    before = counter.launches
    out, x2r = fbp._launch_forward(x, y, params, bias, mask, dp, seed, rates,
                                   True, True, cross, G)
    assert counter.launches == before + 1
    assert out.dtype == x2r.dtype == torch.bfloat16
    want, want_x2r = fbp.fusion_block_bp_reference16(
        x, params, bias, mask, dp, seed, rates, True, y, G)
    _close_rel16(out, want, "out")
    _close_rel16(x2r, want_x2r, "x2r")
    counter = (fbp.fused_cross_fusion_block_bp_backward16 if cross
               else fbp.fused_fusion_block_bp_backward16)
    before = counter.launches
    got = fbp._backward(g, x, y, params, bias, mask, dp, seed, rates, True,
                        x2r, cross, G)
    assert counter.launches == before + 1
    ref = fbp.fusion_block_bp_reference_backward16(
        g, x, y, params, bias, mask, dp, seed, rates, True, cross, G)
    assert got[0].dtype == torch.bfloat16
    _close_rel16(got[0], ref[0], "dx")
    if cross:
        _close_rel16(got[1], ref[1], "dy")
    _close_rel16(got[2], ref[2], "dbias")
    for i, (a, b) in enumerate(zip(got[3], ref[3])):
        _close_rel16(a, b, f"dparams[{i}]")


def test_bf16_kernels_repeat_bitwise(dev):
    """Two calls of each bf16-policy backward give the same bits (ordered
    partial sums, no float atomics)."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(9)
    p = _k1_params16(gen, 84, 3072, dev)
    x, g = (_rand(gen, 4, 369, 84).to(dev) for _ in "xg")
    _, resid = bl._launch_forward(x, p, 12, 369, 3, (0.1, 0.1), True, True,
                                  True)
    a = bl.bert_layer_backward16(g, x, p, resid, 12, 369, 3, (0.1, 0.1), True)
    b = bl.bert_layer_backward16(g, x, p, resid, 12, 369, 3, (0.1, 0.1), True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(u, v) for u, v in zip(a[1], b[1]))
    params = _fusion_params16(gen, 12, False, dev)
    bias = _rand(gen, 6, 36, 36, scale=0.5).to(dev)
    xg, gg = (fbp.to_groups(_rand(gen, 16, 196, 36, 12), 8).contiguous()
              .to(dev).to(torch.bfloat16) for _ in "xg")
    dp = torch.full((16, 2), 1.0, device=dev)
    _, x2r = fbp._launch_forward(xg, None, params, bias, None, dp, 3,
                                 (0.1, 0.1), True, True, False, 8)
    a, b = (fbp._backward(gg, xg, None, params, bias, None, dp, 3, (0.1, 0.1),
                          True, x2r, False, 8) for _ in "ab")
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    assert all(torch.equal(u, v) for u, v in zip(a[3], b[3]))


def _bp16_backward_case(dev, B, G, shift, cross, rates, seed=5):
    """K7's bf16 backward (its tensor-core body) and its plain version on
    the same inputs at the flagship's window shapes: (kernel, plain, the
    launches the kernel call counted, a second kernel call)."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(B * 10 + shift + cross)
    C, H, N, nW = 12, 6, 36, 196
    params = _fusion_params16(gen, C, cross, dev)
    bias = _rand(gen, H, N, N, scale=0.5).to(dev)
    m = shift_attn_mask(84, 84, 6, shift)
    mask = None if m is None else torch.from_numpy(m).to(dev)
    x, y, g = (fbp.to_groups(_rand(gen, B, nW, N, C), G).contiguous()
               .to(dev).to(torch.bfloat16) for _ in range(3))
    y = y if cross else None
    dp = ((torch.rand(B, 2, generator=gen) > 0.2).float() * 1.25).to(dev)
    _, x2r = fbp._launch_forward(x, y, params, bias, mask, dp, seed, rates,
                                 True, True, cross, G)
    counter = (fbp.fused_cross_fusion_block_bp_backward16 if cross
               else fbp.fused_fusion_block_bp_backward16)
    before = counter.launches

    def call():
        return fbp._backward(g, x, y, params, bias, mask, dp, seed, rates,
                             True, x2r, cross, G)
    got = call()
    launched = counter.launches - before
    ref = fbp.fusion_block_bp_reference_backward16(
        g, x, y, params, bias, mask, dp, seed, rates, True, cross, G)
    return got, ref, launched, call()


@pytest.mark.parametrize("B,G,shift,rates", [
    (16, 8, 0, (0.0, 0.0)), (16, 8, 3, (0.0, 0.0)), (16, 8, 0, (0.1, 0.1)),
    (16, 8, 3, (0.1, 0.1)), (12, 6, 3, (0.1, 0.1)), (14, 7, 0, (0.1, 0.1)),
    (11, 11, 3, (0.1, 0.1))])
@pytest.mark.parametrize("cross", [False, True])
def test_fusion_block_bp_bf16_backward_tensor_cores(dev, B, G, shift, rates,
                                                    cross):
    """K7's bf16 backward on bf16 tensor cores against its plain version at
    chip_smoke.py's tolerances (every output and gradient within REL16 of
    its max-abs): self and cross, shifts 0 and 3, dropout 0 and 0.1 with
    DropPath, the bp flagship's B 16 (two groups of 8), groups of 6 and 7
    (every subject in flight at once) and one group of 11 (more than the 8
    windows a block holds: chunks of 6 and 5, which the windows in flight
    do not divide); one launch counted a call, and a second call bitwise
    equal."""
    got, ref, launched, again = _bp16_backward_case(dev, B, G, shift, cross,
                                                    rates)
    assert launched == 1
    assert got[0].dtype == torch.bfloat16
    _close_rel16(got[0], ref[0], "dx")
    if cross:
        _close_rel16(got[1], ref[1], "dy")
    _close_rel16(got[2], ref[2], "dbias")
    for i, (a, b) in enumerate(zip(got[3], ref[3])):
        _close_rel16(a, b, f"dparams[{i}]")
    assert torch.equal(got[0], again[0]) and torch.equal(got[2], again[2])
    if cross:
        assert torch.equal(got[1], again[1])
    assert all(torch.equal(u, v) for u, v in zip(got[3], again[3]))


def test_fusion_block_bp_bf16_backward_occupancy(dev):
    """The bf16 backward's launch plan at the bp flagship's shapes: all 8
    windows of a group in flight a block, self and cross, within the
    card's shared memory, a block an SM."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    for cross in (False, True):
        occ = fb.backward_occupancy("fusion_block_bp_backward16", cross,
                                    (2, 8, 196), 36, 12, 6, 48)
        assert occ["blocks_per_sm"] >= 1
        assert occ["windows_per_block"] == 8, occ
        assert occ["smem_bytes"] <= 232448 and occ["grid_blocks"] >= 132


def test_bf16_calls_launch_or_raise(dev):
    """A bf16 call on the card launches its kernel or raises: K7 takes bf16
    streams (its bf16 form launches), K2/K3 and K1 take float32 streams only
    (K1's bf16 form runs on a float32 stream), and no wrapper widens a bf16
    stream quietly or falls back to its plain version."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(4)
    params = _fusion_params16(gen, 12, False, dev)
    bias = torch.zeros(6, 36, 36, device=dev)
    xw = torch.zeros(2, 4, 36, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fb.fused_fusion_block(xw, params, bias)
    before = fbp.fused_fusion_block_bp16.launches
    out = fbp.fused_fusion_block_bp(fbp.to_groups(xw, 2).contiguous(), params,
                                    bias, group=2)
    assert out.dtype == torch.bfloat16
    assert fbp.fused_fusion_block_bp16.launches == before + 1
    with pytest.raises(TypeError, match="float16"):
        fbp.fused_fusion_block_bp(fbp.to_groups(xw, 2).contiguous().half(),
                                  params, bias, group=2)
    p = _k1_params16(gen, 28, 64, dev)
    x = torch.zeros(1, 9, 28, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        bl.bert_layer_call(x, p, 4, 9, mm16=True)


@pytest.mark.parametrize("layout", ["std", "bp"])
def test_tiny_bf16_training_step_on_the_card_matches_the_cpu(dev, layout,
                                                             monkeypatch):
    """One training step of the tiny flagship at compute_dtype="bfloat16" on
    the card (K1 mm16; K2/K3 or K7 bf16) against the same step on the CPU
    through the plain versions, from the same weights, batch and generator
    state: every kernel of the layout's bf16 path launches; loss within
    5e-2; each gradient a bf16 value widened, within 5e-2 (SwinV2 head) or
    0.5 (backbone, fMRI embedder) of its component's largest gradient (the
    backbone amplifies bf16 rounding steps; chip_smoke.py GRAD16)."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.nn import swinfusion
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    monkeypatch.setattr(swinfusion, "_LAYOUT", layout)
    cfg = _tiny_cfg()
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch = _tiny_batch(cfg)
    models, losses = {}, {}
    for device in (dev.type, "cpu"):
        model = _tiny_model(cfg, device)
        opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3,
                               cfg.weight_decay)
        step = make_train_step(model, specs, opt, "bfloat16", device)
        ops.reset_launches()
        losses[device] = step(batch, torch.Generator().manual_seed(3))[0]
        if device == "cuda":
            counts = ops.launches()
            path = (["K1 bert_layer mm16", "K1 bert_layer backward mm16",
                     "K4 window_attention", "K5 fused_adam"]
                    + (["K7 fusion_block_bp bf16",
                        "K7 fusion_block_bp backward bf16",
                        "K7 cross_fusion_block_bp bf16",
                        "K7 cross_fusion_block_bp backward bf16"]
                       if layout == "bp" else
                       ["K2 fusion_block", "K3 cross_fusion_block"]))
            assert all(counts[k] for k in path), counts
            assert counts["K1 bert_layer"] == 0, counts
        models[device] = model
    torch.cuda.synchronize()
    np.testing.assert_allclose(losses["cuda"]["total"].item(),
                               losses["cpu"]["total"].item(), rtol=5e-2,
                               atol=5e-2)
    want = dict(models["cpu"].named_parameters())
    scale = {}
    for name, q in want.items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), q.grad.abs().max().item())
    share = {"swin": 5e-2, "fusion": 0.5, "fmri_embed": 0.5}
    for name, p in models["cuda"].named_parameters():
        part = name.split(".")[0]
        g = p.grad.cpu()
        assert torch.equal(g, g.to(torch.bfloat16).float()), name
        err = (g - want[name].grad).abs().max().item()
        assert err <= share[part] * scale[part], (name, err, scale[part])


# ---- K6's bf16 form (HCP at the bf16 policy) ------------------------------------
#
# bf16 q/k/v, float32 arithmetic, bf16 outputs: kernel and plain version
# round the same float32 values once, in other orders of float32 sums, so
# an output can land on the neighbouring bf16 value (2^-8 relative):
# forward |kernel - plain| <= 2^-7 |plain| + 1e-3 max|plain|, gradients
# within 1e-2 of their tensor's max-abs (chip_smoke.py holds the same).

@pytest.mark.parametrize("B,H,T,D,rate", [
    (2, 2, 97, 11, 0.0), (2, 2, 97, 11, 0.25), (1, 3, 5, 7, 0.25),
    (2, 2, 130, 24, 0.25), (1, 1, 65, 64, 0.1), (8, 2, 1201, 11, 0.1)])
def test_mha_attention_bf16_kernel(dev, B, H, T, D, rate):
    """The bf16 forward and backward against the bf16 plain versions on the
    same hash masks; each launches once, the float32 form never."""
    gen = torch.Generator().manual_seed(B + H + T + D)
    q, k, v = (_rand(gen, B, H, T, D).to(dev).to(torch.bfloat16)
               .requires_grad_() for _ in "qkv")
    g = _rand(gen, B, H, T, D).to(dev).to(torch.bfloat16)
    counters = (att.fused_attention16, att.fused_attention_backward16,
                att.fused_attention, att.fused_attention_backward)
    before = [c.launches for c in counters]
    out = att.fused_attention(q, k, v, 77, rate)
    assert out.dtype == torch.bfloat16
    out.backward(g)
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + 1,
                                              before[2], before[3]]
    torch.cuda.synchronize()
    want = att.mha_reference16(q.detach(), k.detach(), v.detach(), 77, rate)
    err = (out.detach().float() - want.float()).abs()
    assert (err <= 2.0 ** -7 * want.float().abs()
            + 1e-3 * want.float().abs().max()).all(), err.max().item()
    for a, b in zip((q, k, v), att.mha_reference_backward16(
            g, q.detach(), k.detach(), v.detach(), 77, rate)):
        assert a.grad.dtype == torch.bfloat16
        e = (a.grad.float() - b.float()).abs().max().item()
        assert e <= 1e-2 * b.float().abs().max().item(), e


def test_mha_attention_bf16_launches_or_raises(dev):
    """A bf16 call on the card launches the bf16 kernel or raises: mixed
    dtypes refuse, and no call falls back to the float32 form."""
    z = torch.zeros(1, 2, 9, 11, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        att.fused_attention(z, z.float(), z)
    with pytest.raises(TypeError, match="bfloat16"):
        att.fused_attention_backward16(z.float(), z, z, z, z.float(),
                                       z[..., 0].float())
    before = att.fused_attention.launches
    with torch.no_grad():
        out = att.fused_attention16(z, z, z)
    assert out.dtype == torch.bfloat16 and att.fused_attention.launches == \
        before


# ---- K6's bf16 form on tensor cores, against float64 ---------------------------
#
# The tensor-core kernels split the float32 operand of p v, p^T dO, ds^T q
# and ds k into bf16 hi + lo (tests/test_torch_k6_mma.py models it on the
# CPU). Against a float64 truth on the same bf16 inputs and masks: out32
# within 2^-14 max|truth|, dq, dk, dv within 2^-8 |truth| + 2^-12
# max|truth| (one bf16 rounding and a float32 error), every shape the
# bf16 kernel test takes, dropout 0 and 0.1. The CUDA-core form
# (attention._K6_SIMT, float32 on the CUDA cores) is the yardstick beside
# it: each tensor-core gradient's float64 error (as a share of its bound)
# within K6_SIMT_GRAD_MULT times the CUDA-core form's, since both are held
# by the one bf16 rounding and a bf16 p or ds without its lo half adds an
# 8-bit error (tests/test_torch_k6_mma.py shows the model of that design
# missing the multiple); the share of bf16 outputs bit-equal to it printed.

K6_SHAPES16 = [(2, 2, 97, 11), (1, 3, 5, 7), (2, 2, 130, 24), (1, 1, 65, 64),
               (8, 2, 1201, 11)]
OUT64_REL, GRAD64_RTOL, GRAD64_REL = 2.0 ** -14, 2.0 ** -8, 2.0 ** -12
K6_SIMT_GRAD_MULT = 1.25


def _k6_inputs16(dev, B, H, T, D):
    gen = torch.Generator().manual_seed(B + H + T + D)
    q, k, v, g = (_rand(gen, B, H, T, D).to(dev).to(torch.bfloat16)
                  for _ in range(4))
    return q, k, v, g


def _k6_run16(q, k, v, g, rate):
    """(out, out32, (dq, dk, dv)) of the bf16 form at seed 77."""
    out, out32, lse = att._launch_mha_forward16(q, k, v, 77, rate, True)
    grads = att.fused_attention_backward16(g, q, k, v, out32, lse, 77, rate)
    torch.cuda.synchronize()
    return out, out32, grads


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("B,H,T,D", K6_SHAPES16)
def test_mha_attention_bf16_tensor_cores_vs_float64(dev, monkeypatch, B, H, T,
                                                   D, rate):
    q, k, v, g = _k6_inputs16(dev, B, H, T, D)
    out_t = att.mha_reference(q.double(), k.double(), v.double(), 77, rate)
    grads_t = att.mha_reference_backward(g.double(), q.double(), k.double(),
                                         v.double(), 77, rate)
    forms = {}
    for simt in (False, True):
        monkeypatch.setattr(att, "_K6_SIMT", simt)
        forms[simt] = _k6_run16(q, k, v, g, rate)
    report = []
    for simt, (out, out32, grads) in forms.items():
        ok = True
        e_out = (out32.double() - out_t).abs().max().item()
        ok &= e_out <= OUT64_REL * out_t.abs().max().item()
        shares = []
        for a, b in zip(grads, grads_t):
            bound = GRAD64_RTOL * b.abs() + GRAD64_REL * b.abs().max()
            share = ((a.double() - b).abs() / bound).max().item()
            ok &= share <= 1.0
            shares.append(share)
        report.append((simt, ok, e_out / out_t.abs().max().item(), shares))
    same = [(a == b).float().mean().item()
            for a, b in zip((forms[False][0],) + tuple(forms[False][2]),
                            (forms[True][0],) + tuple(forms[True][2]))]
    print(f"K6 bf16 {(B, H, T, D)} rate {rate}: (SIMT?, within, out32 err / "
          f"max|truth|, grad err / bound) {report}; bf16 out, dq, dk, dv "
          f"bit-equal to the CUDA-core form's: {same}")
    assert report[0][1], report[0]
    assert all(a <= K6_SIMT_GRAD_MULT * b
               for a, b in zip(report[0][3], report[1][3])), report


def test_mha_attention_bf16_backward_is_bitwise_repeatable(dev):
    q, k, v, g = _k6_inputs16(dev, 8, 2, 1201, 11)
    for rate in (0.0, 0.1):
        first = _k6_run16(q, k, v, g, rate)
        second = _k6_run16(q, k, v, g, rate)
        assert torch.equal(first[0], second[0])
        for a, b in zip(first[2], second[2]):
            assert torch.equal(a, b)


def test_fused_attention_bf16_launches_the_tensor_core_kernels(dev,
                                                              monkeypatch):
    """fused_attention on bf16 launches mha_forward16 and mha_backward16
    (their launches count), never the CUDA-core form, which runs only under
    attention._K6_SIMT and does not count."""
    from multimodal_neuroimage_tpu_torch.ops import build
    lib = build.library()
    names = []

    class Spy:
        def call(self, name, *args):
            names.append(name)
            return lib.call(name, *args)

    monkeypatch.setattr(build, "library", lambda: Spy())
    q, k, v, g = _k6_inputs16(dev, 2, 2, 97, 11)
    counters = (att.fused_attention16, att.fused_attention_backward16)
    for simt, want in ((False, ["mha_forward16", "mha_backward16"]),
                       (True, ["mha_forward16_simt", "mha_backward16_simt"])):
        monkeypatch.setattr(att, "_K6_SIMT", simt)
        names.clear()
        before = [c.launches for c in counters]
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        att.fused_attention(*ins, 77, 0.1).backward(g)
        assert names == want
        assert [c.launches for c in counters] == [
            n + (not simt) for n in before]


# ---- the registered ops (ops/library.py) and the exported artifact ----------

def _op_cases(dev):
    """(name, op call, direct wrapper call, plain version, wrapper whose
    count the op adds to, bf16 form) of each registered op at small
    flagship-like shapes."""
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    from multimodal_neuroimage_tpu_torch.ops import library
    gen = torch.Generator().manual_seed(20)
    B, T, H, F, heads, t_valid = 2, 45, 84, 96, 4, 40
    p1 = tuple(t.to(dev) for t in sum((_lin(gen, H, H) for _ in range(4)),
                                      []) + _ln(gen, H) + _lin(gen, F, H)
               + _lin(gen, H, F) + _ln(gen, H))
    p16 = _k1_params16(gen, H, F, dev)
    x1 = _rand(gen, B, T, H).to(dev)
    C, nW, N, fh = 12, 4, 36, 6
    selfp = tuple(t.to(dev) for t in _ln(gen, C) + _lin(gen, 3 * C, C)
                  + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
                  + _lin(gen, C, 4 * C))
    crossp = tuple(t.to(dev) for t in _ln(gen, C) + _ln(gen, C)
                   + _lin(gen, C, C) + _lin(gen, 2 * C, C) + _lin(gen, C, C)
                   + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    m = shift_attn_mask(12, 12, 6, 3)
    mask = torch.from_numpy(m).to(dev)
    bias = _rand(gen, fh, N, N, scale=0.5).to(dev)
    xw, yw = (_rand(gen, 4, nW, N, C).to(dev) for _ in "xy")
    G = 2
    xg, yg = (fbp.to_groups(t, G).contiguous() for t in (xw, yw))
    q, k, v = (_rand(gen, B, nW, 3, N, 32).to(dev) for _ in "qkv")
    kbias = _rand(gen, 3, N, N, scale=0.5).to(dev)
    mq, mk, mv = (_rand(gen, B, 2, 97, 11).to(dev) for _ in "qkv")
    hq, hk, hv = (t.to(torch.bfloat16) for t in (mq, mk, mv))
    xg16, yg16 = xg.to(torch.bfloat16), yg.to(torch.bfloat16)
    return [
        ("bert_layer_forward",
         lambda: library.bert_layer_forward(x1, list(p1), heads, t_valid,
                                            False),
         lambda: bl.bert_layer_call(x1, p1, heads, t_valid),
         lambda: bl.bert_layer_reference(x1, p1, heads, t_valid),
         bl.bert_layer_call, False),
        ("bert_layer_forward (mm16)",
         lambda: library.bert_layer_forward(x1, list(p16), heads, t_valid,
                                            True),
         lambda: bl.bert_layer_call16(x1, p16, heads, t_valid),
         lambda: bl.bert_layer_reference(x1, p16, heads, t_valid, mm16=True),
         bl.bert_layer_call16, True),
        ("fusion_block_forward (self)",
         lambda: library.fusion_block_forward(xw, None, list(selfp), bias,
                                              mask),
         lambda: fb.fused_fusion_block(xw, selfp, bias, mask),
         lambda: fb.fusion_block_reference(xw, selfp, bias, mask),
         fb.fused_fusion_block, False),
        ("fusion_block_forward (cross)",
         lambda: library.fusion_block_forward(xw, yw, list(crossp), bias,
                                              mask),
         lambda: fb.fused_cross_fusion_block(xw, yw, crossp, bias, mask),
         lambda: fb.cross_fusion_block_reference(xw, yw, crossp, bias, mask),
         fb.fused_cross_fusion_block, False),
        ("window_attention_forward",
         lambda: library.window_attention_forward(q, k, v, kbias, mask),
         lambda: att.fused_window_attention(q, k, v, kbias, mask),
         lambda: att.attention_reference(q, k, v, kbias, mask),
         att.fused_window_attention, False),
        ("mha_forward",
         lambda: library.mha_forward(mq, mk, mv),
         lambda: att.fused_attention(mq, mk, mv),
         lambda: att.mha_reference(mq, mk, mv), att.fused_attention, False),
        ("mha_forward (bf16)",
         lambda: library.mha_forward(hq, hk, hv),
         lambda: att.fused_attention16(hq, hk, hv),
         lambda: att.mha_reference16(hq, hk, hv), att.fused_attention16,
         True),
        ("fusion_block_bp_forward (cross)",
         lambda: library.fusion_block_bp_forward(xg, yg, list(crossp), bias,
                                                 mask, G),
         lambda: fbp.fused_cross_fusion_block_bp(xg, yg, crossp, bias, mask,
                                                 group=G),
         lambda: fbp.cross_fusion_block_bp_reference(xg, yg, crossp, bias,
                                                     mask, group=G),
         fbp.fused_cross_fusion_block_bp, False),
        ("fusion_block_bp_forward (bf16, self)",
         lambda: library.fusion_block_bp_forward(xg16, None, list(selfp),
                                                 bias, mask, G),
         lambda: fbp.fused_fusion_block_bp16(xg16, selfp, bias, mask,
                                             group=G),
         lambda: fbp.fusion_block_bp_reference16(xg16, selfp, bias, mask,
                                                 group=G)[0],
         fbp.fused_fusion_block_bp16, True),
    ]


def test_registered_ops_match_their_plain_versions(dev):
    """Each registered op on CUDA tensors launches its kernel once through
    its wrapper's launcher (counted on that wrapper), equals the direct
    wrapper call bit for bit, and is within the kernel's bound of its plain
    version on the same card (float32: ``_close``; the bf16 forms:
    ``_close_rel16``)."""
    from multimodal_neuroimage_tpu_torch.ops import library
    cases = _op_cases(dev)
    assert len({c[0].split(" ")[0] for c in cases}) == len(library.ops())
    with torch.no_grad():
        for name, op, direct, plain, counter, bf16 in cases:
            before = counter.launches
            got = op()
            assert counter.launches == before + 1, name
            torch.cuda.synchronize()
            assert torch.equal(got, direct()), name
            want = plain()
            assert got.dtype == want.dtype and got.shape == want.shape, name
            if bf16:
                _close_rel16(got, want, name)
            else:
                _close(got, want)


def test_exported_tiny_flagship_launches_its_kernels(dev, tmp_path):
    """The tiny flagship exported on the card: the artifact's graph calls
    K1, K2/K3 and K4's registered ops; one served batch launches exactly
    what the live Predictor's step launches, and the scores agree within
    rtol / atol 1e-5 (about one float32 ulp apart: the live model on
    copies of its weights moves as much, serve/export.py); the portable
    artifact launches no kernel and agrees within the logits' bound."""
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
    from multimodal_neuroimage_tpu_torch.serve.export import (export_model,
                                                              load_exported)
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    cfg = _tiny_cfg()
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"),
                           _tiny_model(cfg, "cpu").state_dict(),
                           {"val_threshold": 0.5})
    rng = np.random.default_rng(0)
    reqs = [{"subject": f"s{i}", "fmri": rng.normal(size=(48, 360)),
             "struct": rng.normal(size=(48, 48))} for i in range(2)]
    pred = Predictor(cfg, ckpt, reqs, device="cuda")
    batch, _ = next(pred.batches())
    art = load_exported(export_model(pred, str(tmp_path / "a.pt2")))
    portable = load_exported(export_model(pred, str(tmp_path / "p.pt2"),
                                          portable=True))
    assert len(art.meta["ops"]) == 3 and portable.meta["ops"] == []
    counts = []
    for fn in (lambda: pred.step(batch)[pred.head].reshape(-1).cpu().numpy(),
               lambda: art(batch), lambda: portable(batch)):
        torch.cuda.synchronize()
        ops.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts.append((ops.launches(), out))
    (live_n, live), (art_n, got), (port_n, plain) = counts
    assert art_n == live_n and sum(live_n.values()) > 0, (art_n, live_n)
    assert all(live_n[k] > 0 for k in live_n if k.startswith(STD_PATH)
               and "backward" not in k and _f32_form(k)), live_n
    assert sum(port_n.values()) == 0, port_n
    np.testing.assert_allclose(got, live, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(plain, live, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_step_count_on_the_card_equals_the_cpu(dev, compute_dtype):
    """The tiny flagship's training and predict steps count the same
    products on the card (the kernels by their formulas) as on the CPU
    (their plain versions, by the same formulas), each kernel of the path
    launched; ``compiled_cost`` on the card is the count less the kernels'
    share, which the library cannot see."""
    import dataclasses
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.obs.profiling import (Census,
                                                               compiled_cost)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    cfg = dataclasses.replace(_tiny_cfg(), compute_dtype=compute_dtype)
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch = _tiny_batch(cfg)
    counts = {}
    for device in ("cpu", dev.type):
        model = _tiny_model(cfg, device)
        opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3,
                               cfg.weight_decay)
        train = make_train_step(model, specs, opt, compute_dtype, device)
        predict = make_predict_step(model, compute_dtype, device)
        ops.reset_launches()
        with Census() as p, torch.no_grad():
            predict(batch)
        with Census() as t:
            train(batch, torch.Generator().manual_seed(3))
        launched = {k for k, n in ops.launches().items() if n}
        counts[device] = (p.total, t.total)
        if device == "cuda":
            assert {k for k, n in t.kernels.items() if n} <= launched
            share = sum(t.kernels.values())
            assert share > 0
            assert compiled_cost(train, batch, torch.Generator().manual_seed(
                3))["flops"] == t.total - share
    assert counts["cuda"] == counts["cpu"]
