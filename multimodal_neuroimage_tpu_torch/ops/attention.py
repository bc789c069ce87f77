"""K4 (bias-and-mask window attention) and K6 (plain multi-head attention
over long sequences), each forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/attention.py
``fused_window_attention`` (``_fab_fwd`` / ``_fab_bwd``) and
``fused_attention`` (``_fused_fwd`` / ``_fused_bwd``). The CUDA kernels are
``csrc/window_attention.cu`` and ``csrc/mha_attention.cu``; the autograd
Function around each runs its kernels on CUDA tensors and its plain version
(and autograd through it) on CPU tensors.

Both drop normalised probabilities, in training, with the port's
coordinate hash (``ops/fusion_block.py`` ``mix_keep``): K4 at row
``((b * nW + w) * H + h) * N + i``, column ``j``, draw
``WINDOW_ATTN_DRAW``; K6 at row ``(b * H + h) * T + i``, column ``j``, draw
``MHA_DRAW``. The JAX kernels draw from the TPU's PRNG instead, so port and
JAX agree at rate 0 only; with dropout on, each kernel is held against the
port's plain version on the same masks (on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_neuroimage_tpu_torch.ops import build, flops, library
from multimodal_neuroimage_tpu_torch.ops.bert_layer import matmul_3xtf32
from multimodal_neuroimage_tpu_torch.ops.fusion_block import mix_keep


WINDOW_ATTN_DRAW = 5   # hash draw of K4's dropout (csrc/window_attention.cu)
MHA_DRAW = 4           # hash draw of K6's dropout (csrc/mha_attention.cu)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got "
                         f"{rate}")


def window_attention_keep(B: int, nW: int, H: int, N: int, seed: int,
                          rate: float, device=None) -> torch.Tensor:
    """(B, nW, H, N, N) keep/(1 - rate) factors of K4's dropout."""
    rows = torch.arange(B * nW * H * N, dtype=torch.int64,
                        device=device).reshape(B, nW, H, N, 1)
    cols = torch.arange(N, dtype=torch.int64, device=device)
    return mix_keep(rows, cols, rate, seed, WINDOW_ATTN_DRAW)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor,
                        mask: Optional[torch.Tensor] = None, seed: int = 0,
                        rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T + bias[h] + mask[w]) v over (B, nW, H, N, D) windows,
    the normalised probabilities dropped by the hash mask at ``rate``.
    q arrives pre-scaled; bias is (H, N, N), mask (nW, N, N) or None."""
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    p = torch.softmax(s, dim=-1)
    if rate > 0.0:
        p = p * window_attention_keep(*q.shape[:4], seed, rate, q.device)
    return torch.einsum("bwhnm,bwhmd->bwhnd", p, v)


def attention_reference_backward(g, q, k, v, bias, mask=None, seed: int = 0,
                                 rate: float = 0.0):
    """Plain backward: autograd through the plain forward; returns
    (dq, dk, dv, dbias)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = attention_reference(*inputs, mask, seed, rate)
        return torch.autograd.grad(out, inputs, g)


def _check(q, k, v, bias, mask):
    B, nW, H, N, D = q.shape
    for name, t, shape in (("q", q, q.shape), ("k", k, q.shape),
                           ("v", v, q.shape), ("bias", bias, (H, N, N))):
        build.check_cuda_f32(name, t, shape)
    if mask is not None:
        build.check_cuda_f32("mask", mask, (nW, N, N))
    if D > 32 or 2 * N * D * 4 > 48 * 1024:
        raise ValueError(f"window attention supports head dim <= 32 and "
                         f"N*D <= 6144, got N={N}, D={D}")
    return B, nW, H, N, D


def _launch_forward(q, k, v, bias, mask, seed=0, rate=0.0):
    B, nW, H, N, D = _check(q, k, v, bias, mask)
    out = torch.empty_like(q)
    build.library().call(
        "window_attention_forward", q, k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, nW, H, N, D, int(seed), float(rate),
        build.stream_of(q))
    fused_window_attention.launches += 1
    return out


# K4 backward's scratch, one set a device (calls on a device do not overlap:
# the port runs them on one stream): the float partials of its dbias sum,
# and its counters (int32, zeroed when made, left zeroed by every call);
# the sizes of each shape, from the library
_K4_PARTS = {}
_K4_COUNTERS = {}
_K4_SIZES = {}
K4_GROUP = 16   # windows a group of K4 backward's dbias sum (WAB_G)


def _check_backward(g, q, k, v, bias, mask, out):
    """One pass over K4 backward's arguments; the reason (through
    ``build.check_cuda_f32``) only where one fails."""
    B, nW, H, N, D = shape = q.shape
    f32 = torch.float32
    if (all(t.is_cuda and t.dtype is f32 and t.is_contiguous()
            and t.shape == shape for t in (q, k, v, g, out))
            and bias.is_cuda and bias.dtype is f32 and bias.is_contiguous()
            and bias.shape == (H, N, N)
            and (mask is None or (mask.is_cuda and mask.dtype is f32
                                  and mask.is_contiguous()
                                  and mask.shape == (nW, N, N)))
            and D <= 32 and N <= 64):
        return B, nW, H, N, D
    _check(q, k, v, bias, mask)
    build.check_cuda_f32("g", g, shape)
    build.check_cuda_f32("out", out, shape)
    raise ValueError(f"window attention backward supports N <= 64 and head "
                     f"dim <= 32, got N={N}, D={D}")


def window_attention_backward(g, q, k, v, bias, mask, out, seed: int = 0,
                              rate: float = 0.0):
    """K4 backward: (dq, dk, dv, dbias). CUDA tensors launch the kernel, one
    launch a call (``out`` is the forward's output, ``seed``/``rate`` its
    dropout); dq, dk and dv are carved from one allocation, dbias is summed
    in float32 in a fixed order (:func:`window_attention_dbias_sum`). CPU
    tensors take the plain backward."""
    if q.device.type == "cpu":
        return attention_reference_backward(g, q, k, v, bias, mask, seed,
                                            rate)
    B, nW, H, N, D = _check_backward(g, q, k, v, bias, mask, out)
    sizes = _K4_SIZES.get((B, nW, H, N))
    if sizes is None:
        lib = build.library()
        sizes = _K4_SIZES[B, nW, H, N] = (
            lib.value("window_attention_backward_scratch_floats", B, nW, H,
                      N),
            lib.value("window_attention_backward_counters", B, nW, H))
    part = _K4_PARTS.get(q.device)
    if part is None or part.numel() < sizes[0]:
        part = _K4_PARTS[q.device] = torch.empty(sizes[0],
                                                 dtype=torch.float32,
                                                 device=q.device)
    count = _K4_COUNTERS.get(q.device)
    if count is None or count.numel() < sizes[1]:
        count = _K4_COUNTERS[q.device] = torch.zeros(
            sizes[1], dtype=torch.int32, device=q.device)
    dq, dk, dv = torch.empty((3,) + q.shape, dtype=torch.float32,
                             device=q.device).unbind(0)
    dbias = torch.empty_like(bias)
    build.library().call(
        "window_attention_backward", q, k.data_ptr(),
        v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr(), part.data_ptr(), count.data_ptr(), B, nW, H, N, D,
        int(seed), float(rate), build.stream_of(q))
    window_attention_backward.launches += 1
    return dq, dk, dv, dbias


def window_attention_dbias_sum(ds: torch.Tensor) -> torch.Tensor:
    """dbias from ds (B, nW, H, N, N) summed in float32 in K4 backward's
    order (tests only): the windows (b * nW + w) in groups of
    ``K4_GROUP``, each group's added in window order, the groups' sums
    added in group order."""
    B, nW, H, N, _ = ds.shape
    flat = ds.float().reshape(B * nW, H, N, N)
    groups = []
    for g0 in range(0, B * nW, K4_GROUP):
        s = flat[g0].clone()
        for b in range(g0 + 1, min(g0 + K4_GROUP, B * nW)):
            s = s + flat[b]
        groups.append(s)
    total = groups[0]
    for s in groups[1:]:
        total = total + s
    return total


class _WindowAttentionFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, rate):
        out = _window_attention(q, k, v, bias, mask, seed, rate)
        ctx.meta = (seed, rate)
        ctx.save_for_backward(q, k, v, bias, mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out = ctx.saved_tensors
        with flops.kernel("K4 window_attention backward",
                          _window_flops(q, k, backward=True)):
            dq, dk, dv, dbias = window_attention_backward(
                g.contiguous(), q, k, v, bias, mask, out, *ctx.meta)
        return dq, dk, dv, dbias, None, None, None


def _window_flops(q, k, backward: bool = False) -> int:
    B, nW, H, N, D = q.shape
    return flops.attention(B * nW, H, N, k.shape[-2], D, backward)


def _window_attention(q, k, v, bias, mask, seed, rate):
    """K4's forward: the plain version on CPU tensors, else the launch."""
    with flops.kernel("K4 window_attention", _window_flops(q, k)):
        if q.device.type == "cpu":
            return attention_reference(q, k, v, bias, mask, seed, rate)
        return _launch_forward(q, k, v, bias, mask, seed, rate)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """Window attention with probability dropout (differentiable): the CUDA
    kernels on CUDA tensors, the plain version on CPU tensors. Shapes and
    dropout as in :func:`attention_reference`. Where no gradient is asked
    for (inference, or no input requires one), the kernel launches without
    the autograd Function around it. Without dropout in a ``torch.export``
    trace: the registered op (ops/library.py)."""
    _check_rate(rate)
    if rate == 0.0 and torch.compiler.is_exporting():
        return library.in_trace("window_attention", q, k, v, bias, mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad or bias.requires_grad):
        return _WindowAttentionFunction.apply(q, k, v, bias, mask, int(seed),
                                              float(rate))
    return _window_attention(q, k, v, bias, mask, seed, rate)


fused_window_attention.launches = 0
window_attention_backward.launches = 0


# ---- K6: plain multi-head attention (the BERT layer's long route) -----------

MHA_MAX_HEAD_DIM = 64


# Both K6 forms run on the tensor cores (float32: 3xTF32; bf16: bf16 mma);
# True runs either on the CUDA cores instead (float32 FMAs, on float32 or
# bf16 storage): the precision yardstick that the card tests and
# chip_smoke.py hold the tensor-core kernels against. Its launches do not
# count on ``launches``.
_K6_SIMT = False


def mha_keep(B: int, H: int, T: int, seed: int, rate: float,
             device=None) -> torch.Tensor:
    """(B, H, T, T) keep/(1 - rate) factors of K6's dropout."""
    rows = torch.arange(B * H * T, dtype=torch.int64,
                        device=device).reshape(B, H, T, 1)
    cols = torch.arange(T, dtype=torch.int64, device=device)
    return mix_keep(rows, cols, rate, seed, MHA_DRAW)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T) v per (b, h) on (B, H, T, D), q pre-scaled, with the
    normalised probabilities dropped by the hash mask at ``rate``."""
    B, H, T, _ = q.shape
    p = torch.softmax(torch.einsum("bhtd,bhsd->bhts", q, k), dim=-1)
    if rate > 0.0:
        p = p * mha_keep(B, H, T, seed, rate, q.device)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


def mha_reference_backward(g, q, k, v, seed: int = 0, rate: float = 0.0):
    """Plain backward: autograd through the plain forward; (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = mha_reference(*inputs, seed, rate)
        return torch.autograd.grad(out, inputs, g)


def mha_reference16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """K6's bf16 form (JAX ``_make_fwd_kernel`` on bf16 inputs): bf16 q, k,
    v widened to float32, softmax, dropout and context in float32
    (:func:`mha_reference`), the output rounded to bf16 once."""
    return mha_reference(q.float(), k.float(), v.float(), seed,
                         rate).to(torch.bfloat16)


def mha_reference_backward16(g, q, k, v, seed: int = 0, rate: float = 0.0):
    """The bf16 form's plain backward (JAX ``_make_bwd_kernel`` on bf16
    inputs): bf16 dO, q, k, v widened, the float32 backward, dq, dk, dv
    rounded to bf16 once."""
    grads = mha_reference_backward(g.float(), q.float(), k.float(),
                                   v.float(), seed, rate)
    return tuple(t.to(torch.bfloat16) for t in grads)


def bf16_split(x: torch.Tensor):
    """(hi, lo), bf16: hi = bf16(x), lo = bf16(x - hi), each rounded to
    nearest, so hi + lo = x to 2^-16 |x| (exactly where x has at most 16
    significant bits). The tensor-core kernels' split of an f32 operand
    (``csrc/mha_attention.cu`` ``tc_split``)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _split_product(eq: str, x: torch.Tensor, y: torch.Tensor,
                   pieces: int) -> torch.Tensor:
    """einsum(eq, x, y) with float32 x taken as its bf16 pieces (1: bf16(x);
    2: hi + lo) and y bf16-valued: each piece's products exact in float32,
    the pieces' products summed in float32."""
    hi, lo = bf16_split(x)
    out = torch.einsum(eq, hi.float(), y)
    return out + torch.einsum(eq, lo.float(), y) if pieces == 2 else out


def _mha_split_parts(q, k, v, seed, rate, pieces):
    """(float32 out, s, log-sum-exp, keep factors or None) of the split
    model's forward, as the kernel takes it: the context of the
    unnormalised exponentials (dropped) scaled by 1 / l."""
    B, H, T, _ = q.shape
    s = torch.einsum("bhtd,bhsd->bhts", q, k)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    keep = mha_keep(B, H, T, seed, rate, q.device) if rate > 0.0 else None
    ek = e if keep is None else e * keep
    out = _split_product("bhts,bhsd->bhtd", ek, v, pieces) * (1.0 / l)
    return out, s, m + torch.log(l), keep


def mha_reference16_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          seed: int = 0, rate: float = 0.0,
                          pieces: int = 2) -> torch.Tensor:
    """A float32 model of the bf16 form's tensor-core forward, returning
    its float32 output (the kernel's out32; its bf16 out is this rounded
    once): q k^T from the bf16 values (exact products, float32 sums), the
    softmax and dropout in float32, and p v as the sum of the products of
    p's bf16 pieces (:func:`bf16_split`) with v. ``pieces=1`` takes bf16(p)
    alone, as a bf16 FlashAttention does."""
    return _mha_split_parts(q.float(), k.float(), v.float(), seed, rate,
                            pieces)[0]


def mha_reference_backward16_split(g, q, k, v, seed: int = 0,
                                   rate: float = 0.0, pieces: int = 2):
    """A float32 model of the bf16 form's tensor-core backward: (dq, dk,
    dv) in float32 (the kernels round each to bf16 once). p = exp(s -
    lse) with the forward's log-sum-exp, dO v^T from the bf16 values, delta
    = dO . out32 with out32 from :func:`mha_reference16_split`, ds = p (keep
    dP - delta); p^T dO, ds^T q and ds k each as the sum of its float32
    operand's bf16 pieces' products."""
    g, q, k, v = (t.float() for t in (g, q, k, v))
    out32, s, lse, keep = _mha_split_parts(q, k, v, seed, rate, pieces)
    p = torch.exp(s - lse)
    delta = (g * out32).sum(-1, keepdim=True)
    dp = torch.einsum("bhtd,bhsd->bhts", g, v)
    pk, ds = ((p, p * (dp - delta)) if keep is None
              else (p * keep, p * (keep * dp - delta)))
    return (_split_product("bhts,bhsd->bhtd", ds, k, pieces),
            _split_product("bhts,bhtd->bhsd", ds, q, pieces),
            _split_product("bhts,bhtd->bhsd", pk, g, pieces))


def _mha_tf32_parts(q, k, v, seed, rate):
    """(out, s, log-sum-exp, keep factors or None) of the 3xTF32 model's
    forward: s = q k^T and the context of the unnormalised exponentials
    (dropped) each a 3xTF32 product, the context scaled by 1 / l."""
    B, H, T, _ = q.shape
    s = matmul_3xtf32(q, k.transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    keep = mha_keep(B, H, T, seed, rate, q.device) if rate > 0.0 else None
    ek = e if keep is None else e * keep
    return matmul_3xtf32(ek, v) * (1.0 / l), s, m + torch.log(l), keep


def mha_reference_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """A float32 model of the float32 form's tensor-core forward (tests
    only): q k^T and p v in the arithmetic of ``ops/bert_layer.py``
    ``matmul_3xtf32`` (each operand split into TF32 big + small, the small
    terms summed apart from big times big), the online softmax's result as
    exp(s - max) / l, dropout in float32."""
    return _mha_tf32_parts(q, k, v, seed, rate)[0]


def mha_reference_backward_3xtf32(g, q, k, v, seed: int = 0,
                                  rate: float = 0.0):
    """A float32 model of the float32 form's tensor-core backward (tests
    only): (dq, dk, dv). p = exp(s - lse) from the forward's s, computed by
    the same product as the forward's (as the kernels compute it alike),
    and its log-sum-exp; delta = dO . out with the model's out; dO v^T,
    p^T dO, ds^T q and ds k each a 3xTF32 product."""
    out, s, lse, keep = _mha_tf32_parts(q, k, v, seed, rate)
    p = torch.exp(s - lse)
    delta = (g * out).sum(-1, keepdim=True)
    dp = matmul_3xtf32(g, v.transpose(-1, -2))
    pk, ds = ((p, p * (dp - delta)) if keep is None
              else (p * keep, p * (keep * dp - delta)))
    return (matmul_3xtf32(ds, k),
            matmul_3xtf32(ds.transpose(-1, -2), q),
            matmul_3xtf32(pk.transpose(-1, -2), g))


def _check_mha(q, k, v, dtype=torch.float32):
    B, H, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda(name, t, dtype, q.shape)
    if D > MHA_MAX_HEAD_DIM:
        raise ValueError(f"attention kernel supports head dim <= "
                         f"{MHA_MAX_HEAD_DIM}, got {D}")
    return B, H, T, D


def _launch_mha_forward(q, k, v, seed, rate):
    B, H, T, D = _check_mha(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    build.library().call(
        "mha_forward_simt" if _K6_SIMT else "mha_forward", q,
        k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), B * H, T,
        D, int(seed), float(rate), build.stream_of(q))
    if not _K6_SIMT:
        fused_attention.launches += 1
    return out, lse


def _launch_mha_forward16(q, k, v, seed, rate, save: bool):
    """The bf16 form's kernel: (out bf16, out32, lse), the last two float32
    and only where ``save`` (a backward follows): the backward's delta is
    taken from the float32 output, not from its bf16 rounding."""
    B, H, T, D = _check_mha(q, k, v, torch.bfloat16)
    out = torch.empty_like(q)
    out32 = lse = None
    if save:
        out32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    build.library().call(
        "mha_forward16_simt" if _K6_SIMT else "mha_forward16", q,
        k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if out32 is None else out32.data_ptr(),
        None if lse is None else lse.data_ptr(), B * H, T, D, int(seed),
        float(rate), build.stream_of(q))
    if not _K6_SIMT:
        fused_attention16.launches += 1
    return out, out32, lse


def fused_attention_backward(g, q, k, v, out, lse, seed: int = 0,
                             rate: float = 0.0):
    """K6 backward: (dq, dk, dv). CUDA tensors launch the kernels (the
    delta pass, then the key-tile and query-tile kernels; ``out`` and
    ``lse`` from the CUDA forward); CPU tensors take the plain
    backward."""
    if q.device.type == "cpu":
        return mha_reference_backward(g, q, k, v, seed, rate)
    B, H, T, D = _check_mha(q, k, v)
    build.check_cuda_f32("g", g, q.shape)
    build.check_cuda_f32("out", out, q.shape)
    build.check_cuda_f32("lse", lse, (B, H, T))
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    build.library().call(
        "mha_backward_simt" if _K6_SIMT else "mha_backward", q,
        k.data_ptr(), v.data_ptr(), out.data_ptr(), g.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        delta.data_ptr(), B * H, T, D, int(seed), float(rate),
        build.stream_of(q))
    if not _K6_SIMT:
        fused_attention_backward.launches += 1
    return dq, dk, dv


def fused_attention_backward16(g, q, k, v, out32, lse, seed: int = 0,
                               rate: float = 0.0):
    """K6's bf16 backward: bf16 (dq, dk, dv) from bf16 ``g``, q, k, v.
    CUDA tensors launch the kernels (``out32`` and ``lse``, float32, from
    the CUDA forward); CPU tensors take the plain backward."""
    if q.device.type == "cpu":
        return mha_reference_backward16(g, q, k, v, seed, rate)
    B, H, T, D = _check_mha(q, k, v, torch.bfloat16)
    build.check_cuda("g", g, torch.bfloat16, q.shape)
    build.check_cuda_f32("out32", out32, q.shape)
    build.check_cuda_f32("lse", lse, (B, H, T))
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    build.library().call(
        "mha_backward16_simt" if _K6_SIMT else "mha_backward16",
        q, k.data_ptr(), v.data_ptr(), out32.data_ptr(),
        g.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B * H, T, D, int(seed), float(rate),
        build.stream_of(q))
    if not _K6_SIMT:
        fused_attention_backward16.launches += 1
    return dq, dk, dv


class _MhaFunction(torch.autograd.Function):
    """Either form, by q's dtype: float32, or bf16 (JAX's fused_attention
    on bf16 inputs: bf16 in and out, float32 arithmetic)."""

    @staticmethod
    def forward(ctx, q, k, v, seed, rate):
        bf16 = q.dtype == torch.bfloat16
        with flops.kernel(_mha_name(q), _mha_flops(q, k)):
            if q.device.type == "cpu":
                out = (mha_reference16 if bf16 else mha_reference)(
                    q, k, v, seed, rate)
                saved = lse = None
            elif bf16:
                out, saved, lse = _launch_mha_forward16(
                    q, k, v, seed, rate, any(ctx.needs_input_grad[:3]))
            else:
                out, lse = _launch_mha_forward(q, k, v, seed, rate)
                saved = out
        ctx.meta = (seed, rate)
        ctx.save_for_backward(q, k, v, saved, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        backward = (fused_attention_backward16 if q.dtype == torch.bfloat16
                    else fused_attention_backward)
        with flops.kernel(_mha_name(q, " backward"),
                          _mha_flops(q, k, backward=True)):
            dq, dk, dv = backward(g.contiguous(), q, k, v, out, lse,
                                  *ctx.meta)
        return dq, dk, dv, None, None


def _mha_name(q, direction: str = "") -> str:
    """The kernel's name in ``ops.kernels()``."""
    return (f"K6 fused_attention{direction}"
            + (" bf16" if q.dtype == torch.bfloat16 else ""))


def _mha_flops(q, k, backward: bool = False) -> int:
    B, H, T, D = q.shape
    return flops.attention(B, H, T, k.shape[-2], D, backward)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T) v with probability dropout (differentiable): the CUDA
    kernels on CUDA tensors, the plain version on CPU tensors. Shapes and
    dropout as in :func:`mha_reference`. float32 or bf16 q, k, v (all
    three of one dtype); a bf16 call is the bf16 form
    (:func:`mha_reference16`), whose launches count on
    :func:`fused_attention16`. Without dropout in a ``torch.export``
    trace: the registered op (ops/library.py)."""
    _check_rate(rate)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if rate == 0.0 and torch.compiler.is_exporting():
        return library.in_trace("mha", q, k, v)
    return _MhaFunction.apply(q, k, v, int(seed), float(rate))


def fused_attention16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """:func:`fused_attention` on bf16 q, k, v; its ``launches`` count the
    bf16 forward kernel's launches."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the bf16 form takes bf16 q, k, v, got {q.dtype}")
    return fused_attention(q, k, v, seed, rate)


fused_attention.launches = 0
fused_attention_backward.launches = 0
fused_attention16.launches = 0
fused_attention_backward16.launches = 0
