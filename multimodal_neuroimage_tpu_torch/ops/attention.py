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

from multimodal_neuroimage_tpu_torch.ops import build
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
        "window_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, nW, H, N, D, int(seed), float(rate),
        build.stream_of(q))
    fused_window_attention.launches += 1
    return out


def window_attention_backward(g, q, k, v, bias, mask, out, seed: int = 0,
                              rate: float = 0.0):
    """K4 backward: (dq, dk, dv, dbias). CUDA tensors launch the kernel
    (``out`` is the forward's output, ``seed``/``rate`` its dropout); CPU
    tensors take the plain backward."""
    if q.device.type == "cpu":
        return attention_reference_backward(g, q, k, v, bias, mask, seed,
                                            rate)
    B, nW, H, N, D = _check(q, k, v, bias, mask)
    build.check_cuda_f32("g", g, q.shape)
    build.check_cuda_f32("out", out, q.shape)
    if N > 64:
        raise ValueError(f"window attention backward supports N <= 64, "
                         f"got {N}")
    lib = build.library()
    scratch = torch.empty(lib.value("window_attention_backward_scratch_floats",
                                    B, nW, H, N),
                          dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    lib.call("window_attention_backward", q.data_ptr(), k.data_ptr(),
             v.data_ptr(), bias.data_ptr(),
             None if mask is None else mask.data_ptr(), out.data_ptr(),
             g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dbias.data_ptr(), scratch.data_ptr(), B, nW, H, N, D, int(seed),
             float(rate), build.stream_of(q))
    window_attention_backward.launches += 1
    return dq, dk, dv, dbias


class _WindowAttentionFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, seed, rate):
        out = (attention_reference(q, k, v, bias, mask, seed, rate)
               if q.device.type == "cpu"
               else _launch_forward(q, k, v, bias, mask, seed, rate))
        ctx.meta = (seed, rate)
        ctx.save_for_backward(q, k, v, bias, mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_backward(
            g.contiguous(), q, k, v, bias, mask, out, *ctx.meta)
        return dq, dk, dv, dbias, None, None, None


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """Window attention with probability dropout (differentiable): the CUDA
    kernels on CUDA tensors, the plain version on CPU tensors. Shapes and
    dropout as in :func:`attention_reference`. Where no gradient is asked
    for (inference, or no input requires one), the kernel launches without
    the autograd Function around it."""
    _check_rate(rate)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad or bias.requires_grad):
        return _WindowAttentionFunction.apply(q, k, v, bias, mask, int(seed),
                                              float(rate))
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, mask, seed, rate)
    return _launch_forward(q, k, v, bias, mask, seed, rate)


fused_window_attention.launches = 0
window_attention_backward.launches = 0


# ---- K6: plain multi-head attention (the BERT layer's long route) -----------

MHA_MAX_HEAD_DIM = 64


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T) v per (b, h) on (B, H, T, D), q pre-scaled, with the
    normalised probabilities dropped by the hash mask at ``rate``."""
    B, H, T, _ = q.shape
    p = torch.softmax(torch.einsum("bhtd,bhsd->bhts", q, k), dim=-1)
    if rate > 0.0:
        rows = torch.arange(B * H * T, dtype=torch.int64,
                            device=q.device).reshape(B, H, T, 1)
        cols = torch.arange(T, dtype=torch.int64, device=q.device)
        p = p * mix_keep(rows, cols, rate, seed, MHA_DRAW)
    return torch.einsum("bhts,bhsd->bhtd", p, v)


def mha_reference_backward(g, q, k, v, seed: int = 0, rate: float = 0.0):
    """Plain backward: autograd through the plain forward; (dq, dk, dv)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = mha_reference(*inputs, seed, rate)
        return torch.autograd.grad(out, inputs, g)


def _check_mha(q, k, v):
    B, H, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_cuda_f32(name, t, q.shape)
    if D > MHA_MAX_HEAD_DIM:
        raise ValueError(f"attention kernel supports head dim <= "
                         f"{MHA_MAX_HEAD_DIM}, got {D}")
    return B, H, T, D


def _launch_mha_forward(q, k, v, seed, rate):
    B, H, T, D = _check_mha(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    build.library().call("mha_forward", q.data_ptr(), k.data_ptr(),
                         v.data_ptr(), out.data_ptr(), lse.data_ptr(), B * H,
                         T, D, int(seed), float(rate), build.stream_of(q))
    fused_attention.launches += 1
    return out, lse


def fused_attention_backward(g, q, k, v, out, lse, seed: int = 0,
                             rate: float = 0.0):
    """K6 backward: (dq, dk, dv). CUDA tensors launch the kernels (``out``
    and ``lse`` from the CUDA forward); CPU tensors take the plain
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
        "mha_backward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), g.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), B * H, T, D,
        int(seed), float(rate), build.stream_of(q))
    fused_attention_backward.launches += 1
    return dq, dk, dv


class _MhaFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, seed, rate):
        if q.device.type == "cpu":
            out, lse = mha_reference(q, k, v, seed, rate), None
        else:
            out, lse = _launch_mha_forward(q, k, v, seed, rate)
        ctx.meta = (seed, rate)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_backward(g.contiguous(), q, k, v, out,
                                              lse, *ctx.meta)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    seed: int = 0, rate: float = 0.0) -> torch.Tensor:
    """softmax(q k^T) v with probability dropout (differentiable): the CUDA
    kernels on CUDA tensors, the plain version on CPU tensors. Shapes and
    dropout as in :func:`mha_reference`."""
    _check_rate(rate)
    return _MhaFunction.apply(q, k, v, int(seed), float(rate))


fused_attention.launches = 0
fused_attention_backward.launches = 0
