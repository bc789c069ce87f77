"""K4 (bias-and-mask window attention) and K6 (plain multi-head attention
over long sequences), each forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/attention.py
``fused_window_attention`` (``_fab_fwd`` / ``_fab_bwd``) and
``fused_attention`` (``_fused_fwd`` / ``_fused_bwd``). The CUDA kernels are
``csrc/window_attention.cu`` and ``csrc/mha_attention.cu``; the autograd
Function around each runs its kernels on CUDA tensors and its plain version
(and autograd through it) on CPU tensors. K4 has no dropout: the flagship's
SwinV2 head runs ``attn_drop_rate`` 0, and a caller that asks for more is
refused (nn/swin2d.py, ROADMAP "K4 dropout"). K6 drops normalised
probabilities with the port's coordinate hash at row ``(b * H + h) * T +
i``, column ``j``, draw ``MHA_DRAW``; the JAX kernel draws from the TPU's
PRNG instead, so the two agree only at rate 0.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_neuroimage_tpu_torch.ops import build
from multimodal_neuroimage_tpu_torch.ops.fusion_block import mix_keep


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T + bias[h] + mask[w]) v over (B, nW, H, N, D) windows.
    q arrives pre-scaled; bias is (H, N, N), mask (nW, N, N) or None."""
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    return torch.einsum("bwhnm,bwhmd->bwhnd", torch.softmax(s, dim=-1), v)


def attention_reference_backward(g, q, k, v, bias, mask=None):
    """Plain backward: autograd through the plain forward; returns
    (dq, dk, dv, dbias)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = attention_reference(*inputs, mask)
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


def _launch_forward(q, k, v, bias, mask):
    B, nW, H, N, D = _check(q, k, v, bias, mask)
    out = torch.empty_like(q)
    build.library().call(
        "window_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, nW, H, N, D, build.stream_of(q))
    fused_window_attention.launches += 1
    return out


def window_attention_backward(g, q, k, v, bias, mask, out):
    """K4 backward: (dq, dk, dv, dbias). CUDA tensors launch the kernel
    (``out`` is the forward's output); CPU tensors take the plain
    backward."""
    if q.device.type == "cpu":
        return attention_reference_backward(g, q, k, v, bias, mask)
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
             dbias.data_ptr(), scratch.data_ptr(), B, nW, H, N, D,
             build.stream_of(q))
    window_attention_backward.launches += 1
    return dq, dk, dv, dbias


class _WindowAttentionFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, bias, mask):
        out = (attention_reference(q, k, v, bias, mask)
               if q.device.type == "cpu"
               else _launch_forward(q, k, v, bias, mask))
        ctx.save_for_backward(q, k, v, bias, mask, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, mask, out = ctx.saved_tensors
        dq, dk, dv, dbias = window_attention_backward(g.contiguous(), q, k,
                                                      v, bias, mask, out)
        return dq, dk, dv, dbias, None


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Window attention (differentiable): the CUDA kernels on CUDA tensors,
    the plain version on CPU tensors. Shapes as in
    :func:`attention_reference`."""
    return _WindowAttentionFunction.apply(q, k, v, bias, mask)


fused_window_attention.launches = 0
window_attention_backward.launches = 0


# ---- K6: plain multi-head attention (the BERT layer's long route) -----------

MHA_DRAW = 4      # hash draw of K6's dropout (csrc/mha_attention.cu MHA_DRAW)
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
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"attention dropout rate must be in [0, 1), got "
                         f"{rate}")
    return _MhaFunction.apply(q, k, v, int(seed), float(rate))


fused_attention.launches = 0
fused_attention_backward.launches = 0
