"""K4: bias-and-mask window attention, forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/attention.py
``fused_window_attention`` (``_fab_fwd`` / ``_fab_bwd``). The CUDA kernels
are ``csrc/window_attention.cu``; the autograd Function around them runs
them on CUDA tensors and ``attention_reference`` (and its autograd) on CPU
tensors. The kernels have no dropout: the flagship's SwinV2 head runs
``attn_drop_rate`` 0, and a caller that asks for more is refused
(nn/swin2d.py, ROADMAP "K4 dropout").
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_neuroimage_tpu_torch.ops import build


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
