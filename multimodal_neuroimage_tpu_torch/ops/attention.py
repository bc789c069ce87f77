"""K4: bias-and-mask window attention (forward).

Counterpart of multimodal_neuroimage_tpu/ops/attention.py
``fused_window_attention``. The CUDA kernel is ``csrc/window_attention.cu``;
``attention_reference`` is its plain PyTorch version, which CPU tensors take.
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


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Window attention: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor. Shapes as in :func:`attention_reference`."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, mask)
    B, nW, H, N, D = q.shape
    for name, t, shape in (("q", q, q.shape), ("k", k, q.shape),
                           ("v", v, q.shape), ("bias", bias, (H, N, N))):
        build.check_cuda_f32(name, t, shape)
    if mask is not None:
        build.check_cuda_f32("mask", mask, (nW, N, N))
    if D > 32 or 2 * N * D * 4 > 48 * 1024:
        raise ValueError(f"window attention supports head dim <= 32 and "
                         f"N*D <= 6144, got N={N}, D={D}")
    out = torch.empty_like(q)
    build.library().call(
        "window_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, nW, H, N, D, build.stream_of(q))
    fused_window_attention.launches += 1
    return out


fused_window_attention.launches = 0
