"""K2/K3: the SwinFusion self and cross blocks (forward).

Counterpart of multimodal_neuroimage_tpu/ops/fusion_block.py
``fused_fusion_block`` / ``fused_cross_fusion_block``. One CUDA kernel,
templated on cross (``csrc/fusion_block.cu``), runs a whole pre-norm block per
(subject, window). ``fusion_block_reference`` and
``cross_fusion_block_reference`` are the plain PyTorch versions, which CPU
tensors take.

Layout: windows ``(B, nW, N, C)`` with N = ws*ws unpadded (the TPU's
NP = round_up(N, 8) pad is gone); bias ``(H, N, N)``; mask ``(nW, N, N)`` or
None. Params are flat tuples in the JAX kernels' order, weights in torch
``(out, in)`` layout and vectors 1-D:

  self  (12): g1 b1 wqkv bqkv wp bp g2 b2 w1 b1m w2 b2m
  cross (16): g1 b1 g1y b1y wq bq wkv bkv wp bp g2 b2 w1 b1m w2 b2m
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import layer_norm
from multimodal_neuroimage_tpu_torch.ops import build

LN_EPS = 1e-5


def bias_from_table(table: torch.Tensor, rel_idx: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(H, N, N) relative-position bias gathered from a ((2ws-1)^2, H)
    table (counterpart of ``combined_bias`` / ``packed_bias_from_table``,
    without the TPU's pad columns and head packing)."""
    N = rel_idx.shape[0]
    return table[rel_idx.reshape(-1)].reshape(N, N, heads).permute(
        2, 0, 1).contiguous()


def _attn_reference(q, k, v, bias, mask, heads: int):
    B, nW, N, C = q.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, nW, N, heads, hd).transpose(2, 3)

    s = torch.einsum("bwhnd,bwhmd->bwhnm", split(q) * hd ** -0.5,
                     split(k)) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    o = torch.einsum("bwhnm,bwhmd->bwhnd", torch.softmax(s, dim=-1),
                     split(v))
    return o.transpose(2, 3).reshape(B, nW, N, C)


def _tail_reference(x, o, wp, bp, g2, b2, w1, b1m, w2, b2m):
    x2 = x + F.linear(o, wp, bp)
    u = F.gelu(F.linear(layer_norm(x2, g2, b2, LN_EPS), w1, b1m))
    return x2 + F.linear(u, w2, b2m)


def fusion_block_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch self block over windows (inference)."""
    (g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m) = params
    qkv = F.linear(layer_norm(x, g1, b1, LN_EPS), wqkv, bqkv)
    q, k, v = qkv.chunk(3, dim=-1)
    o = _attn_reference(q, k, v, bias, mask, bias.shape[0])
    return _tail_reference(x, o, wp, bp, g2, b2, w1, b1m, w2, b2m)


def cross_fusion_block_reference(x: torch.Tensor, y: torch.Tensor,
                                 params: Sequence[torch.Tensor],
                                 bias: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch directed cross block: q from LN1(x), k/v from
    LN1_y(y); returns the updated x stream."""
    (g1, b1, g1y, b1y, wq, bq, wkv, bkv,
     wp, bp, g2, b2, w1, b1m, w2, b2m) = params
    q = F.linear(layer_norm(x, g1, b1, LN_EPS), wq, bq)
    k, v = F.linear(layer_norm(y, g1y, b1y, LN_EPS), wkv, bkv).chunk(2, -1)
    o = _attn_reference(q, k, v, bias, mask, bias.shape[0])
    return _tail_reference(x, o, wp, bp, g2, b2, w1, b1m, w2, b2m)


def _launch(x, y, params, bias, mask, cross: bool) -> torch.Tensor:
    B, nW, N, C = x.shape
    H = bias.shape[0]
    Ch = params[-4].shape[0]
    build.check_cuda_f32("x", x, (B, nW, N, C))
    if cross:
        build.check_cuda_f32("y", y, (B, nW, N, C))
    build.check_cuda_f32("bias", bias, (H, N, N))
    if mask is not None:
        build.check_cuda_f32("mask", mask, (nW, N, N))
    if C % H or C // H > 16:
        raise ValueError(f"fusion block needs C % heads == 0 and head dim "
                         f"<= 16, got C={C}, heads={H}")
    vec, mat = (lambda n: (n,)), (lambda o, i: (o, i))
    qkv = ([vec(C), vec(C), mat(C, C), vec(C), mat(2 * C, C), vec(2 * C)]
           if cross else [mat(3 * C, C), vec(3 * C)])
    shapes = ([vec(C), vec(C)] + qkv
              + [mat(C, C), vec(C), vec(C), vec(C),
                 mat(Ch, C), vec(Ch), mat(C, Ch), vec(C)])
    if len(params) != len(shapes):
        raise ValueError(f"expected {len(shapes)} params, got {len(params)}")
    for i, (p, s) in enumerate(zip(params, shapes)):
        build.check_cuda_f32(f"params[{i}]", p, s)
    out = torch.empty_like(x)
    build.library().call(
        "fusion_block_forward", int(cross), x.data_ptr(),
        y.data_ptr() if cross else None, build.pointer_array(params),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, nW, N, C, H, Ch, build.stream_of(x))
    return out


def fused_fusion_block(x: torch.Tensor, params: Sequence[torch.Tensor],
                       bias: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self block: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if x.device.type == "cpu":
        return fusion_block_reference(x, params, bias, mask)
    out = _launch(x, None, params, bias, mask, cross=False)
    fused_fusion_block.launches += 1
    return out


def fused_cross_fusion_block(x: torch.Tensor, y: torch.Tensor,
                             params: Sequence[torch.Tensor],
                             bias: torch.Tensor,
                             mask: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Directed cross block (q from x, k/v from y): the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return cross_fusion_block_reference(x, y, params, bias, mask)
    out = _launch(x, y, params, bias, mask, cross=True)
    fused_cross_fusion_block.launches += 1
    return out


fused_fusion_block.launches = 0
fused_cross_fusion_block.launches = 0
