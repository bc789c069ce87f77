"""K1: one HF post-LN BERT layer (forward).

Counterpart of multimodal_neuroimage_tpu/ops/bert_layer.py
``bert_layer_call``. The CUDA kernels are ``csrc/bert_layer.cu`` (QKV,
attention, out-projection + LN1, chunked FFN + LN2); ``bert_layer_reference``
is the plain PyTorch version, which CPU tensors take.

x is ``(B, T, H)``; T needs no padding: keys at positions >= ``t_valid`` are
masked out of attention (the TPU kernel's pad keys). Params are the
16-tuple ``wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2`` with weights
in torch ``(out, in)`` layout and vectors 1-D.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import layer_norm
from multimodal_neuroimage_tpu_torch.ops import build

LN_EPS = 1e-12
N_PARAMS = 16


def bert_layer_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                         heads: int, t_valid: int) -> torch.Tensor:
    """Plain PyTorch BERT layer (inference) over the same params."""
    (wq, bq, wk, bk, wv, bv, wo, bo, g1, b1,
     w1, b1m, w2, b2m, g2, b2) = params
    B, T, H = x.shape
    hd = H // heads

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    q = split(F.linear(x, wq, bq)) * hd ** -0.5
    s = torch.einsum("bhtd,bhsd->bhts", q, split(F.linear(x, wk, bk)))
    s = s.masked_fill(torch.arange(T, device=x.device) >= t_valid, -1e9)
    ctx = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1),
                       split(F.linear(x, wv, bv)))
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    x1 = layer_norm(F.linear(ctx, wo, bo) + x, g1, b1, LN_EPS)
    z = F.linear(F.gelu(F.linear(x1, w1, b1m)), w2, b2m)
    return layer_norm(z + x1, g2, b2, LN_EPS)


def bert_layer_call(x: torch.Tensor, params: Sequence[torch.Tensor],
                    heads: int, t_valid: int) -> torch.Tensor:
    """One BERT layer: the CUDA kernels on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return bert_layer_reference(x, params, heads, t_valid)
    B, T, H = x.shape
    F_ = params[10].shape[0]
    build.check_cuda_f32("x", x, (B, T, H))
    if len(params) != N_PARAMS:
        raise ValueError(f"expected {N_PARAMS} params, got {len(params)}")
    shapes = ([(H, H), (H,)] * 4 + [(H,), (H,), (F_, H), (F_,),
                                    (H, F_), (H,), (H,), (H,)])
    for i, (p, s) in enumerate(zip(params, shapes)):
        build.check_cuda_f32(f"params[{i}]", p, s)
    if (H > 96 or H % heads or H // heads > 16 or F_ % 32
            or not 1 <= t_valid <= T):
        raise ValueError(f"BERT kernel needs H <= 96, head dim <= 16, "
                         f"F % 32 == 0 and 1 <= t_valid <= T; got H={H}, "
                         f"heads={heads}, F={F_}, t_valid={t_valid}, T={T}")
    lib = build.library()
    scratch = torch.empty(lib.value("bert_layer_scratch_floats", B, T, H, F_),
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib.call("bert_layer_forward", x.data_ptr(), build.pointer_array(params),
             scratch.data_ptr(), out.data_ptr(), B, T, H, F_, heads, t_valid,
             build.stream_of(x))
    bert_layer_call.launches += 1
    return out


bert_layer_call.launches = 0
