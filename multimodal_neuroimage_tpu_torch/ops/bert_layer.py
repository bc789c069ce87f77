"""K1: one HF post-LN BERT layer, forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/bert_layer.py
``bert_layer_call``. The CUDA kernels are ``csrc/bert_layer.cu``; the
autograd Function around them runs them on CUDA tensors and
``bert_layer_reference`` (and its autograd) on CPU tensors.

x is ``(B, T, H)``; T needs no padding: keys at positions >= ``t_valid`` are
masked out of attention (the TPU kernel's pad keys). Params are the
16-tuple ``wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2`` with weights
in torch ``(out, in)`` layout and vectors 1-D. Training adds an int32
``seed`` and ``rates`` = (attention, hidden) dropout, whose masks are the JAX
kernel's coordinate hash over its padded rows (TP = round_up(T, 8) a
subject).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import layer_norm
from multimodal_neuroimage_tpu_torch.ops import build
from multimodal_neuroimage_tpu_torch.ops.fusion_block import (mix_keep,
                                                              round_up)

LN_EPS = 1e-12
N_PARAMS = 16


def _rows(B: int, T: int, device) -> torch.Tensor:
    """(B, T, 1) padded dropout row b * TP + t of every token."""
    TP = round_up(T, 8)
    return (torch.arange(B, dtype=torch.int64, device=device)[:, None, None]
            * TP + torch.arange(T, dtype=torch.int64, device=device)[None, :,
                                                                      None])


def bert_layer_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                         heads: int, t_valid: int, seed: int = 0,
                         rates: Tuple[float, float] = (0.0, 0.0),
                         training: bool = False) -> torch.Tensor:
    """Plain PyTorch BERT layer over the same params (``_fwd_parts``)."""
    (wq, bq, wk, bk, wv, bv, wo, bo, g1, b1,
     w1, b1m, w2, b2m, g2, b2) = params
    B, T, H = x.shape
    hd = H // heads
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    TP = round_up(T, 8)
    rows = _rows(B, T, x.device)

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    q = split(F.linear(x, wq, bq)) * hd ** -0.5
    s = torch.einsum("bhtd,bhsd->bhts", q, split(F.linear(x, wk, bk)))
    s = s.masked_fill(torch.arange(T, device=x.device) >= t_valid, -1e9)
    p = torch.softmax(s, dim=-1)
    if attn_rate > 0.0:
        cols = (torch.arange(heads, device=x.device)[:, None, None] * TP
                + torch.arange(T, device=x.device))          # (heads, 1, T)
        p = p * mix_keep(rows[:, None], cols, attn_rate, seed, 3)
    ctx = torch.einsum("bhts,bhsd->bhtd", p, split(F.linear(x, wv, bv)))
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    a = F.linear(ctx, wo, bo)
    if hidden_rate > 0.0:
        a = a * mix_keep(rows, torch.arange(H, device=x.device), hidden_rate,
                         seed, 0)
    x1 = layer_norm(a + x, g1, b1, LN_EPS)
    z = F.linear(F.gelu(F.linear(x1, w1, b1m)), w2, b2m)
    if hidden_rate > 0.0:
        z = z * mix_keep(rows, torch.arange(H, device=x.device), hidden_rate,
                         seed, 1)
    return layer_norm(z + x1, g2, b2, LN_EPS)


def bert_layer_reference_backward(g, x, params, heads: int, t_valid: int,
                                  seed: int = 0, rates=(0.0, 0.0),
                                  training: bool = False):
    """Plain backward: autograd through the plain forward; returns
    (dx, dparams)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_()] + [
            p.detach().requires_grad_() for p in params]
        out = bert_layer_reference(inputs[0], inputs[1:], heads, t_valid,
                                   seed, rates, training)
        grads = torch.autograd.grad(out, inputs, g)
    return grads[0], tuple(grads[1:])


def _check(x, params, heads, t_valid):
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
    return B, T, H, F_


def _launch_forward(x, params, heads, t_valid, seed, rates, training,
                    save: bool):
    B, T, H, F_ = _check(x, params, heads, t_valid)
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    lib = build.library()
    scratch = torch.empty(lib.value("bert_layer_scratch_floats", B, T, H, F_),
                          dtype=torch.float32, device=x.device)
    resid = (torch.empty(lib.value("bert_layer_resid_floats", B, T, H, heads),
                         dtype=torch.float32, device=x.device)
             if save else None)
    out = torch.empty_like(x)
    lib.call("bert_layer_forward", x.data_ptr(), build.pointer_array(params),
             scratch.data_ptr(), None if resid is None else resid.data_ptr(),
             out.data_ptr(), B, T, H, F_, heads, t_valid, round_up(T, 8),
             int(seed), float(attn_rate), float(hidden_rate),
             build.stream_of(x))
    bert_layer_call.launches += 1
    return out, resid


def bert_layer_backward(g, x, params, resid, heads: int, t_valid: int,
                        seed: int = 0, rates=(0.0, 0.0),
                        training: bool = False):
    """K1 backward: (dx, dparams). CUDA tensors launch the kernels
    (``resid`` from the CUDA training forward); CPU tensors take the plain
    backward."""
    if x.device.type == "cpu":
        return bert_layer_reference_backward(g, x, params, heads, t_valid,
                                             seed, rates, training)
    B, T, H, F_ = _check(x, params, heads, t_valid)
    build.check_cuda_f32("g", g, x.shape)
    lib = build.library()
    build.check_cuda_f32("resid", resid, (lib.value(
        "bert_layer_resid_floats", B, T, H, heads),))
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    scratch = torch.empty(lib.value("bert_layer_backward_scratch_floats",
                                    B, T, H, F_, heads),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dparams = tuple(torch.empty_like(p) for p in params)
    lib.call("bert_layer_backward", x.data_ptr(), resid.data_ptr(),
             g.data_ptr(), build.pointer_array(params),
             build.pointer_array(dparams), dx.data_ptr(), scratch.data_ptr(),
             B, T, H, F_, heads, t_valid, round_up(T, 8), int(seed),
             float(attn_rate), float(hidden_rate), build.stream_of(x))
    bert_layer_backward.launches += 1
    return dx, dparams


class _BertLayerFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, heads, t_valid, seed, rates, training, save, *params):
        if x.device.type == "cpu":
            out = bert_layer_reference(x, params, heads, t_valid, seed, rates,
                                       training)
            resid = None
        else:
            out, resid = _launch_forward(x, params, heads, t_valid, seed,
                                         rates, training, save)
        ctx.meta = (heads, t_valid, seed, rates, training)
        ctx.save_for_backward(x, resid, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, t_valid, seed, rates, training = ctx.meta
        x, resid, *params = ctx.saved_tensors
        dx, dparams = bert_layer_backward(g.contiguous(), x, params, resid,
                                          heads, t_valid, seed, rates,
                                          training)
        return (dx, None, None, None, None, None, None, *dparams)


def bert_layer_call(x: torch.Tensor, params: Sequence[torch.Tensor],
                    heads: int, t_valid: int, seed: int = 0,
                    rates: Tuple[float, float] = (0.0, 0.0),
                    training: bool = False) -> torch.Tensor:
    """One BERT layer (differentiable): the CUDA kernels on a CUDA tensor,
    the plain version on a CPU tensor."""
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params))
    return _BertLayerFunction.apply(x, heads, t_valid, int(seed),
                                    tuple(rates), bool(training), save,
                                    *params)


bert_layer_call.launches = 0
bert_layer_backward.launches = 0
