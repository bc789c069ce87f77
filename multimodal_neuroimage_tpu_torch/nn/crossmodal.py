"""MulT-style crossmodal transformer encoder (counterpart of multimodal_neuroimage_tpu/nn/crossmodal.py).

The reference's fairseq-derived stack (modules/crossmodal_transformer.py,
multihead_attention.py, position_embedding.py), batch-first ``(B, T, D)``:

* the input scaled by sqrt(D) plus a sinusoidal table; positions run from 1
  to T, and a time step whose first feature is exactly 0 (the zero-padded
  ends of a band) gets the zero vector;
* pre-LN layers whose one LayerNorm ``layer_norms.0`` normalises the
  queries and also the keys and values, a 4x ReLU FFN, residual dropouts;
* the optional future mask: -inf above the diagonal offset by
  ``1 + |src - tgt|``;
* q scaled by ``hd ** -0.5`` after its bias, the softmax in float32 and
  the probabilities cast back to the query's dtype;
* a final LayerNorm ``layer_norm``.

Parameter names are the reference's (``layers.{i}.self_attn.in_proj_weight``,
``in_proj_bias``, ``out_proj``, ``layers.{i}.layer_norms.{0,1}``, ``fc1``,
``fc2``, ``layer_norm``). The attention is plain torch (matmul, softmax,
matmul), as the JAX module computes it outside any Pallas kernel; its
dropouts are the port's hash masks (nn/common.py ``dropout``), one seed a
site drawn from the host generator in a fixed order.

dtypes follow JAX's promotion: the sinusoidal table is float32, so
``scale * x + table`` is float32 even for a bf16 ``x`` (the bf16 policy),
and every layer after it runs in float32 on the bf16-rounded weights.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, Linear,
                                                       draw_seed, dropout)


@lru_cache(maxsize=32)
def sinusoid_table(n_positions: int, dim: int) -> np.ndarray:
    """tensor2tensor-style table ``[sin | cos]``, the frequencies dividing
    by ``half - 1``, a zero column for an odd ``dim``, row 0 zeroed (the
    padding index)."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float32)
                  * -(math.log(10000.0) / (half - 1)))
    args = np.arange(n_positions, dtype=np.float32)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n_positions, 1), np.float32)],
                               axis=1)
    table[0] = 0.0
    return table.astype(np.float32)


@lru_cache(maxsize=32)
def future_mask(tgt: int, src: int) -> np.ndarray:
    """Additive (tgt, src) mask: -inf above the diagonal offset by
    ``1 + |src - tgt|``, 0 elsewhere."""
    return np.triu(np.full((tgt, src), -np.inf, np.float32),
                   1 + abs(src - tgt))


@lru_cache(maxsize=64)
def _on_device(kind: str, a: int, b: int, device: torch.device):
    """The table of positions 1..a at width b (``"table"``) or the (a, b)
    future mask (``"mask"``) as a tensor on ``device``, copied once."""
    t = sinusoid_table(a + 1, b)[1:] if kind == "table" else future_mask(a, b)
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def positional_embedding(x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> float32 (B, T, D): positions 1..T, the zero vector where
    the first feature of ``x`` is exactly 0 (probed in ``x``'s dtype)."""
    B, T, D = x.shape
    emb = _on_device("table", T, D, x.device)
    not_pad = (x[:, :, :1] != 0)
    return torch.where(not_pad, emb[None], torch.zeros((), device=x.device))


class MultiheadAttention(nn.Module):
    """fairseq MHA: one (3E, E) in-projection, q scaled after its bias,
    float32 softmax, ``out_proj``."""

    def __init__(self, embed_dim: int, num_heads: int,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.heads = num_heads
        self.attn_dropout = attn_dropout
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query, key, value,
                attn_mask: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        E = query.shape[-1]
        hd = E // self.heads
        w = self.in_proj_weight.to(query.dtype)
        b = self.in_proj_bias.to(query.dtype)

        def proj(t, i):
            # the product, then the bias (each rounded in a bf16 stream)
            return F.linear(t, w[i * E:(i + 1) * E]) + b[i * E:(i + 1) * E]

        q = proj(query, 0) * (hd ** -0.5)
        k, v = proj(key, 1), proj(value, 2)
        B, Tq, Tk = q.shape[0], q.shape[1], k.shape[1]

        def split(t, T):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2)

        q, k, v = split(q, Tq), split(k, Tk), split(v, Tk)
        scores = torch.matmul(q, k.transpose(-1, -2)).float()
        if attn_mask is not None:
            scores = scores + attn_mask
        probs = torch.softmax(scores, dim=-1).to(query.dtype)
        if self.training and self.attn_dropout > 0.0:
            probs = dropout(probs, self.attn_dropout, draw_seed(generator))
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, Tq, E)
        return self.out_proj(ctx)


class MultEncoderLayer(nn.Module):
    """Pre-LN layer; ``layer_norms.0`` normalises q and, in crossmodal
    use, k and v too."""

    def __init__(self, embed_dim: int, num_heads: int,
                 attn_dropout: float = 0.1, relu_dropout: float = 0.1,
                 res_dropout: float = 0.1, attn_mask: bool = False):
        super().__init__()
        self.relu_dropout = relu_dropout
        self.res_dropout = res_dropout
        self.attn_mask = attn_mask
        self.self_attn = MultiheadAttention(embed_dim, num_heads,
                                            attn_dropout)
        self.layer_norms = nn.ModuleList([LayerNorm(embed_dim),
                                          LayerNorm(embed_dim)])
        self.fc1 = Linear(embed_dim, 4 * embed_dim)
        self.fc2 = Linear(4 * embed_dim, embed_dim)

    def _drop(self, x, rate, generator):
        if self.training and rate > 0.0:
            return dropout(x, rate, draw_seed(generator))
        return x

    def forward(self, x, x_k=None, x_v=None, generator=None) -> torch.Tensor:
        ln0 = self.layer_norms[0]
        xn = ln0(x)
        mask = None
        if self.attn_mask:
            src = x.shape[1] if x_k is None else x_k.shape[1]
            mask = _on_device("mask", x.shape[1], src, x.device)
        if x_k is None:
            h = self.self_attn(xn, xn, xn, mask, generator)
        else:
            h = self.self_attn(xn, ln0(x_k), ln0(x_v), mask, generator)
        x = x + self._drop(h, self.res_dropout, generator)
        h = F.relu(self.fc1(self.layer_norms[1](x)))
        h = self.fc2(self._drop(h, self.relu_dropout, generator))
        return x + self._drop(h, self.res_dropout, generator)


class MultTransformerEncoder(nn.Module):
    """The reference ``TransformerEncoder``: a self-attention stack when
    called with one input, crossmodal (q from ``x``, k and v from ``x_k``
    and ``x_v``) with three. ``x``, ``x_k`` and ``x_v`` each take their own
    embedding-dropout draw."""

    def __init__(self, embed_dim: int, num_heads: int, layers: int,
                 attn_dropout: float = 0.1, relu_dropout: float = 0.1,
                 res_dropout: float = 0.1, embed_dropout: float = 0.25,
                 attn_mask: bool = False):
        super().__init__()
        self.embed_dim = embed_dim
        self.embed_dropout = embed_dropout
        self.layers = nn.ModuleList(
            MultEncoderLayer(embed_dim, num_heads, attn_dropout, relu_dropout,
                             res_dropout, attn_mask) for _ in range(layers))
        self.layer_norm = LayerNorm(embed_dim)

    def _embed(self, x_in, generator):
        # JAX: a Python scale times a bf16 array is a bf16 product by
        # bf16(scale); the float32 table then promotes the sum to float32
        scale = math.sqrt(self.embed_dim)
        if x_in.dtype != torch.float32:
            scale = float(torch.tensor(scale).to(x_in.dtype))
        x = scale * x_in + positional_embedding(x_in)
        if self.training and self.embed_dropout > 0.0:
            x = dropout(x, self.embed_dropout, draw_seed(generator))
        return x

    def forward(self, x_in, x_in_k=None, x_in_v=None,
                generator=None) -> torch.Tensor:
        x = self._embed(x_in, generator)
        x_k = x_v = None
        if x_in_k is not None:
            x_k = self._embed(x_in_k, generator)
            x_v = self._embed(x_in_v, generator)
        for layer in self.layers:
            x = layer(x, x_k, x_v, generator)
        return self.layer_norm(x)
