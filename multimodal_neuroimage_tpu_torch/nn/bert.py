"""Temporal BERT over fMRI ROI time series (counterpart of multimodal_neuroimage_tpu/nn/bert.py).

``transformers.BertModel`` semantics driven by ``inputs_embeds``: learned
absolute position embeddings plus one token-type row, embedding LayerNorm
(eps 1e-12) and dropout, post-LN layers with erf-GELU, and the tanh pooler
on token 0. Parameter names follow HuggingFace
(``encoder.layer.{i}.attention.self.query``, ...).

The encoder picks each layer's route from T as the JAX package does on the
TPU: while ``round_up(T, 8) <= 640`` every layer body is one K1 call
(ops/bert_layer.py), with one dropout seed drawn per layer; above that (HCP:
T = 1201) the (T, T) scores outgrow the K1 kernel, and the layer runs its
dense products, LayerNorms and GELU in plain torch around K6
(ops/attention.py ``fused_attention``), drawing three seeds per layer: K6's
attention dropout, then the two hidden-dropout sites (JAX: one ``dropout``
rng split per scanned layer).

Under the bf16 policy (parameters rounded to bf16, bf16 inputs; the step
builders') the embeddings, the CLS projection and the pooler run in bf16,
while the K1 stack runs on a float32 residual stream with its products in
bf16 (K1's mm16 form), the output cast back to bf16: JAX nn/bert.py:34-42,
214-220 (full bf16 streams did not train at depth 16). The K6 route keeps
its bf16 stream, as JAX does (only the K1 route switches to float32): K6's
bf16 form, and every operation around it rounded to bf16 where JAX's plain
layer body rounds it (:meth:`BertLayer._attention_route`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, Linear,
                                                       draw_seed, dropout)
from multimodal_neuroimage_tpu_torch.ops.attention import fused_attention
from multimodal_neuroimage_tpu_torch.ops.bert_layer import bert_layer_call
from multimodal_neuroimage_tpu_torch.ops.fusion_block import round_up

LN_EPS = 1e-12
K1_MAX_T = 640    # padded T above this takes the K6 route (JAX nn/bert.py:209)


class BertLayer(nn.Module):
    """One HF post-LN BERT layer."""

    def __init__(self, hidden: int, heads: int, intermediate: int = 3072,
                 attn_dropout: float = 0.1, hidden_dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.rates = (attn_dropout, hidden_dropout)
        lin = lambda i, o: Linear(i, o)
        self.attention = nn.ModuleDict({
            "self": nn.ModuleDict({"query": lin(hidden, hidden),
                                   "key": lin(hidden, hidden),
                                   "value": lin(hidden, hidden)}),
            "output": nn.ModuleDict({"dense": lin(hidden, hidden),
                                     "LayerNorm": LayerNorm(hidden, LN_EPS)})})
        self.intermediate = nn.ModuleDict({"dense": lin(hidden, intermediate)})
        self.output = nn.ModuleDict({"dense": lin(intermediate, hidden),
                                     "LayerNorm": LayerNorm(hidden, LN_EPS)})

    def kernel_params(self):
        sa, ao = self.attention["self"], self.attention["output"]
        inter, out = self.intermediate["dense"], self.output
        return (sa["query"].weight, sa["query"].bias, sa["key"].weight,
                sa["key"].bias, sa["value"].weight, sa["value"].bias,
                ao["dense"].weight, ao["dense"].bias, ao["LayerNorm"].weight,
                ao["LayerNorm"].bias, inter.weight, inter.bias,
                out["dense"].weight, out["dense"].bias,
                out["LayerNorm"].weight, out["LayerNorm"].bias)

    def forward(self, x: torch.Tensor, t_valid: Optional[int],
                generator=None, mm16: bool = False) -> torch.Tensor:
        """K1 over keys < ``t_valid`` (``mm16``: its bf16-product form); the
        K6 route when it is None."""
        if t_valid is None:
            return self._attention_route(x, generator)
        seed = 0
        if self.training and max(self.rates) > 0.0:
            seed = draw_seed(generator)
        return bert_layer_call(x, self.kernel_params(), self.heads, t_valid,
                               seed, self.rates, self.training, mm16)

    def _attention_route(self, x: torch.Tensor, generator) -> torch.Tensor:
        """The JAX BertLayer's plain body with K6 as its attention
        (JAX nn/bert.py:103-147): no key mask, no padding. A bf16 stream
        (the bf16 policy) rounds where that body does under Flax's
        promotion: each Dense's product and its bias add (``Linear``), the
        query scale (a bf16 division by bf16(sqrt(hd))), K6's output, the
        residual adds, each post-LN's normalisation, its scale and its
        shift (:func:`_post_ln`), and each operation of the erf-GELU
        (:func:`_gelu16`)."""
        B, T, H = x.shape
        hd = H // self.heads
        attn_rate, hidden_rate = self.rates if self.training else (0.0, 0.0)
        sa, ao = self.attention["self"], self.attention["output"]

        def split(t):
            return t.reshape(B, T, self.heads, hd).transpose(1, 2).contiguous()

        if x.dtype == torch.float32:
            q = split(sa["query"](x)) / math.sqrt(hd)
        else:
            # q / jnp.sqrt(jnp.asarray(hd, q.dtype)): the root rounded to
            # bf16 (3.3125 for hd 11), the quotient rounded
            q = split(sa["query"](x)) / _rounded(math.sqrt(hd), x.dtype)
        k, v = split(sa["key"](x)), split(sa["value"](x))
        seed = draw_seed(generator) if attn_rate > 0.0 else 0
        ctx = fused_attention(q, k, v, seed, attn_rate)
        a = ao["dense"](ctx.transpose(1, 2).reshape(B, T, H))
        if hidden_rate > 0.0:
            a = dropout(a, hidden_rate, draw_seed(generator))
        x = _post_ln(ao["LayerNorm"], a + x)
        u = self.intermediate["dense"](x)
        z = self.output["dense"](F.gelu(u) if u.dtype == torch.float32
                                 else _gelu16(u))
        if hidden_rate > 0.0:
            z = dropout(z, hidden_rate, draw_seed(generator))
        return _post_ln(self.output["LayerNorm"], z + x)


def _post_ln(ln: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The K6 route's post-LN. float32: ``ln`` itself. bf16: JAX's
    ``LayerNorm(use_scale=False, use_bias=False)(x) * g + b``: statistics
    and normalisation in float32, rounded to bf16, then the scale and the
    shift each a bf16 operation of its own."""
    if x.dtype == torch.float32:
        return ln(x)
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + ln.eps)).to(x.dtype)
    return y * ln.weight.to(x.dtype) + ln.bias.to(x.dtype)


def _gelu16(u: torch.Tensor) -> torch.Tensor:
    """The erf-GELU of a bf16 tensor as ``jax.nn.gelu(approximate=False)``
    computes it in bf16: ``0.5 * u * erfc(-u * bf16(sqrt(0.5)))``, each
    operation rounded to bf16 (torch's bf16 GELU rounds once)."""
    return 0.5 * u * torch.special.erfc(-u * _rounded(math.sqrt(0.5),
                                                      u.dtype))


def _rounded(c: float, dtype: torch.dtype) -> float:
    """The constant ``c`` rounded to ``dtype`` (an operand of a bf16
    operation: torch computes a bf16 op with a float scalar in float32 and
    rounds the result once, as the bf16 op of two bf16 values)."""
    return float(torch.tensor(c).to(dtype))


class BertEncoder(nn.Module):
    """Embeddings + ``layers`` BertLayers + tanh pooler."""

    def __init__(self, hidden: int, layers: int, heads: int,
                 max_positions: int, intermediate: int = 3072,
                 hidden_dropout: float = 0.1, attn_dropout: float = 0.1):
        super().__init__()
        self.hidden_dropout = hidden_dropout
        self.embeddings = nn.ModuleDict({
            "position_embeddings": nn.Embedding(max_positions, hidden),
            "token_type_embeddings": nn.Embedding(1, hidden),
            "LayerNorm": LayerNorm(hidden, LN_EPS)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(
            BertLayer(hidden, heads, intermediate, attn_dropout,
                      hidden_dropout) for _ in range(layers))})
        self.pooler = nn.ModuleDict({"dense": Linear(hidden, hidden)})

    def forward(self, inputs_embeds: torch.Tensor, generator=None):
        T = inputs_embeds.shape[1]
        emb = self.embeddings
        dt = inputs_embeds.dtype
        x = (inputs_embeds + emb["position_embeddings"].weight[None, :T].to(dt)
             + emb["token_type_embeddings"].weight[None].to(dt))
        x = emb["LayerNorm"](x)
        if self.training and self.hidden_dropout > 0.0:
            x = dropout(x, self.hidden_dropout, draw_seed(generator))
        x = x.contiguous()
        t_valid = T if round_up(T, 8) <= K1_MAX_T else None
        # the bf16 policy: a float32 stream through the K1 stack, products
        # in bf16 (mm16), the output cast back (JAX nn/bert.py:214-220)
        in_dtype = x.dtype
        mm16 = t_valid is not None and in_dtype == torch.bfloat16
        if mm16:
            x = x.float()
        for layer in self.encoder["layer"]:
            x = layer(x, t_valid, generator, mm16)
        x = x.to(in_dtype)
        return x, torch.tanh(self.pooler["dense"](x[:, 0]))


class TemporalBert(nn.Module):
    """A learnable CLS token (Linear + LeakyReLU of a constant 0.5 vector)
    prepended to the series, then the BERT encoder. Returns the per-step
    sequence (CLS stripped) and the pooled CLS."""

    def __init__(self, hidden: int, layers: int, heads: int,
                 max_positions: int, intermediate: int = 3072,
                 hidden_dropout: float = 0.1, attn_dropout: float = 0.1):
        super().__init__()
        self.hidden = hidden
        self.cls_embedding = nn.Sequential(Linear(hidden, hidden),
                                           nn.LeakyReLU())
        self.bert = BertEncoder(hidden, layers, heads, max_positions,
                                intermediate, hidden_dropout, attn_dropout)

    def forward(self, x: torch.Tensor, generator=None):
        if x.dim() != 3:
            # JAX's concatenate of the CLS step raises TypeError here (a
            # 4-D fMRI_image volume, phase 1 on that dataset)
            raise TypeError(f"the temporal BERT takes (B, T, H) series, got "
                            f"shape {tuple(x.shape)}")
        cls_const = torch.full((x.shape[0], 1, self.hidden), 0.5,
                               dtype=x.dtype, device=x.device)
        seq = torch.cat([self.cls_embedding(cls_const), x], dim=1)
        seq_out, pooled = self.bert(seq, generator)
        return {"sequence": seq_out[:, 1:], "cls": pooled}
