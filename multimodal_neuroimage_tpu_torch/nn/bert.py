"""Temporal BERT over fMRI ROI time series (counterpart of multimodal_neuroimage_tpu/nn/bert.py).

``transformers.BertModel`` semantics driven by ``inputs_embeds``: learned
absolute position embeddings plus one token-type row, embedding LayerNorm
(eps 1e-12) and dropout, post-LN layers with erf-GELU, and the tanh pooler
on token 0. Every layer body is one K1 call (ops/bert_layer.py). Parameter
names follow HuggingFace (``encoder.layer.{i}.attention.self.query``, ...).
In training each layer draws its own dropout seed from the step's
generator (JAX: one ``dropout`` rng split per scanned layer).
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, draw_seed,
                                                       dropout)
from multimodal_neuroimage_tpu_torch.ops.bert_layer import bert_layer_call

LN_EPS = 1e-12


class BertLayer(nn.Module):
    """One HF post-LN BERT layer."""

    def __init__(self, hidden: int, heads: int, intermediate: int = 3072,
                 attn_dropout: float = 0.1, hidden_dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.rates = (attn_dropout, hidden_dropout)
        lin = lambda i, o: nn.Linear(i, o)
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

    def forward(self, x: torch.Tensor, t_valid: int,
                generator=None) -> torch.Tensor:
        seed = 0
        if self.training and max(self.rates) > 0.0:
            seed = draw_seed(generator)
        return bert_layer_call(x, self.kernel_params(), self.heads, t_valid,
                               seed, self.rates, self.training)


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
        self.pooler = nn.ModuleDict({"dense": nn.Linear(hidden, hidden)})

    def forward(self, inputs_embeds: torch.Tensor, generator=None):
        T = inputs_embeds.shape[1]
        emb = self.embeddings
        x = (inputs_embeds + emb["position_embeddings"].weight[None, :T]
             + emb["token_type_embeddings"].weight[None])
        x = emb["LayerNorm"](x)
        if self.training and self.hidden_dropout > 0.0:
            x = dropout(x, self.hidden_dropout, draw_seed(generator))
        x = x.contiguous()
        for layer in self.encoder["layer"]:
            x = layer(x, T, generator)
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
        self.cls_embedding = nn.Sequential(nn.Linear(hidden, hidden),
                                           nn.LeakyReLU())
        self.bert = BertEncoder(hidden, layers, heads, max_positions,
                                intermediate, hidden_dropout, attn_dropout)

    def forward(self, x: torch.Tensor, generator=None):
        cls_const = torch.full((x.shape[0], 1, self.hidden), 0.5,
                               dtype=x.dtype, device=x.device)
        seq = torch.cat([self.cls_embedding(cls_const), x], dim=1)
        seq_out, pooled = self.bert(seq, generator)
        return {"sequence": seq_out[:, 1:], "cls": pooled}
