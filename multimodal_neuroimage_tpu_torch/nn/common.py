"""Shared building blocks (counterpart of multimodal_neuroimage_tpu/nn/common.py).

Dtypes follow the JAX package's (Flax's) promotion under the bf16 policy,
where every parameter is bf16 (train/state.py hands the modules float32
tensors holding the bf16 values): a layer computes in its input's dtype. A
bf16 input stays bf16, the parameters cast to bf16 exactly (``Linear``: the
product rounded, then the bias added and rounded, as ``nn.Dense``); a
float32 input takes them as float32, as JAX promotes bf16 parameters
against it (the SwinFusion backbone and the SwinV2 head); ``LayerNorm``
takes its statistics in float32 and returns its input's dtype. With float32
inputs every layer is the plain float32 one.

Randomness is explicit: a training forward takes one ``torch.Generator`` on
the host, from which every dropout seed and every DropPath factor is drawn
in a fixed order, so that the same generator state gives the same step on
the CPU and on the card. Dropout masks are the JAX kernels' coordinate hash
(ops/fusion_block.py ``mix_keep``), not torch's RNG.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the exact two-pass variance (the
    JAX package's ``use_fast_variance=False``)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


class LayerNorm(nn.Module):
    """Two-pass LayerNorm; eps 1e-5 (torch's default, the Swin stacks) unless
    given (BERT passes HF's 1e-12). Parameters are ``weight``/``bias``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm(x.float(), self.weight, self.bias,
                          self.eps).to(x.dtype)


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, as ``nn.Dense`` (module
    docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def _cast(t: Optional[torch.Tensor], x: torch.Tensor):
    return t if t is None or t.dtype == x.dtype else t.to(x.dtype)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype, as flax's ``nn.Conv`` (module
    docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, _cast(self.weight, x),
                                  _cast(self.bias, x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (module docstring)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, _cast(self.weight, x),
                                  _cast(self.bias, x), self.stride,
                                  self.padding, self.output_padding,
                                  self.groups, self.dilation)


def TorchConv(in_channels: int, out_channels: int,
              kernel_size: int = 3) -> nn.Conv2d:
    """The JAX package's TorchConv is torch's own Conv2d init: a plain
    ``nn.Conv2d`` with padding 1 (its nonzero bias keeps the diagonal-
    embedded input from making zero-variance LayerNorms)."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=1)


def draw_seed(generator: torch.Generator) -> int:
    """One int32 dropout seed in [0, 2^31 - 1), as the JAX modules draw."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout of a (..., C) tensor with the hash masks (draw 0), rows
    numbered over the leading axes. Used where the JAX package runs
    ``nn.Dropout`` outside a kernel (BERT embeddings, SwinFusion pos_drop),
    whose jax.random stream the port cannot reproduce anyway."""
    if rate <= 0.0:
        return x
    from multimodal_neuroimage_tpu_torch.ops.fusion_block import mix_keep
    C = x.shape[-1]
    rows = torch.arange(x.numel() // C, dtype=torch.int64,
                        device=x.device).reshape(*x.shape[:-1], 1)
    cols = torch.arange(C, dtype=torch.int64, device=x.device)
    return (x * mix_keep(rows, cols, rate, seed, 0)).to(x.dtype)


def drop_path_factors(shape, rate: float, generator: torch.Generator,
                      device=None) -> torch.Tensor:
    """DropPath factors bernoulli(1 - rate) / (1 - rate) of ``shape`` (the
    fusion kernels' (B, 2)), drawn on the host and moved to ``device``."""
    keep = 1.0 - rate
    u = torch.rand(tuple(shape), generator=generator)
    return ((u < keep).to(torch.float32) / keep).to(device)


def drop_path(x: torch.Tensor, rate: float,
              generator: torch.Generator) -> torch.Tensor:
    """timm DropPath (nn/common.py DropPath): whole samples zeroed, the
    rest divided by the keep probability, in ``x``'s dtype."""
    if rate <= 0.0:
        return x
    return (x * drop_path_factors((x.shape[0],) + (1,) * (x.ndim - 1), rate,
                                  generator, x.device)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> erf-GELU -> dropout -> fc2 -> dropout (swin_v2_module.py:16-32;
    the flagship's SwinV2 head runs drop 0)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = Linear(in_features, hidden_features)
        self.fc2 = Linear(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.training or self.drop <= 0.0:
            return self.fc2(F.gelu(self.fc1(x)))
        h = dropout(F.gelu(self.fc1(x)), self.drop, draw_seed(generator))
        return dropout(self.fc2(h), self.drop, draw_seed(generator))


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nWindows, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).transpose(2, 3)
    return x.reshape(B, (H // ws) * (W // ws), ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int,
                   W: int) -> torch.Tensor:
    """(B, nWindows, ws*ws, C) -> (B, H, W, C)."""
    B, C = windows.shape[0], windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).transpose(2, 3)
    return x.reshape(B, H, W, C)


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions in full float32 (no TF32),
    restoring the previous settings on exit. cuDNN convs default to TF32,
    which keeps about three decimal digits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
