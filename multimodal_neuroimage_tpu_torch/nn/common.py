"""Shared building blocks (counterpart of multimodal_neuroimage_tpu/nn/common.py).

The port is inference-only, so dropout and DropPath are the identity and
appear nowhere in its modules.
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
        return layer_norm(x, self.weight, self.bias, self.eps)


def TorchConv(in_channels: int, out_channels: int,
              kernel_size: int = 3) -> nn.Conv2d:
    """The JAX package's TorchConv is torch's own Conv2d init: a plain
    ``nn.Conv2d`` with padding 1 (its nonzero bias keeps the diagonal-
    embedded input from making zero-variance LayerNorms)."""
    return nn.Conv2d(in_channels, out_channels, kernel_size, padding=1)


class Mlp(nn.Module):
    """fc1 -> erf-GELU -> fc2 (dropout is the identity at inference)."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


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
