"""2-D UNet denoiser (counterpart of multimodal_neuroimage_tpu/nn/unet.py).

A DoubleConv stem 1 -> base, four maxpool + DoubleConv downs (base -> 2 base
-> ... -> 16 base), four transposed-convolution ups with skip concatenation
(16 base -> 8 base -> ... -> 1; the last up emits the single output channel
directly). Odd sizes (84 -> 42 -> 21 -> 10 -> 5) are handled by padding the
upsampled map to the skip's size: ``up2`` pads its 20x20 map to the 21x21
skip. ``UNet2D(x, inject)`` adds (or, with ``concat_method="hadamard"``,
multiplies) a latent shaped like the 16 base-channel bottleneck x5 before
the ups: the PRS latent of ``FuncStructUNetCrossPRS``.

The convolutions compute in their input's dtype, as flax promotes a bf16
kernel against it (nn/common.py ``Conv2d``): a float32 input (the struct matrix)
takes the bf16-valued weights in float32, a bf16 input (the fMRI
embedding under the bf16 policy) computes in bf16.

``BatchStatNorm`` normalises with the statistics of the batch in BOTH
modes (biased variance, learned affine, no running statistics), as the
JAX module does: a UNet model's output for one subject depends on the other
rows of its batch, pad rows included. NCHW throughout (the JAX module is
NHWC). Parameter names follow the reference torch modules
(``inc.double_conv.0``, ``down1.maxpool_conv.1``, ``up1.up``, ``up1.conv``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import Conv2d, ConvTranspose2d


class BatchStatNorm(nn.Module):
    """Per-channel normalisation over (batch, H, W) with a learned affine
    (``weight``, ``bias``: the reference BatchNorm2d's names)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        xc = x32 - x32.mean(dim=(0, 2, 3), keepdim=True)
        var = (xc * xc).mean(dim=(0, 2, 3), keepdim=True)
        y = xc * torch.rsqrt(var + self.eps)
        return (y * self.weight[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class DoubleConv(nn.Module):
    """(conv3x3 without bias -> BatchStatNorm -> relu) x 2."""

    def __init__(self, in_ch: int, out_ch: int, mid_ch: Optional[int] = None):
        super().__init__()
        mid = mid_ch or out_ch
        self.double_conv = nn.Sequential(
            Conv2d(in_ch, mid, 3, padding=1, bias=False),
            BatchStatNorm(mid), nn.ReLU(),
            Conv2d(mid, out_ch, 3, padding=1, bias=False),
            BatchStatNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    """2x2 max pool (floor), then DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(in_ch, out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class Up(nn.Module):
    """Transposed conv 2x up (in_ch -> in_ch // 2), pad to the skip's size,
    concatenate [skip, up], DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = ConvTranspose2d(in_ch, in_ch // 2, 2, stride=2)
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = self.up(x1)
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return self.conv(torch.cat([x2, x1], dim=1))


class UNet2D(nn.Module):
    """4-down / 4-up UNet: (B, 1, H, W) -> (B, 1, H, W)."""

    def __init__(self, base: int = 64):
        super().__init__()
        b = base
        self.inc = DoubleConv(1, b)
        self.down1 = Down(b, 2 * b)
        self.down2 = Down(2 * b, 4 * b)
        self.down3 = Down(4 * b, 8 * b)
        self.down4 = Down(8 * b, 16 * b)
        self.up1 = Up(16 * b, 8 * b)
        self.up2 = Up(8 * b, 4 * b)
        self.up3 = Up(4 * b, 2 * b)
        self.up4 = Up(2 * b, 1)

    def forward(self, x: torch.Tensor, inject: Optional[torch.Tensor] = None,
                concat_method: str = "add") -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        if inject is not None:
            x5 = x5 * inject if concat_method == "hadamard" else x5 + inject
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        return self.up4(y, x1)
