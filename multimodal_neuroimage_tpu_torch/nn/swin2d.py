"""Swin Transformer V2 encoder (counterpart of multimodal_neuroimage_tpu/nn/swin2d.py).

Scaled-cosine window attention with a clamped per-head logit scale, the
16*sigmoid cpb-MLP bias, q/v biases without a k bias, res-post-norm blocks,
cyclic shift with static -100 masks and patch merging. The attention core is
K4 (ops/attention.py). Parameter names follow the reference torch modules
(``qkv``, ``q_bias``, ``cpb_mlp.0``, ``layers.{i}.blocks.{j}``, ...).
Training: per-block DropPath at ``linspace(0, drop_path_rate, sum(depths))``
drawn from the step's generator, and the plain hash dropout at
``drop_rate`` after the patch embedding, the projection and in the MLP.
Attention-probability dropout would have to live in K4, which has none
(``attn_drop_rate`` 0 in the flagship; more is refused, ROADMAP "K4
dropout").
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, Mlp,
                                                       draw_seed, drop_path,
                                                       dropout, full_f32,
                                                       window_partition,
                                                       window_reverse)
from multimodal_neuroimage_tpu_torch.ops.attention import (
    fused_window_attention)


# The three numpy helpers are copies of nn/swin2d.py:39-86, which cannot be
# imported here (that module imports flax).
@lru_cache(maxsize=64)
def relative_coords_table(ws_h: int, ws_w: int,
                          pretrained_ws: int = 0) -> np.ndarray:
    """Log-spaced continuous relative coordinates, (1, 2H-1, 2W-1, 2)."""
    h = np.arange(-(ws_h - 1), ws_h, dtype=np.float32)
    w = np.arange(-(ws_w - 1), ws_w, dtype=np.float32)
    table = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)[None]
    denom_h = (pretrained_ws - 1) if pretrained_ws > 0 else (ws_h - 1)
    denom_w = (pretrained_ws - 1) if pretrained_ws > 0 else (ws_w - 1)
    table[..., 0] /= max(denom_h, 1)
    table[..., 1] /= max(denom_w, 1)
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table


@lru_cache(maxsize=64)
def relative_position_index(ws_h: int, ws_w: int) -> np.ndarray:
    """(N, N) index into the flattened (2H-1)(2W-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws_h), np.arange(ws_w),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws_h - 1
    rel[:, :, 1] += ws_w - 1
    rel[:, :, 0] *= 2 * ws_w - 1
    return rel.sum(-1)


@lru_cache(maxsize=64)
def shift_attn_mask(H: int, W: int, ws: int,
                    shift: int) -> Optional[np.ndarray]:
    """Additive (-100/0) mask per window for shifted windows, (nW, N, N)."""
    if shift == 0:
        return None
    img = np.zeros((H, W))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(0, 2, 1, 3)
    win = win.reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def effective_window(resolution: Tuple[int, int], window_size: int,
                     shift_size: int) -> Tuple[int, int]:
    """The window clamps to the resolution and the shift drops when the
    resolution is no larger than the window (``_effective``)."""
    if min(resolution) <= window_size:
        return min(resolution), 0
    return window_size, shift_size


def _mask_buffer(resolution, ws: int, shift: int) -> Optional[torch.Tensor]:
    mask = shift_attn_mask(resolution[0], resolution[1], ws, shift)
    return None if mask is None else torch.from_numpy(mask.copy())


class WindowAttentionV2(nn.Module):
    """Scaled-cosine window MHSA with continuous position bias over
    (B, nW, N, C) windows."""

    def __init__(self, dim: int, window_size: Tuple[int, int],
                 num_heads: int, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(
            torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("relative_coords_table", torch.from_numpy(
            relative_coords_table(*window_size).astype(np.float32)),
            persistent=False)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(*window_size).reshape(-1).copy()),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        if self.training and self.attn_drop > 0.0:
            raise NotImplementedError(
                f"SwinV2 attention dropout {self.attn_drop}: the K4 kernel "
                f"has no dropout yet (ROADMAP \"K4 dropout\")")
        B, nW, N, C = x.shape
        heads = self.num_heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias)
        qkv = qkv.reshape(B, nW, N, 3, heads, C // heads)
        q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        scale = torch.exp(torch.clamp(self.logit_scale,
                                      max=math.log(1.0 / 0.01)))
        table = self.cpb_mlp(self.relative_coords_table).reshape(-1, heads)
        rel = table[self.relative_position_index].reshape(N, N, heads)
        rel_bias = 16.0 * torch.sigmoid(rel.permute(2, 0, 1))
        out = fused_window_attention((q * scale).contiguous(), k.contiguous(),
                                     v.contiguous(), rel_bias.contiguous(),
                                     mask)
        out = self.proj(out.transpose(2, 3).reshape(B, nW, N, C))
        if self.training and self.proj_drop > 0.0:
            out = dropout(out, self.proj_drop, draw_seed(generator))
        return out


class SwinBlockV2(nn.Module):
    """Res-post-norm Swin V2 block over (B, L, C) tokens."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 6, shift_size: int = 0,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.drop_path = drop_path
        self.ws, self.shift = effective_window(self.input_resolution,
                                               window_size, shift_size)
        self.attn = WindowAttentionV2(dim, (self.ws, self.ws), num_heads,
                                      attn_drop, drop)
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)
        self.norm2 = LayerNorm(dim)
        # res-post-norm: zero-initialised scales, as in the JAX package
        nn.init.zeros_(self.norm1.weight)
        nn.init.zeros_(self.norm2.weight)
        self.register_buffer(
            "attn_mask", _mask_buffer(self.input_resolution, self.ws,
                                      self.shift), persistent=False)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        H, W = self.input_resolution
        B, L, C = x.shape
        ws, s = self.ws, self.shift
        rate = self.drop_path if self.training else 0.0
        h = x.reshape(B, H, W, C)
        if s > 0:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
        h = window_reverse(self.attn(window_partition(h, ws), self.attn_mask,
                                     generator), ws, H, W)
        if s > 0:
            h = torch.roll(h, shifts=(s, s), dims=(1, 2))
        x = x + drop_path(self.norm1(h.reshape(B, L, C)), rate, generator)
        return x + drop_path(self.norm2(self.mlp(x, generator)), rate,
                             generator)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat -> Linear(4C -> 2C, no bias) -> LN."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.input_resolution = tuple(input_resolution)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = LayerNorm(2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(x.reshape(B, -1, 4 * C)))


class PatchEmbed(nn.Module):
    """Conv patchifier: (B, 1, H, W) -> (B, nTokens, embed), LN."""

    def __init__(self, img_size: Tuple[int, int], patch_size: int,
                 embed_dim: int):
        super().__init__()
        h, w = img_size
        self.img_size = (h, w)
        pw_stride = patch_size if w >= patch_size else 1
        self.patches_resolution = (h // patch_size,
                                   max(w // patch_size, 1))
        self.proj = nn.Conv2d(1, embed_dim,
                              kernel_size=(patch_size, pw_stride),
                              stride=(patch_size, pw_stride))
        self.norm = LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != self.img_size:
            raise ValueError(f"input {tuple(x.shape[2:])} != configured "
                             f"{self.img_size}")
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinStage(nn.Module):
    """``depth`` blocks alternating shift 0 / ws//2, optional merge."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, downsample: bool = False,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = ()):
        super().__init__()
        dpr = list(drop_path) or [0.0] * depth
        self.blocks = nn.ModuleList(
            SwinBlockV2(dim, input_resolution, num_heads, window_size,
                        0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                        drop, attn_drop, dpr[i])
            for i in range(depth))
        self.downsample = (PatchMerging(input_resolution, dim)
                           if downsample else None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, generator)
        return x if self.downsample is None else self.downsample(x)


def size_preset(size_of_model: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Reference size presets: (depths, heads)."""
    if size_of_model == "small":
        return (2,), (3,)
    if size_of_model == "medium":
        return (2, 2), (3, 6)
    return (2, 2, 6), (3, 6, 12)


class SwinTransformerV2(nn.Module):
    """84x84 -> patch7 -> 12x12 tokens -> stages with patch merging -> LN
    -> token mean-pool -> Linear(1)."""

    def __init__(self, img_size: Tuple[int, int] = (84, 84),
                 patch_size: int = 7, embed_dim: int = 12,
                 depths: Sequence[int] = (2, 2, 6),
                 num_heads: Sequence[int] = (3, 6, 12), window_size: int = 6,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed(img_size, patch_size, embed_dim)
        res = self.patch_embed.patches_resolution
        n = len(depths)
        dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
        self.layers = nn.ModuleList(
            SwinStage(int(embed_dim * 2 ** i),
                      (res[0] // 2 ** i, res[1] // 2 ** i), depth, heads,
                      window_size, mlp_ratio, downsample=i < n - 1,
                      drop=drop_rate, attn_drop=attn_drop_rate,
                      drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])])
            for i, (depth, heads) in enumerate(zip(depths, num_heads)))
        self.norm = LayerNorm(int(embed_dim * 2 ** (n - 1)))
        self.head = nn.Linear(int(embed_dim * 2 ** (n - 1)), 1)

    def forward_features(self, x: torch.Tensor,
                         generator=None) -> torch.Tensor:
        if x.ndim == 3:
            x = x[:, None]
        x = self.patch_embed(x)
        if self.training and self.drop_rate > 0.0:
            x = dropout(x, self.drop_rate, draw_seed(generator))
        for stage in self.layers:
            x = stage(x, generator)
        return self.norm(x).mean(dim=1)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        """x: (B, H, W) or (B, 1, H, W) -> logits (B, 1)."""
        with full_f32():
            return self.head(self.forward_features(x, generator))
