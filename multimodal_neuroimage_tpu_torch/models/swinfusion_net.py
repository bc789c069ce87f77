"""SwinFusion backbone and the phase-6 ``SwinFusionNet`` (counterpart of multimodal_neuroimage_tpu/models/swinfusion_net.py).

Shared conv stem -> per-modality RSTB branches (Ex) -> CRSTB cross stages ->
concat + conv collapse -> RSTB reconstruction (Re) -> conv collapse to one
84x84 channel. The reference's single ``patch_embed`` LayerNorm is shared by
every stage entry (Ex_A, Ex_B, both fusion streams, Re), so it is ONE module
here too, and ``pos_drop`` (dropout at ``drop_rate``) follows it at each
entry in training. Each stage group's DropPath rates are
``linspace(0, drop_path_rate, sum(depths))`` (JAX ``_dpr``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.nn.common import (LayerNorm, TorchConv,
                                                       draw_seed, dropout,
                                                       full_f32)
from multimodal_neuroimage_tpu_torch.nn.swin2d import SwinTransformerV2
from multimodal_neuroimage_tpu_torch.nn.swinfusion import CRSTB, RSTB


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class PatchEmbedFusion(nn.Module):
    """The shared patch-embed LayerNorm (the flatten happens at the call)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class SwinFusionBackbone(nn.Module):
    """(B, S, S) fMRI embedding and struct matrix -> fused (B, S, S)."""

    def __init__(self, embed_dim: int = 12,
                 ex_depths: Sequence[int] = (6, 6),
                 fusion_depths: Sequence[int] = (2, 2, 2),
                 re_depths: Sequence[int] = (6, 6),
                 ex_heads: Sequence[int] = (6, 6),
                 fusion_heads: Sequence[int] = (6, 6, 6),
                 re_heads: Sequence[int] = (6, 6), img_size: int = 84,
                 window_size: int = 6, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        E = embed_dim
        self.res = (img_size, img_size)
        self.embed_dim = E
        self.drop_rate = drop_rate
        self.conv_first1_A = TorchConv(1, E // 2)
        self.conv_first2_A = TorchConv(E // 2, E)
        self.patch_embed = PatchEmbedFusion(E)

        def stack(cls, depths, heads):
            dpr = list(np.linspace(0, drop_path_rate, sum(depths)))
            return nn.ModuleList(
                cls(E, self.res, d, h, window_size, mlp_ratio, drop_rate,
                    attn_drop_rate, dpr[sum(depths[:i]):sum(depths[:i + 1])])
                for i, (d, h) in enumerate(zip(depths, heads)))

        self.layers_Ex_A = stack(RSTB, ex_depths, ex_heads)
        self.layers_Ex_B = stack(RSTB, ex_depths, ex_heads)
        self.layers_Fusion = stack(CRSTB, fusion_depths, fusion_heads)
        self.layers_Re = stack(RSTB, re_depths, re_heads)
        for name in ("norm_Ex_A", "norm_Ex_B", "norm_Fusion_A",
                     "norm_Fusion_B", "norm_Re"):
            setattr(self, name, LayerNorm(E))
        self.conv_after_body_Fusion = TorchConv(2 * E, E)
        self.conv_last1 = TorchConv(E, E // 2)
        self.conv_last2 = TorchConv(E // 2, E // 4)
        self.conv_last3 = TorchConv(E // 4, 1)

    def _tokens(self, h: torch.Tensor) -> torch.Tensor:
        """(B, E, S, S) -> (B, S*S, E) through the shared patch norm."""
        return self.patch_embed(h.flatten(2).transpose(1, 2))

    def _pos_drop(self, t: torch.Tensor, generator) -> torch.Tensor:
        if not self.training or self.drop_rate <= 0.0:
            return t
        return dropout(t, self.drop_rate, draw_seed(generator))

    def _image(self, t: torch.Tensor) -> torch.Tensor:
        """(B, S*S, E) -> (B, E, S, S)."""
        return t.transpose(1, 2).reshape(t.shape[0], -1, *self.res)

    def _extract(self, x: torch.Tensor, branch: str,
                 generator) -> torch.Tensor:
        h = _lrelu(self.conv_first2_A(_lrelu(self.conv_first1_A(x[:, None]))))
        t = self._pos_drop(self._tokens(h), generator)
        for layer in getattr(self, f"layers_Ex_{branch}"):
            t = layer(t, generator)
        return getattr(self, f"norm_Ex_{branch}")(t)

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                generator=None) -> torch.Tensor:
        with full_f32():
            x = self._extract(a.float(), "A", generator)
            y = self._extract(b.float(), "B", generator)
            x = self._pos_drop(self.patch_embed(x), generator)
            y = self._pos_drop(self.patch_embed(y), generator)
            for layer in self.layers_Fusion:
                x, y = layer(x, y, generator)
            x, y = self.norm_Fusion_A(x), self.norm_Fusion_B(y)
            h = torch.cat([self._image(x), self._image(y)], dim=1)
            h = _lrelu(self.conv_after_body_Fusion(h))
            t = self._pos_drop(self._tokens(h), generator)
            for layer in self.layers_Re:
                t = layer(t, generator)
            h = self._image(self.norm_Re(t))
            h = _lrelu(self.conv_last1(h))
            h = _lrelu(self.conv_last2(h))
            return self.conv_last3(h)[:, 0]


class SwinFusionNet(nn.Module):
    """Phase 6: the backbone fuses (sMRI, DTI) into one 84x84 image, which
    a fixed SwinV2 classifier scores (embed 12, depths (2, 2, 6), heads (3,
    6, 12), window 6, DropPath 0.1: the reference's own, whatever the
    config says); returns ``fused_image`` beside the logits. The
    backbone's dropout, attention dropout and DropPath come from the
    config (0.8, 0.8 and 0.1 at phase 6's defaults)."""

    def __init__(self, embed_dim: int = 12,
                 ex_depths: Sequence[int] = (6, 6),
                 fusion_depths: Sequence[int] = (2, 2, 2),
                 re_depths: Sequence[int] = (6, 6),
                 ex_heads: Sequence[int] = (6, 6),
                 fusion_heads: Sequence[int] = (6, 6, 6),
                 re_heads: Sequence[int] = (6, 6), window_size: int = 6,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.8,
                 attn_drop_rate: float = 0.8, drop_path_rate: float = 0.1,
                 fine_tune_task: str = "binary_classification"):
        super().__init__()
        self.fine_tune_task = fine_tune_task
        self.fusion = SwinFusionBackbone(
            embed_dim, ex_depths, fusion_depths, re_depths, ex_heads,
            fusion_heads, re_heads, window_size=window_size,
            mlp_ratio=mlp_ratio, drop_rate=drop_rate,
            attn_drop_rate=attn_drop_rate, drop_path_rate=drop_path_rate)
        self.swin = SwinTransformerV2((84, 84), 7, 12, (2, 2, 6), (3, 6, 12),
                                      6, drop_path_rate=0.1)

    @classmethod
    def from_config(cls, cfg) -> "SwinFusionNet":
        return cls(embed_dim=cfg.fusion_embed_dim,
                   ex_depths=tuple(cfg.fusion_ex_depths),
                   fusion_depths=tuple(cfg.fusion_depths),
                   re_depths=tuple(cfg.fusion_re_depths),
                   ex_heads=tuple(cfg.fusion_ex_heads),
                   fusion_heads=tuple(cfg.fusion_heads),
                   re_heads=tuple(cfg.fusion_re_heads),
                   window_size=cfg.window_size, mlp_ratio=cfg.mlp_ratio,
                   drop_rate=cfg.fusion_drop_rate,
                   attn_drop_rate=cfg.fusion_attn_drop_rate,
                   drop_path_rate=cfg.fusion_drop_path_rate,
                   fine_tune_task=cfg.fine_tune_task)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        if self.training and generator is None:
            raise ValueError("a training forward draws its dropout from an "
                             "explicit torch.Generator; pass generator=")
        fused = self.fusion(batch["smri"], batch["dti"], generator)
        return {self.fine_tune_task: self.swin(fused, generator),
                "fused_image": fused}
