"""The flagship Func+Struct cross model (counterpart of multimodal_neuroimage_tpu/models/func_struct.py).

Dual temporal BERTs over the low/ultralow bands -> CLS concat + projection
-> the fused vector embedded on the diagonal of an S x S matrix (+ the ROI
functional-connectivity matrix with ``use_FC``) -> SwinFusion with the
struct matrix -> SwinV2 head. ``forward(batch, generator)``: in training
(``model.train()``) every dropout seed and DropPath factor is drawn from the
host ``generator`` in module order; at inference the generator is unused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.models.swinfusion_net import (
    SwinFusionBackbone)
from multimodal_neuroimage_tpu_torch.nn.bert import TemporalBert
from multimodal_neuroimage_tpu_torch.nn.common import Linear
from multimodal_neuroimage_tpu_torch.nn.swin2d import (SwinTransformerV2,
                                                       size_preset)


def batched_fc_matrix(x: torch.Tensor) -> torch.Tensor:
    """Per-sample ROI functional connectivity: corrcoef over time with
    negative entries and the diagonal zeroed. x: (B, T, R) -> (B, R, R)."""
    x = x.float()
    xc = x - x.mean(dim=1, keepdim=True)
    cov = torch.einsum("btr,bts->brs", xc, xc)
    std = torch.sqrt(torch.einsum("btr,btr->br", xc, xc))
    corr = cov / (std[:, :, None] * std[:, None, :] + 1e-12)
    corr = corr * (corr > 0)
    return corr * (1.0 - torch.eye(corr.shape[-1], device=corr.device))


class FmriDiagEmbed(nn.Module):
    """Dual-band BERT encoding -> fused CLS -> diagonal S x S embedding."""

    def __init__(self, intermediate_vec: int = 84,
                 transformer_hidden_layers: int = 16,
                 num_heads_2DBert: int = 12, sequence_length: int = 368,
                 bert_intermediate_size: int = 3072,
                 concat_method: str = "concat", use_FC: bool = False,
                 use_merge_loss: bool = False,
                 transformer_dropout_rate: float = 0.1,
                 bert_attn_dropout: float = 0.1):
        super().__init__()
        self.concat_method = concat_method
        self.use_FC = use_FC

        def bert():
            return TemporalBert(intermediate_vec, transformer_hidden_layers,
                                num_heads_2DBert, sequence_length + 1,
                                bert_intermediate_size,
                                transformer_dropout_rate, bert_attn_dropout)

        self.transformer_raw = bert() if use_merge_loss else None
        self.transformer_low = bert()
        self.transformer_ultralow = bert()
        self.proj_layer = (Linear(2 * intermediate_vec, intermediate_vec)
                           if concat_method == "concat" else None)

    def forward(self, x_raw: Optional[torch.Tensor], x_l: torch.Tensor,
                x_u: torch.Tensor, generator=None) -> Tuple[torch.Tensor, Dict]:
        aux: Dict[str, torch.Tensor] = {}
        if self.transformer_raw is not None and x_raw is not None:
            aux["processed_raw"] = self.transformer_raw(x_raw,
                                                        generator)["cls"]
        low = self.transformer_low(x_l, generator)["cls"]
        ul = self.transformer_ultralow(x_u, generator)["cls"]
        if self.proj_layer is not None:
            cls = self.proj_layer(torch.cat([low, ul], dim=1))
        else:
            cls = low * ul
        aux["embedding_per_ROIs"] = cls
        embed = torch.diag_embed(cls)
        if self.use_FC and x_raw is not None:
            embed = embed + batched_fc_matrix(x_raw).to(cls.dtype)
        return embed, aux


class FuncStructCross(nn.Module):
    """Dual BERTs -> diag embed -> SwinFusion with struct -> SwinV2."""

    def __init__(self, intermediate_vec: int = 84,
                 transformer_hidden_layers: int = 16,
                 num_heads_2DBert: int = 12, sequence_length: int = 368,
                 bert_intermediate_size: int = 3072,
                 concat_method: str = "concat", use_FC: bool = False,
                 use_merge_loss: bool = False, fusion_embed_dim: int = 12,
                 fusion_ex_depths=(6, 6), fusion_depths=(2, 2, 2),
                 fusion_re_depths=(6, 6), fusion_ex_heads=(6, 6),
                 fusion_heads=(6, 6, 6), fusion_re_heads=(6, 6),
                 window_size: int = 6, mlp_ratio: float = 4.0,
                 size_of_model: str = "large", swin_embed_dim: int = 12,
                 patch_size: int = 7,
                 fine_tune_task: str = "binary_classification",
                 transformer_dropout_rate: float = 0.1,
                 bert_attn_dropout: float = 0.1, fusion_drop: float = 0.1,
                 fusion_drop_path: float = 0.1):
        super().__init__()
        self.fine_tune_task = fine_tune_task
        self.fmri_embed = FmriDiagEmbed(
            intermediate_vec, transformer_hidden_layers, num_heads_2DBert,
            sequence_length, bert_intermediate_size, concat_method, use_FC,
            use_merge_loss, transformer_dropout_rate, bert_attn_dropout)
        # models/func_struct.py _fusion: attention dropout runs at the
        # fusion drop rate too (model.py:1591)
        self.fusion = SwinFusionBackbone(
            fusion_embed_dim, fusion_ex_depths, fusion_depths,
            fusion_re_depths, fusion_ex_heads, fusion_heads, fusion_re_heads,
            img_size=intermediate_vec, window_size=window_size,
            mlp_ratio=mlp_ratio, drop_rate=fusion_drop,
            attn_drop_rate=fusion_drop, drop_path_rate=fusion_drop_path)
        depths, heads = size_preset(size_of_model)
        self.swin = SwinTransformerV2(
            (intermediate_vec, intermediate_vec), patch_size, swin_embed_dim,
            depths, heads, window_size, mlp_ratio,
            drop_path_rate=fusion_drop_path)

    @classmethod
    def from_config(cls, cfg) -> "FuncStructCross":
        if cfg.feature_map_size != "same":
            raise NotImplementedError(
                "feature_map_size='different' needs TimeProj (ROADMAP M7)")
        return cls(
            intermediate_vec=cfg.intermediate_vec,
            transformer_hidden_layers=cfg.transformer_hidden_layers,
            num_heads_2DBert=cfg.num_heads_2DBert,
            sequence_length=cfg.sequence_length,
            bert_intermediate_size=cfg.bert_intermediate_size,
            concat_method=cfg.concat_method, use_FC=cfg.use_FC,
            use_merge_loss=cfg.use_merge_loss,
            fusion_embed_dim=cfg.fusion_embed_dim,
            fusion_ex_depths=tuple(cfg.fusion_ex_depths),
            fusion_depths=tuple(cfg.fusion_depths),
            fusion_re_depths=tuple(cfg.fusion_re_depths),
            fusion_ex_heads=tuple(cfg.fusion_ex_heads),
            fusion_heads=tuple(cfg.fusion_heads),
            fusion_re_heads=tuple(cfg.fusion_re_heads),
            window_size=cfg.window_size, mlp_ratio=cfg.mlp_ratio,
            size_of_model=cfg.size_of_model,
            swin_embed_dim=cfg.swin_embed_dim, patch_size=cfg.patch_size,
            fine_tune_task=cfg.fine_tune_task,
            transformer_dropout_rate=cfg.transformer_dropout_rate,
            bert_attn_dropout=cfg.bert_attn_dropout,
            fusion_drop=cfg.fusion_drop_rate,
            fusion_drop_path=cfg.fusion_drop_path_rate)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        if self.training and generator is None:
            raise ValueError("a training forward draws its dropout from an "
                             "explicit torch.Generator; pass generator=")
        embed, aux = self.fmri_embed(batch.get("fmri_raw_sequence"),
                                     batch["fmri_lowfreq_sequence"],
                                     batch["fmri_ultralowfreq_sequence"],
                                     generator)
        fused = self.fusion(embed, batch["struct"].float(), generator)
        return {self.fine_tune_task: self.swin(fused, generator), **aux}
