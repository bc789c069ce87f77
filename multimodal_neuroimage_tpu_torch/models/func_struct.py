"""Phase 5's Func+Struct combiners (counterpart of multimodal_neuroimage_tpu/models/func_struct.py).

Every combiner starts with dual temporal BERTs over the low/ultralow bands
-> CLS concat + projection -> the fused vector embedded on the diagonal of
an S x S matrix (+ the ROI functional-connectivity matrix with ``use_FC``)
(``FmriDiagEmbed``; under ``feature_map_size='different'`` the ultralow
BERT has 128 + 1 positions, fed by ``TimeProj(128)`` under
``feature_map_gen='convolution_ul'``), and ends in the SwinV2 head:

* ``FuncStructCross`` (the flagship): SwinFusion of the embedding with the
  struct matrix, then SwinV2;
* ``FuncStructAdd``: struct + embedding -> SwinV2;
* ``FuncStructTransfer``: the embedding alone -> SwinV2 (a struct-pretrained
  SwinV2 takes the functional image);
* ``FuncStructUNetAdd``: the UNet-denoised struct + embedding -> SwinV2;
* ``FuncStructUNetCross``: ONE UNet (nn/unet.py), applied to the embedding
  with ``use_unet_function`` and to the struct with ``use_unet_struct``
  (each call normalises with its own batch statistics), then SwinFusion and
  SwinV2; with neither flag the UNet is never called and, as in flax, has
  no parameters;
* ``FuncStructUNetCrossPRS``: + the batch's three polygenic scores on a 3x3
  diagonal, a transposed 3x3 convolution (``conv_prs``, 3x3 -> 5x5) and
  ``prs_unsqueeze`` (one SAME convolution to 1024 channels ``up_prs``, five
  ``up_prs1..5`` to 64 ... 1024, or the map repeated 1024 times), added to
  (or, ``prs_concat_method="hadamard"``, multiplied into) the UNet's
  bottleneck on the struct.

With ``use_unet_loss`` the UNet models also return ``fMRI_input``,
``fMRI_output``, ``struct_input`` and ``struct_output`` (the UNet loss
itself is ROADMAP M10 and raises in train/losses.py). ``forward(batch,
generator)``: in training (``model.train()``) every dropout seed and
DropPath factor is drawn from the host ``generator`` in module order; at
inference the generator is unused.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.models.fmri_nets import (
    DIFFERENT_LENGTH, TimeProj, ultralow_length)
from multimodal_neuroimage_tpu_torch.models.swinfusion_net import (
    SwinFusionBackbone)
from multimodal_neuroimage_tpu_torch.nn.bert import TemporalBert
from multimodal_neuroimage_tpu_torch.nn.common import (Conv2d,
                                                       ConvTranspose2d,
                                                       Linear, full_f32)
from multimodal_neuroimage_tpu_torch.nn.swin2d import (SwinTransformerV2,
                                                       size_preset)
from multimodal_neuroimage_tpu_torch.nn.unet import UNet2D


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
                 bert_attn_dropout: float = 0.1,
                 feature_map_size: str = "same",
                 feature_map_gen: str = "no",
                 ul_length: Optional[int] = None):
        super().__init__()
        self.concat_method = concat_method
        self.use_FC = use_FC

        def bert(max_pos, hidden_dropout):
            return TemporalBert(intermediate_vec, transformer_hidden_layers,
                                num_heads_2DBert, max_pos,
                                bert_intermediate_size, hidden_dropout,
                                bert_attn_dropout)

        dr = transformer_dropout_rate
        different = feature_map_size == "different"
        self.transformer_raw = (bert(sequence_length + 1, dr)
                                if use_merge_loss else None)
        # 'different': the ultralow BERT at 128 + 1 positions and hidden
        # dropout 0.1 (JAX func_struct.py; TransformerNetTwoChannels: 0.2),
        # fed by TimeProj(128) under 'convolution_ul'
        self.proj_u = (TimeProj(ul_length or sequence_length,
                                DIFFERENT_LENGTH)
                       if different and feature_map_gen == "convolution_ul"
                       else None)
        self.transformer_low = bert(sequence_length + 1, dr)
        self.transformer_ultralow = (bert(DIFFERENT_LENGTH + 1, 0.1)
                                     if different
                                     else bert(sequence_length + 1, dr))
        self.proj_layer = (Linear(2 * intermediate_vec, intermediate_vec)
                           if concat_method == "concat" else None)

    def forward(self, x_raw: Optional[torch.Tensor], x_l: torch.Tensor,
                x_u: torch.Tensor, generator=None) -> Tuple[torch.Tensor, Dict]:
        aux: Dict[str, torch.Tensor] = {}
        if self.transformer_raw is not None and x_raw is not None:
            aux["processed_raw"] = self.transformer_raw(x_raw,
                                                        generator)["cls"]
        if self.proj_u is not None:
            x_u = self.proj_u(x_u)
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


class _FuncStructBase(nn.Module):
    """The combiners' shared configuration and modules: ``fmri_embed``,
    the subclass's fronts (``_fronts``), ``fusion`` where the combiner
    fuses (``FUSION``) and ``swin``."""

    FUSION = False

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
                 fusion_drop_path: float = 0.1,
                 use_unet_loss: bool = False,
                 use_unet_function: bool = False,
                 use_unet_struct: bool = False,
                 prs_unsqueeze: str = "single_convolution",
                 prs_concat_method: str = "add",
                 feature_map_size: str = "same", feature_map_gen: str = "no",
                 ul_length: Optional[int] = None):
        super().__init__()
        self.fine_tune_task = fine_tune_task
        self.use_unet_loss = use_unet_loss
        self.use_unet_function = use_unet_function
        self.use_unet_struct = use_unet_struct
        self.prs_unsqueeze = prs_unsqueeze
        self.prs_concat_method = prs_concat_method
        self.fmri_embed = FmriDiagEmbed(
            intermediate_vec, transformer_hidden_layers, num_heads_2DBert,
            sequence_length, bert_intermediate_size, concat_method, use_FC,
            use_merge_loss, transformer_dropout_rate, bert_attn_dropout,
            feature_map_size, feature_map_gen, ul_length)
        self._fronts()
        if self.FUSION:
            # models/func_struct.py _fusion: attention dropout runs at the
            # fusion drop rate too (model.py:1591)
            self.fusion = SwinFusionBackbone(
                fusion_embed_dim, fusion_ex_depths, fusion_depths,
                fusion_re_depths, fusion_ex_heads, fusion_heads,
                fusion_re_heads, img_size=intermediate_vec,
                window_size=window_size, mlp_ratio=mlp_ratio,
                drop_rate=fusion_drop, attn_drop_rate=fusion_drop,
                drop_path_rate=fusion_drop_path)
        depths, heads = size_preset(size_of_model)
        self.swin = SwinTransformerV2(
            (intermediate_vec, intermediate_vec), patch_size, swin_embed_dim,
            depths, heads, window_size, mlp_ratio,
            drop_path_rate=fusion_drop_path)

    def _fronts(self) -> None:
        """The combiner's modules between the embedder and the fusion."""

    @classmethod
    def from_config(cls, cfg) -> "_FuncStructBase":
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
            fusion_drop_path=cfg.fusion_drop_path_rate,
            use_unet_loss=cfg.use_unet_loss,
            use_unet_function=cfg.use_unet_function,
            use_unet_struct=cfg.use_unet_struct,
            prs_unsqueeze=cfg.prs_unsqueeze,
            prs_concat_method=cfg.prs_concat_method,
            feature_map_size=cfg.feature_map_size,
            feature_map_gen=cfg.feature_map_gen,
            ul_length=ultralow_length(cfg))

    def _embed(self, batch: Dict[str, torch.Tensor], generator
               ) -> Tuple[torch.Tensor, Dict]:
        if self.training and generator is None:
            raise ValueError("a training forward draws its dropout from an "
                             "explicit torch.Generator; pass generator=")
        return self.fmri_embed(batch.get("fmri_raw_sequence"),
                               batch["fmri_lowfreq_sequence"],
                               batch["fmri_ultralowfreq_sequence"],
                               generator)


class FuncStructCross(_FuncStructBase):
    """Dual BERTs -> diag embed -> SwinFusion with struct -> SwinV2."""

    FUSION = True

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        embed, aux = self._embed(batch, generator)
        fused = self.fusion(embed, batch["struct"].float(), generator)
        return {self.fine_tune_task: self.swin(fused, generator), **aux}


class FuncStructAdd(_FuncStructBase):
    """struct + diag embedding -> SwinV2 (JAX ``FuncStructAdd``)."""

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        embed, aux = self._embed(batch, generator)
        combined = batch["struct"].float() + embed
        return {self.fine_tune_task: self.swin(combined, generator), **aux}


class FuncStructTransfer(_FuncStructBase):
    """The diag embedding alone -> SwinV2 (JAX ``FuncStructTransfer``)."""

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        embed, aux = self._embed(batch, generator)
        return {self.fine_tune_task: self.swin(embed, generator), **aux}


class FuncStructUNetAdd(_FuncStructBase):
    """UNet-denoised struct + diag embedding -> SwinV2 (JAX
    ``FuncStructUNetAdd``)."""

    def _fronts(self) -> None:
        self.unet = UNet2D()

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        embed, aux = self._embed(batch, generator)
        struct = batch["struct"].float()
        with full_f32():
            denoised = self.unet(struct[:, None])[:, 0]
        out = {self.fine_tune_task: self.swin(denoised + embed, generator),
               **aux}
        if self.use_unet_loss:
            out.update({"fMRI_input": embed, "fMRI_output": embed,
                        "struct_input": struct, "struct_output": denoised})
        return out


class FuncStructUNetCross(_FuncStructBase):
    """The shared UNet on the embedding and/or the struct, then SwinFusion
    and SwinV2 (JAX ``FuncStructUNetCross``)."""

    FUSION = True

    def _fronts(self) -> None:
        if self.use_unet_function or self.use_unet_struct:
            self.unet = UNet2D()

    def _prs_latent(self, batch, generator) -> Optional[torch.Tensor]:
        return None

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        embed, aux = self._embed(batch, generator)
        struct = batch["struct"].float()
        latent = self._prs_latent(batch, generator)
        a, b = embed, struct
        with full_f32():
            if self.use_unet_function:
                a = self.unet(embed[:, None])[:, 0]
            if self.use_unet_struct:
                b = self.unet(struct[:, None], inject=latent,
                              concat_method=self.prs_concat_method)[:, 0]
        fused = self.fusion(a, b, generator)
        out = {self.fine_tune_task: self.swin(fused, generator), **aux}
        if self.use_unet_loss:
            out.update({"fMRI_input": embed, "fMRI_output": a,
                        "struct_input": struct, "struct_output": b})
        return out


PRS_CHANNELS = (64, 128, 256, 512, 1024)


class FuncStructUNetCrossPRS(FuncStructUNetCross):
    """+ the polygenic-score latent at the UNet's bottleneck on the struct
    (JAX ``FuncStructUNetCrossPRS``; module docstring)."""

    def _fronts(self) -> None:
        super()._fronts()
        self.conv_prs = ConvTranspose2d(1, 1, 3)
        if self.prs_unsqueeze == "single_convolution":
            self.up_prs = Conv2d(1, PRS_CHANNELS[-1], 3, padding=1)
        elif self.prs_unsqueeze == "multiple_convolution":
            for i, (cin, cout) in enumerate(zip((1,) + PRS_CHANNELS[:-1],
                                                PRS_CHANNELS)):
                setattr(self, f"up_prs{i + 1}", Conv2d(cin, cout, 3,
                                                        padding=1))

    def _prs_latent(self, batch, generator) -> torch.Tensor:
        prs = batch["prs"].float()                        # (B, 3)
        diag = torch.diag_embed(prs)[:, None]             # (B, 1, 3, 3)
        with full_f32():
            up = self.conv_prs(diag)                      # (B, 1, 5, 5)
            if self.prs_unsqueeze == "single_convolution":
                return self.up_prs(up)
            if self.prs_unsqueeze == "multiple_convolution":
                for i in range(len(PRS_CHANNELS)):
                    up = getattr(self, f"up_prs{i + 1}")(up)
                return up
        return up.expand(-1, PRS_CHANNELS[-1], -1, -1)
