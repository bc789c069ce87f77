"""Single-modality fMRI models (counterpart of multimodal_neuroimage_tpu/models/fmri_nets.py).

* ``TransformerNet``, the phase-1 2DBERT (reference model.py:194-239): a
  temporal BERT over ``fmri_sequence`` (B, T, R) and a linear head on the
  pooled CLS. At HCP length (T = 1200 + CLS) its layers take the K6 route
  (nn/bert.py), below it K1.
* ``TransformerNetTwoChannels``, phase 2's two-channel BERT (model.py:
  241-339): temporal BERTs over ``fmri_lowfreq_sequence`` and
  ``fmri_ultralowfreq_sequence`` (K1, or K6 at HCP length), their CLS
  concatenated and projected (``concat``) or multiplied (``hadamard``);
  ``use_merge_loss`` adds a third BERT over ``fmri_sequence`` whose CLS is
  ``processed_raw`` (the merge loss's). Under ``feature_map_size=
  'different'`` the ultralow BERT has 128 + 1 positions and hidden dropout
  0.2, fed by ``TimeProj(128)`` under ``feature_map_gen='convolution_ul'``.
* ``TransformerNetCrossAttention``, phase 2's default, the MulT net
  (model.py:341-552): temporal projections (``TimeProj``), the
  bidirectional crossmodal encoders ``trans_l_with_u`` / ``trans_u_with_l``
  (nn/crossmodal.py, plain torch: JAX runs no Pallas kernel there), the
  ``deconv`` re-expansion, the mixing (``U2L_and_L2U`` with ``concat`` or
  ``hadamard``, ``U2L``, ``L2U``), a self-attention memory of
  ``max(nlevels, 3)`` layers and the last time step's readout.
* ``TimeProj``: the reference's ``Conv1d(T_in, T_out, 1, bias=False)``
  over the time axis, a dense map across time a feature; ``weight`` is
  torch's ``(T_out, T_in, 1)``.

Phase 2 reads the bands, which only ``fmri_type='divided_frequency'`` (or
``timeseries_and_frequency``) makes (data/filters.py); at the default
``timeseries`` the batch has no ``fmri_lowfreq_sequence`` and the forward
raises ``KeyError``, as JAX's does. Every model's ``forward(batch,
generator)`` draws its dropout seeds from the host ``generator`` in
training.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.bert import TemporalBert
from multimodal_neuroimage_tpu_torch.nn.common import (Linear, draw_seed,
                                                       dropout)
from multimodal_neuroimage_tpu_torch.nn.crossmodal import (
    MultTransformerEncoder)

# the ultralow band's time length where it is not ``sequence_length``
# (data/filters.py): a spectrum (``timeseries_and_frequency``), and the
# band resampled 3:1 (``feature_map_gen='resample'`` at ``different``)
SPECTRUM_LENGTH = 184
RESAMPLED_LENGTH = 128
# the ultralow BERT's series under ``feature_map_size='different'``
# (model.py:309-315: 128 is near 368 // 3, a multiple of 16)
DIFFERENT_LENGTH = 128


def ultralow_length(cfg) -> int:
    """The time length of the batch's ``fmri_ultralowfreq_sequence`` for
    ``cfg`` (data/filters.py ``preprocess_fmri_host``)."""
    if cfg.fmri_type == "timeseries_and_frequency":
        return SPECTRUM_LENGTH
    if (cfg.feature_map_gen == "resample"
            and cfg.feature_map_size == "different"):
        return RESAMPLED_LENGTH
    return cfg.sequence_length


def _need_generator(model: nn.Module, generator) -> None:
    if model.training and generator is None:
        raise ValueError("a training forward draws its dropout from an "
                         "explicit torch.Generator; pass generator=")


class TimeProj(nn.Conv1d):
    """(B, T_in, D) -> (B, T_out, D): a dense map across time, the
    reference's ``Conv1d(T_in, T_out, kernel_size=1, bias=False)``, in its
    input's dtype (JAX's einsum with the kernel cast to it)."""

    def __init__(self, t_in: int, t_out: int):
        super().__init__(t_in, t_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("btd,ut->bud", x,
                            self.weight[:, :, 0].to(x.dtype))


class TransformerNet(nn.Module):
    """Temporal BERT + ``regression_head`` Dense(1) on the CLS. The BERT's
    attention dropout is the HF default 0.1, as in the JAX model (its
    ``TemporalBert`` is built without ``bert_attn_dropout``)."""

    def __init__(self, intermediate_vec: int = 84,
                 transformer_hidden_layers: int = 16,
                 num_heads_2DBert: int = 12, sequence_length: int = 368,
                 transformer_dropout_rate: float = 0.1,
                 bert_intermediate_size: int = 3072,
                 fine_tune_task: str = "binary_classification"):
        super().__init__()
        self.fine_tune_task = fine_tune_task
        self.transformer = TemporalBert(
            intermediate_vec, transformer_hidden_layers, num_heads_2DBert,
            sequence_length + 1, bert_intermediate_size,
            hidden_dropout=transformer_dropout_rate)
        self.regression_head = Linear(intermediate_vec, 1)

    @classmethod
    def from_config(cls, cfg) -> "TransformerNet":
        return cls(intermediate_vec=cfg.intermediate_vec,
                   transformer_hidden_layers=cfg.transformer_hidden_layers,
                   num_heads_2DBert=cfg.num_heads_2DBert,
                   sequence_length=cfg.sequence_length,
                   transformer_dropout_rate=cfg.transformer_dropout_rate,
                   bert_intermediate_size=cfg.bert_intermediate_size,
                   fine_tune_task=cfg.fine_tune_task)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        _need_generator(self, generator)
        t = self.transformer(batch["fmri_sequence"], generator)
        return {"reconstructed_fmri_sequence": t["sequence"],
                "embedding_per_ROIs": t["cls"],
                self.fine_tune_task: self.regression_head(t["cls"])}


class TransformerNetTwoChannels(nn.Module):
    """Low and ultralow temporal BERTs (the HF attention dropout 0.1, as
    in JAX: built without ``bert_attn_dropout``), the CLS fused by
    ``proj_layer`` (concat) or a product (hadamard), ``regression_head``
    on it; ``transformer_raw`` over ``fmri_sequence`` with
    ``use_merge_loss``. ``ul_length`` is the ultralow band's length
    (``ultralow_length``), which ``proj_u`` takes."""

    def __init__(self, intermediate_vec: int = 84,
                 transformer_hidden_layers: int = 16,
                 num_heads_2DBert: int = 12, sequence_length: int = 368,
                 transformer_dropout_rate: float = 0.1,
                 bert_intermediate_size: int = 3072,
                 fine_tune_task: str = "binary_classification",
                 concat_method: str = "concat", feature_map_size: str = "same",
                 feature_map_gen: str = "no", use_merge_loss: bool = False,
                 ul_length: Optional[int] = None):
        super().__init__()
        self.fine_tune_task = fine_tune_task

        def bert(max_pos, hidden_dropout):
            return TemporalBert(intermediate_vec, transformer_hidden_layers,
                                num_heads_2DBert, max_pos,
                                bert_intermediate_size, hidden_dropout)

        dr = transformer_dropout_rate
        different = feature_map_size == "different"
        self.transformer_raw = (bert(sequence_length + 1, dr)
                                if use_merge_loss else None)
        self.proj_u = (TimeProj(ul_length or sequence_length,
                                DIFFERENT_LENGTH)
                       if different and feature_map_gen == "convolution_ul"
                       else None)
        self.transformer_low = bert(sequence_length + 1, dr)
        self.transformer_ultralow = (bert(DIFFERENT_LENGTH + 1, 0.2)
                                     if different
                                     else bert(sequence_length + 1, dr))
        self.proj_layer = (Linear(2 * intermediate_vec, intermediate_vec)
                           if concat_method == "concat" else None)
        self.regression_head = Linear(intermediate_vec, 1)

    @classmethod
    def from_config(cls, cfg) -> "TransformerNetTwoChannels":
        return cls(intermediate_vec=cfg.intermediate_vec,
                   transformer_hidden_layers=cfg.transformer_hidden_layers,
                   num_heads_2DBert=cfg.num_heads_2DBert,
                   sequence_length=cfg.sequence_length,
                   transformer_dropout_rate=cfg.transformer_dropout_rate,
                   bert_intermediate_size=cfg.bert_intermediate_size,
                   fine_tune_task=cfg.fine_tune_task,
                   concat_method=cfg.concat_method,
                   feature_map_size=cfg.feature_map_size,
                   feature_map_gen=cfg.feature_map_gen,
                   use_merge_loss=cfg.use_merge_loss,
                   ul_length=ultralow_length(cfg))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        _need_generator(self, generator)
        x_l = batch["fmri_lowfreq_sequence"]
        x_u = batch["fmri_ultralowfreq_sequence"]
        out: Dict[str, torch.Tensor] = {}
        if self.transformer_raw is not None:
            out["processed_raw"] = self.transformer_raw(
                batch["fmri_sequence"], generator)["cls"]
        if self.proj_u is not None:
            x_u = self.proj_u(x_u)
        low = self.transformer_low(x_l, generator)["cls"]
        ul = self.transformer_ultralow(x_u, generator)["cls"]
        if self.proj_layer is not None:
            cls = self.proj_layer(torch.cat([low, ul], dim=1))
        else:
            cls = low * ul
        out["embedding_per_ROIs"] = cls
        out[self.fine_tune_task] = self.regression_head(cls)
        return out


class TransformerNetCrossAttention(nn.Module):
    """The MulT net: the time projections, ``trans_l_with_u`` (queries
    from the low band, at ``attn_dropout_u``) and ``trans_u_with_l`` (at
    ``attn_dropout``), ``deconv`` under ``different`` or the
    ``timeseries_and_frequency`` bands, the mixing, and ``out_layer2`` on
    the last time step (``out_layer1`` first under concat mixing). Only
    the modules of the configured branch exist, as in JAX. Under ``same``
    with ``convolution_ul+l`` ONE ``proj_l`` maps both bands, and only the
    low band takes the embedding dropout (model.py:484-488)."""

    def __init__(self, intermediate_vec: int = 84, num_heads_mult: int = 12,
                 nlevels: int = 12, sequence_length: int = 368,
                 attn_dropout: float = 0.1, attn_dropout_u: float = 0.0,
                 relu_dropout: float = 0.1, res_dropout: float = 0.1,
                 embed_dropout: float = 0.25, attn_mask: bool = True,
                 fine_tune_task: str = "binary_classification",
                 feature_map_size: str = "same",
                 feature_map_gen: str = "convolution_ul+l",
                 mixing: str = "U2L_and_L2U", concat_method: str = "concat",
                 fmri_type: str = "divided_frequency",
                 ul_length: Optional[int] = None):
        super().__init__()
        d, S = intermediate_vec, sequence_length
        self.fine_tune_task = fine_tune_task
        self.embed_dropout = embed_dropout
        self.different = feature_map_size == "different"
        self.mixing, self.concat_method = mixing, concat_method
        ul_length = ul_length or S

        def encoder(dim, rate, layers):
            return MultTransformerEncoder(dim, num_heads_mult, layers, rate,
                                          relu_dropout, res_dropout,
                                          embed_dropout, attn_mask)

        self.proj_l = (TimeProj(S, S) if feature_map_gen == "convolution_ul+l"
                       else None)
        self.proj_u = TimeProj(ul_length, S // 2) if self.different else None
        self.trans_l_with_u = encoder(d, attn_dropout_u, nlevels)
        self.trans_u_with_l = encoder(d, attn_dropout, nlevels)
        t_u = (S // 2 if self.different
               else S if self.proj_l is not None else ul_length)
        self.deconv = (TimeProj(t_u, S) if self.different
                       or fmri_type == "timeseries_and_frequency" else None)
        mem = max(nlevels, 3)
        if mixing == "U2L_and_L2U" and concat_method == "concat":
            self.trans_mem = encoder(2 * d, attn_dropout, mem)
            self.out_layer1 = Linear(2 * d, d)
        elif mixing in ("U2L", "U2L_and_L2U"):
            self.trans_l_mem = encoder(d, attn_dropout, mem)
        else:
            self.trans_u_mem = encoder(d, attn_dropout_u, mem)
        self.out_layer2 = Linear(d, 1)

    @classmethod
    def from_config(cls, cfg) -> "TransformerNetCrossAttention":
        return cls(intermediate_vec=cfg.intermediate_vec,
                   num_heads_mult=cfg.num_heads_mult, nlevels=cfg.nlevels,
                   sequence_length=cfg.sequence_length,
                   attn_dropout=cfg.attn_dropout,
                   attn_dropout_u=cfg.attn_dropout_u,
                   relu_dropout=cfg.relu_dropout, res_dropout=cfg.res_dropout,
                   embed_dropout=cfg.embed_dropout, attn_mask=cfg.attn_mask,
                   fine_tune_task=cfg.fine_tune_task,
                   feature_map_size=cfg.feature_map_size,
                   feature_map_gen=cfg.feature_map_gen, mixing=cfg.mixing,
                   concat_method=cfg.concat_method, fmri_type=cfg.fmri_type,
                   ul_length=ultralow_length(cfg))

    def _drop(self, x, generator):
        if self.training and self.embed_dropout > 0.0:
            return dropout(x, self.embed_dropout, draw_seed(generator))
        return x

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        _need_generator(self, generator)
        x_l = batch["fmri_lowfreq_sequence"]
        x_u = batch["fmri_ultralowfreq_sequence"]
        proj_l = self._drop(x_l, generator)
        if self.proj_l is not None:
            proj_l = self.proj_l(proj_l)
        if self.different:
            proj_u = self.proj_u(x_u)
        else:
            proj_u = x_u if self.proj_l is None else self.proj_l(x_u)
        h_l = self.trans_l_with_u(proj_l, proj_u, proj_u, generator)
        h_u = self.trans_u_with_l(proj_u, proj_l, proj_l, generator)
        if self.deconv is not None:
            h_u = self.deconv(h_u)
        # the readout takes the last time step, padding or not (JAX's)
        if hasattr(self, "trans_mem"):
            h = self.trans_mem(torch.cat([h_l, h_u], dim=2),
                               generator=generator)
            out_cls = self.out_layer1(h[:, -1])
        elif hasattr(self, "trans_l_mem"):
            h = h_l * h_u if self.mixing == "U2L_and_L2U" else h_l
            out_cls = self.trans_l_mem(h, generator=generator)[:, -1]
        else:
            out_cls = self.trans_u_mem(h_u, generator=generator)[:, -1]
        return {"embedding_per_ROIs": out_cls,
                self.fine_tune_task: self.out_layer2(out_cls)}
