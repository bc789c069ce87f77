"""Single-modality fMRI models (counterpart of multimodal_neuroimage_tpu/models/fmri_nets.py).

Ported: ``TransformerNet``, the phase-1 2DBERT (reference model.py:194-239):
a temporal BERT over ``fmri_sequence`` (B, T, R) and a linear head on the
pooled CLS. At HCP length (T = 1200 + CLS) its layers take the K6 route
(nn/bert.py). ``TransformerNetTwoChannels``, ``TransformerNetCrossAttention``
and ``TimeProj`` are not ported yet (ROADMAP M7).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.bert import TemporalBert
from multimodal_neuroimage_tpu_torch.nn.common import Linear


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
        if self.training and generator is None:
            raise ValueError("a training forward draws its dropout from an "
                             "explicit torch.Generator; pass generator=")
        t = self.transformer(batch["fmri_sequence"], generator)
        return {"reconstructed_fmri_sequence": t["sequence"],
                "embedding_per_ROIs": t["cls"],
                self.fine_tune_task: self.regression_head(t["cls"])}
