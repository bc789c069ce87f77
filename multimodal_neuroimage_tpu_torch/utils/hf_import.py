"""Import HuggingFace ``BertModel`` weights into the port's BERT encoder
(counterpart of multimodal_neuroimage_tpu/utils/hf_import.py).

The port's ``BertEncoder`` (nn/bert.py) keeps HuggingFace's parameter names
and layouts (``embeddings.*``, ``encoder.layer.{i}.*``, ``pooler.dense``:
torch ``(out, in)`` weights), so the map is a selection: the tensors the
encoder has, taken from under ``prefix``, as float32 copies. What differs
from the JAX map is only that no transpose or stacking is needed. Two
things are left out or cut, as in the JAX map:

* ``embeddings.word_embeddings`` and the ``position_ids`` buffer: the
  encoder is driven by ``inputs_embeds``;
* ``embeddings.token_type_embeddings`` keeps its row 0 only (HF's
  ``type_vocab_size`` is 2 by default; with ``inputs_embeds`` only type 0
  is used), ``(1, H)``.

Inside ``TemporalBert`` the encoder is ``bert.``: give the result that
prefix (utils/torch_import.py ``reference_state`` does for every
``BertEncoder`` of a module). This module does not import
``transformers``: it takes any mapping of names to tensors or arrays, a
``BertModel.state_dict()`` among them.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

State = Dict[str, torch.Tensor]

_LAYER = ("attention.self.query", "attention.self.key",
          "attention.self.value", "attention.output.dense",
          "attention.output.LayerNorm", "intermediate.dense", "output.dense",
          "output.LayerNorm")


def tensor(x) -> torch.Tensor:
    """A float32 CPU copy of a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(x, np.float32, order="C", copy=True))


def bert_state_from_hf(state: Mapping[str, Any], num_layers: int,
                       prefix: str = "") -> State:
    """A ``transformers.BertModel`` state dict (its tensors under
    ``prefix``, e.g. ``transformer_low.bert.`` in a reference
    ``Transformer_Block``) -> the port's ``BertEncoder`` state with
    ``num_layers`` layers."""
    def g(name):
        return tensor(state[prefix + name])

    out: State = {
        "embeddings.position_embeddings.weight": g(
            "embeddings.position_embeddings.weight"),
        "embeddings.token_type_embeddings.weight": g(
            "embeddings.token_type_embeddings.weight")[0:1].clone(),
        "embeddings.LayerNorm.weight": g("embeddings.LayerNorm.weight"),
        "embeddings.LayerNorm.bias": g("embeddings.LayerNorm.bias"),
        "pooler.dense.weight": g("pooler.dense.weight"),
        "pooler.dense.bias": g("pooler.dense.bias"),
    }
    for i in range(num_layers):
        for sub in _LAYER:
            for leaf in ("weight", "bias"):
                name = f"encoder.layer.{i}.{sub}.{leaf}"
                out[name] = g(name)
    return out
