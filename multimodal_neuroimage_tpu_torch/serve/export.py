"""Ahead-of-time export: a loaded Predictor -> one artifact that serves
without the model code (counterpart of multimodal_neuroimage_tpu/serve/export.py).

``export_model`` traces the Predictor's deterministic forward
(serve/predictor.py ``make_predict_step``) with ``torch.export.export``
(non-strict) at the Predictor's compute policy and writes it with
``torch.export.save``. The parameters are baked into the program as one
flat buffer already cast to the compute dtype (JAX ``_cast_leaf``): at the
bf16 policy a bf16 buffer that the graph widens to float32, which gives
every module the values ``weights_at`` rounds them to in the live
Predictor, in half the bytes of the float32 artifact. The batch is the
model's inputs as float32 tensors, cast to bf16 inside the graph under
that policy, as ``forward_at`` casts them. On the card the scores agree
with the live Predictor's to about a float32 ulp, not bit for bit: the
live model run eagerly on copies of a few of its weights (the SwinV2
blocks' ``qkv`` and ``fc1``) moves them as much, cuBLAS taking other
kernels for the copies (chip_smoke.py phase 16 holds the tolerance).

The hand-written kernels enter the graph as the registered ops of
ops/library.py, the counterpart of JAX's ``tpu_custom_call``: such an
artifact runs them on the card and their plain versions on the CPU, and
loads only where that module is importable. ``portable=True`` traces the
plain versions instead: the graph holds no registered op and runs with
``torch`` alone, at the plain versions' speed. An artifact holds the
device it was traced on; it serves there.

``dest + ".json"`` is JAX's sidecar: ``head``, the frozen ``threshold``,
the ``checkpoint`` and the ``batch_contract`` (each input's shape and
dtype), plus ``ops`` (the registered ops the graph calls), ``device``,
``compute_dtype``, ``portable``, ``tf32`` and ``flops``: the products of
one batch through the graph (obs/profiling.py ``graph_flops``, each
registered op by its kernel's formula), the count a served batch's
utilization divides by, the same with the registered ops and portable.

``ExportedModel`` / ``load_exported`` import ops/library.py alone, no model
module: they check a batch against the contract (a missing input raises
``KeyError``), return the head's raw values as float32 ``(B,)``, and
``predict`` post-processes them as the Predictor does. A program does not
record TF32's settings, which torch's default turns on for cuDNN's
convolutions: ``ExportedModel`` runs it without TF32
(``library.full_f32``), as the live model runs its forward, whatever the
loading process has set (the sidecar's ``"tf32": false``).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Mapping

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ops import library

_META_SUFFIX = ".json"


def _example_batch(pipe, records) -> Dict[str, torch.Tensor]:
    """The model inputs of one batch of ``records`` in the Predictor's gear
    (float32 tensors on its device): the input contract."""
    from multimodal_neuroimage_tpu_torch.data.loader import MODEL_INPUTS
    pipe.splits["__export__"] = list(records)
    for batch, _names in pipe.epoch("__export__", shuffle=False):
        return {k: batch[k] for k in MODEL_INPUTS if k in batch}
    raise ValueError("empty cohort: nothing to infer the input batch from")


class _Served(torch.nn.Module):
    """The predict step as one module: the parameters at the compute dtype
    (module docstring) and the model's buffers are its state, each buffer
    value held once (the blocks of one geometry carry equal shift masks and
    position indices, which would otherwise fill half a bf16 flagship's
    artifact); the model itself stays out of the module tree, its tensors
    replaced for the call (``torch.func.functional_call``)."""

    def __init__(self, model: torch.nn.Module, compute_dtype: str,
                 head: str):
        super().__init__()
        self._model = (model,)
        self.bf16 = compute_dtype == "bfloat16"
        self.head = head
        named = [(n, p.detach()) for n, p in model.named_parameters()]
        self.names = [n for n, _ in named]
        self.shapes = [p.shape for _, p in named]
        self.sizes = [p.numel() for _, p in named]
        flat = torch.cat([p.reshape(-1).float() for _, p in named])
        self.register_buffer("weights",
                             flat.to(torch.bfloat16) if self.bf16 else flat)
        held: List[torch.Tensor] = []
        self.buffer_slots = []
        for name, b in model.named_buffers():
            slot = next((i for i, h in enumerate(held)
                         if h.dtype == b.dtype and h.shape == b.shape
                         and torch.equal(h, b)), len(held))
            if slot == len(held):
                held.append(b)
                self.register_buffer(f"model_buffer_{slot}",
                                     b.detach().clone())
            self.buffer_slots.append((name, slot))

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        flat = self.weights.float() if self.bf16 else self.weights
        state = {n: t.view(s) for n, s, t in zip(
            self.names, self.shapes, flat.split(self.sizes))}
        for name, slot in self.buffer_slots:
            state[name] = getattr(self, f"model_buffer_{slot}")
        inputs = ({k: v.to(torch.bfloat16) for k, v in batch.items()}
                  if self.bf16 else dict(batch))
        out = torch.func.functional_call(self._model[0], state, (inputs,))
        return out[self.head].float().reshape(-1)


def graph_ops(program) -> List[str]:
    """The registered ops (ops/library.py) an exported program calls."""
    found = set()
    for node in program.graph.nodes:
        target = getattr(node.target, "_schema", None)
        if target is not None and target.name.startswith(
                library.NAMESPACE + "::"):
            found.add(target.name)
    return sorted(found)


def export_model(predictor, dest: str, portable: bool = False) -> str:
    """Trace ``predictor``'s deterministic forward and write it to ``dest``
    (``dest + ".json"``: the sidecar). ``portable``: the plain versions,
    no registered op. Returns ``dest``."""
    from multimodal_neuroimage_tpu_torch.nn.swinfusion import (
        set_compute_policy)
    from multimodal_neuroimage_tpu_torch.obs.profiling import graph_flops
    cfg = predictor.cfg
    example = _example_batch(predictor.pipe, predictor.records)
    served = _Served(predictor.model, cfg.compute_dtype, predictor.head)
    predictor.model.eval()
    set_compute_policy(cfg.compute_dtype)
    plain = (library.plain_versions() if portable
             else contextlib.nullcontext())
    with plain, torch.no_grad():
        program = torch.export.export(served, (example,), strict=False)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    torch.export.save(program, dest)
    meta = {
        "head": predictor.head,
        "threshold": predictor.threshold,
        "checkpoint": predictor.checkpoint_path,
        "batch_contract": {k: {"shape": list(v.shape),
                               "dtype": str(v.dtype).replace("torch.", "")}
                           for k, v in example.items()},
        "ops": graph_ops(program),
        "device": str(served.weights.device),
        "compute_dtype": cfg.compute_dtype,
        "portable": bool(portable),
        "tf32": False,
        "flops": graph_flops(program),
    }
    with open(dest + _META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return dest


class ExportedModel:
    """Inference from the artifact alone: no model code, no checkpoint."""

    def __init__(self, path: str):
        with open(path + _META_SUFFIX) as f:
            self.meta = json.load(f)
        self.program = torch.export.load(path)
        self._forward = self.program.module()
        self.head = self.meta["head"]
        self.threshold = float(self.meta["threshold"])
        self.device = torch.device(self.meta["device"])
        self._contract = self.meta["batch_contract"]

    def __call__(self, batch: Mapping) -> np.ndarray:
        """Raw head outputs (logits / regression values), float32 (B,)."""
        missing = set(self._contract) - set(batch)
        if missing:
            raise KeyError(f"batch missing exported inputs: {sorted(missing)}")
        b = {k: torch.as_tensor(batch[k], dtype=getattr(torch, c["dtype"]),
                                device=self.device)
             for k, c in self._contract.items()}
        with torch.no_grad(), library.full_f32():
            out = self._forward(b)
        return out.float().cpu().numpy()

    def predict(self, batch: Mapping) -> Dict[str, np.ndarray]:
        """Post-processed as ``Predictor.predict``: sigmoid probabilities
        and the frozen threshold's labels for a classification head."""
        raw = self(batch)
        if self.head == "binary_classification":
            prob = 1.0 / (1.0 + np.exp(-raw))
            return {"score": prob,
                    "label": (prob > self.threshold).astype(np.float32)}
        return {"score": raw}


def load_exported(path: str) -> ExportedModel:
    return ExportedModel(path)
