"""Serving: checkpoint -> per-subject predictions (counterpart of multimodal_neuroimage_tpu/serve/predictor.py).

``Predictor`` loads a port checkpoint once, scores in-memory requests
``{subject, fmri: (84, T) raw series, struct: (84, 84)}`` in batches of
``cfg.batch_size``, sigmoids each window's logit and averages the
probabilities per subject (the frozen ``val_threshold`` was fit on
mean-of-sigmoids), labels subjects against that threshold, and can write
``predictions.csv``. Single process: no mesh, no allgather.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import load_checkpoint
from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                         multimodal_item)
from multimodal_neuroimage_tpu_torch.models.registry import create_model

HEADS = ("binary_classification", "regression")
MODEL_INPUTS = ("fmri_raw_sequence", "fmri_lowfreq_sequence",
                "fmri_ultralowfreq_sequence", "struct")


def check_supported(cfg) -> None:
    """Refuse configurations the port does not run yet, rather than
    quietly running something else."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the port runs float32 only;"
            f" the bf16 policy (f32 BERT stream + bf16 matmuls) is ROADMAP "
            f"N1")
    if cfg.preprocess != "host":
        raise NotImplementedError(
            f"preprocess={cfg.preprocess!r}: the port runs the host band "
            f"split only; the on-device FIR gear is ROADMAP N2")


def make_predict_step(model: torch.nn.Module, compute_dtype: str = "float32",
                      device: str = "cuda"):
    """Inference forward returning only the prediction heads (no losses, so
    unlabeled batches work). ``batch`` maps input names to arrays."""
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: float32 only (ROADMAP N1)")
    model.eval()

    @torch.no_grad()
    def predict_step(batch: Mapping) -> Dict[str, torch.Tensor]:
        inputs = {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                                     device=device)
                  for k in MODEL_INPUTS if k in batch}
        out = model(inputs)
        return {k: out[k].float() for k in HEADS if k in out}

    return predict_step


class Predictor:
    """Load once, predict many."""

    def __init__(self, cfg, checkpoint: str,
                 records: Optional[List[Mapping]] = None,
                 device: str = "cuda"):
        check_supported(cfg)
        if records is None:
            raise NotImplementedError(
                "scoring an on-disk cohort (subject index, pandas) is ROADMAP "
                "N5; pass in-memory records")
        self.cfg = cfg
        self.records = list(records)
        self.checkpoint_path = checkpoint
        ckpt = load_checkpoint(checkpoint)
        self.model = create_model(cfg)
        self.model.load_state_dict(ckpt["state_dict"])
        self.model.to(device)
        self.threshold = float(ckpt["metadata"].get("val_threshold") or 0.5)
        self.head = ("regression" if cfg.fine_tune_task == "regression"
                     else "binary_classification")
        self.step = make_predict_step(self.model, cfg.compute_dtype, device)

    def batches(self) -> Iterator[Tuple[Dict[str, np.ndarray], List[str]]]:
        """Host-preprocessed batches of ``cfg.batch_size`` requests."""
        bs = self.cfg.batch_size
        for i in range(0, len(self.records), bs):
            yield collate([multimodal_item(r, self.cfg)
                           for r in self.records[i:i + bs]])

    def predict(self, write_csv: Optional[str] = None
                ) -> Dict[str, Dict[str, float]]:
        """Score every request; returns {subject: {"score", "label"?}} with
        repeated windows of a subject mean-ensembled. Classification scores
        are sigmoid probabilities labelled at the frozen threshold."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        classify = self.head == "binary_classification"
        for batch, names in self.batches():
            vals = self.step(batch)[self.head].reshape(-1)
            if classify:
                vals = torch.sigmoid(vals)
            for name, v in zip(names, vals.cpu().tolist()):
                sums[name] = sums.get(name, 0.0) + v
                counts[name] = counts.get(name, 0) + 1
        out: Dict[str, Dict[str, float]] = {}
        for name in sums:
            mean = sums[name] / counts[name]
            out[name] = ({"score": mean, "label": float(mean > self.threshold)}
                         if classify else {"score": mean})
        if write_csv:
            self._write_csv(write_csv, out)
        return out

    def _write_csv(self, path: str, out: Dict[str, Dict[str, float]]) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cols = ["subject", "score"] + (
            ["label"] if self.head == "binary_classification" else [])
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(cols)
            for subject in sorted(out):
                w.writerow([subject] + [out[subject][c] for c in cols[1:]])
