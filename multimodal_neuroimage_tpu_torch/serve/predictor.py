"""Serving: checkpoint -> per-subject predictions (counterpart of multimodal_neuroimage_tpu/serve/predictor.py).

``Predictor`` loads a port checkpoint once (the one named, else
``ckpt/checkpoint.py`` ``default_checkpoint``) and scores either the
cohort on disk that ``cfg`` points at (indexed with
``require_target=False``, so unlabeled subjects are scored too) or
in-memory requests (the flagship's ``{subject, fmri: (84, T) raw series,
struct: (84, 84)}``, HCP's ``{subject, fmri: (22, T <= 1200)}``; the
structural datasets' 84x84 matrices: ``{subject, dti}`` (DTI), ``{subject,
smri}`` (sMRI), ``{subject, struct}`` (DTI+sMRI), ``{subject, smri,
dti}`` (struct)). The batches come from a ``DataPipeline``
(data/loader.py) in the config's gear, padded to ``cfg.batch_size`` with
the pad rows dropped from the scores, as the JAX package pads them.

A ``SwinClassifierUNet`` normalises with the statistics of its batch even
in inference (nn/unet.py, as the JAX model defines it), so its score for a
subject depends on the other rows of the batch, pad rows included:
``run_predict`` equals an in-memory ``Predictor`` only where both see the
same batches (the same records in the same order). It
sigmoids each window's logit and averages the probabilities per subject
(the frozen ``val_threshold`` was fit on mean-of-sigmoids), labels subjects
against that threshold, and can write ``predictions.csv``; ``run_predict``
does so into the experiment folder. Single process: no mesh, no
allgather.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
    default_checkpoint, load_checkpoint)
from multimodal_neuroimage_tpu_torch.data.index import build_subject_index
from multimodal_neuroimage_tpu_torch.data.loader import (MODEL_INPUTS,
                                                          DataPipeline)
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn.swinfusion import set_compute_policy
from multimodal_neuroimage_tpu_torch.train.state import (check_compute_dtype,
                                                         flatten_parameters,
                                                         forward_at, weights_at)

HEADS = ("binary_classification", "regression")


def make_predict_step(model: torch.nn.Module, compute_dtype: str = "float32",
                      device: str = "cuda"):
    """Inference forward returning only the prediction heads (no losses, so
    unlabeled batches work) at ``compute_dtype`` (train/state.py
    ``bf16_weights`` and ``forward_at``: at bf16 the parameters rounded and
    the inputs cast to bf16, the heads widened to float32). ``batch`` maps input names to arrays."""
    check_compute_dtype(compute_dtype)
    model.eval()

    @torch.no_grad()
    def predict_step(batch: Mapping) -> Dict[str, torch.Tensor]:
        set_compute_policy(compute_dtype)
        inputs = {k: torch.as_tensor(batch[k], dtype=torch.float32,
                                     device=device)
                  for k in MODEL_INPUTS if k in batch}
        with weights_at(model, compute_dtype):
            out = forward_at(model, inputs, compute_dtype)
        return {k: out[k].float() for k in HEADS if k in out}

    return predict_step


class Predictor:
    """Load once, predict many."""

    def __init__(self, cfg, checkpoint: Optional[str] = None,
                 records: Optional[List[Mapping]] = None,
                 device: str = "cuda"):
        if records is None:
            records = build_subject_index(cfg, require_target=False)
        self.pipe = DataPipeline(cfg, splits={"predict": list(records)},
                                 device=device)
        checkpoint = checkpoint or default_checkpoint(cfg)
        if checkpoint is None:
            raise FileNotFoundError(
                f"no checkpoint found in {cfg.experiment_folder!r}; pass "
                f"checkpoint= or set cfg.model_weights_path")
        self.cfg = cfg
        self.device = device
        self.checkpoint_path = checkpoint
        ckpt = load_checkpoint(checkpoint)
        self.model = create_model(cfg)
        self.model.load_state_dict(ckpt["state_dict"])
        self.model.to(device)
        if cfg.compute_dtype == "bfloat16":
            # one buffer, rounded and restored as one tensor each step
            flatten_parameters(self.model)
        self.threshold = float(ckpt["metadata"].get("val_threshold") or 0.5)
        self.head = ("regression" if cfg.fine_tune_task == "regression"
                     else "binary_classification")
        self.step = make_predict_step(self.model, cfg.compute_dtype, device)

    def batches(self) -> Iterator[Tuple[Dict, List]]:
        """Batches of ``cfg.batch_size`` subjects in order, preprocessed in
        the config's gear (the device gear's bands on the device), the
        last padded (pad rows named None)."""
        return self.pipe.epoch("predict", shuffle=False)

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
                if name is None:        # tail padding
                    continue
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


def run_predict(cfg, device: str = "cuda") -> Dict[str, Dict[str, float]]:
    """Score the cohort on disk that ``cfg`` points at with its default
    checkpoint and write ``predictions.csv`` into the experiment folder.
    The batches are the index's records in order, so a UNet model's scores
    equal an in-memory ``Predictor``'s only on the same records in the same
    order (module docstring)."""
    pred = Predictor(cfg, device=device)
    dest = os.path.join(cfg.experiment_folder or ".", "predictions.csv")
    out = pred.predict(write_csv=dest)
    print(f"[predict] {len(out)} subjects -> {dest} "
          f"(checkpoint {pred.checkpoint_path}, "
          f"threshold {pred.threshold:.4f})")
    return out
