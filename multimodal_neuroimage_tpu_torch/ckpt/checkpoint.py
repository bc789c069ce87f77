"""The port's checkpoint format (counterpart of multimodal_neuroimage_tpu/ckpt/checkpoint.py).

One ``torch.save`` file holding ``{"state_dict": ..., "metadata": ...}``;
the metadata carries the frozen g-mean validation threshold as
``val_threshold``, which the Predictor reads as the JAX package's does.
Files are read with ``weights_only=True``: tensors and plain containers
only, no arbitrary unpickling.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Mapping, Optional

import torch


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    metadata: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()},
               "metadata": dict(metadata or {})}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{"state_dict": {name: tensor}, "metadata": dict}."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return {"state_dict": payload["state_dict"],
            "metadata": payload.get("metadata", {})}


def latest_checkpoint(folder: str, pattern: str = "*.ckpt") -> Optional[str]:
    files = glob.glob(os.path.join(folder, pattern))
    return max(files, key=os.path.getmtime) if files else None


class BestCheckpointPolicy:
    """Best-validation save policy (JAX ckpt/checkpoint.py
    BestCheckpointPolicy, reference trainer.py:660-690): classification
    keeps ``{title}_BEST_val_AUROC.ckpt`` (and the accuracy file when AUROC
    did not improve), regression ``{title}_BEST_val_loss.ckpt``. The
    metadata carries the frozen ``val_threshold`` the Predictor reads.
    Restoring the best-so-far values from files on disk comes with
    auto-resume (ROADMAP M5)."""

    def __init__(self, folder: str, title: str,
                 fine_tune_task: str = "binary_classification"):
        self.folder = folder
        self.title = title
        self.task = fine_tune_task
        self.best_auroc = 0.0
        self.best_acc = 0.0
        self.best_loss = float("inf")
        os.makedirs(folder, exist_ok=True)

    def _save(self, kind: str, state_dict, metadata) -> str:
        return save_checkpoint(os.path.join(
            self.folder, f"{self.title}_BEST_val_{kind}.ckpt"), state_dict,
            metadata)

    def update(self, *, state_dict: Mapping[str, torch.Tensor],
               metadata: Dict[str, Any], val_auroc: Optional[float] = None,
               val_acc: Optional[float] = None,
               val_loss: Optional[float] = None) -> Optional[str]:
        """Save if a tracked metric improved; returns the path written."""
        meta = dict(metadata, best_auroc=self.best_auroc,
                    best_acc=self.best_acc, best_loss=self.best_loss)
        if self.task == "regression":
            if val_loss is not None and val_loss < self.best_loss:
                self.best_loss = meta["best_loss"] = val_loss
                return self._save("loss", state_dict, meta)
            return None
        wrote = None
        if val_auroc is not None and val_auroc > self.best_auroc:
            self.best_auroc = meta["best_auroc"] = val_auroc
            wrote = self._save("AUROC", state_dict, meta)
        if val_acc is not None and val_acc > self.best_acc:
            self.best_acc = meta["best_acc"] = val_acc
            if wrote is None:
                wrote = self._save("accuracy", state_dict, meta)
        return wrote
