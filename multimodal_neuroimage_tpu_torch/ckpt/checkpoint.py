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
