"""Training losses (counterpart of multimodal_neuroimage_tpu/train/losses.py).

Ported: the two prediction heads' criteria (``bce_with_logits`` for
binary classification, ``l1_loss`` for regression), the merge loss
(``merge_loss``: ``use_merge_loss`` on the two-channel net and the
combiners), the task's loss registry ``active_losses`` and
``compute_losses``. The other auxiliary losses (UNet, contrastive, mask,
reconstruction, intensity, perceptual) are not ported yet and raise,
naming ROADMAP M10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional

import torch

AUXILIARY = ("unet", "contrastive", "mask", "reconstruction", "intensity",
             "perceptual")


def _row_mean(per_elem: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes -> (B,)."""
    return per_elem.reshape(per_elem.shape[0], -1).mean(dim=1)


def _masked_mean(per_row: torch.Tensor,
                 valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of per-row values over the rows with ``valid`` 1 (all rows when
    None)."""
    if valid is None:
        return per_row.mean()
    v = valid.to(per_row.dtype)
    return (per_row * v).sum() / torch.clamp(v.sum(), min=1.0)


def l1_loss(pred: torch.Tensor, target: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.L1Loss (mean reduction); pad rows excluded when ``valid``."""
    return _masked_mean(_row_mean((pred - target).abs()), valid)


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss (mean), the JAX package's stable form
    max(x, 0) - x y + log1p(exp(-|x|))."""
    logits = logits.float()
    target = target.float()
    per = (torch.clamp(logits, min=0.0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    return _masked_mean(_row_mean(per), valid)


def merge_loss(processed_raw: torch.Tensor, merged: torch.Tensor,
               margin: float = 1.0,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge_Loss (reference losses.py:190-219): the cosine of every pair
    of a merged low + ultralow CLS (rows) and a raw CLS (columns); a
    diagonal pair adds its cosine, an off-diagonal pair max(0, margin -
    cos); the mean over the B^2 pairs, or over the nvalid^2 pairs of valid
    rows when ``valid`` masks a padded tail."""
    a = merged.float()
    b = processed_raw.float()
    an = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-12)
    bn = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-12)
    cos = an @ bn.T
    B = cos.shape[0]
    eye = torch.eye(B, dtype=cos.dtype, device=cos.device)
    per_pair = eye * cos + (1.0 - eye) * torch.clamp(margin - cos, min=0.0)
    if valid is None:
        return per_pair.sum() / (B * B)
    v = valid.to(cos.dtype)
    nv = torch.clamp(v.sum(), min=1.0)
    return (per_pair * v[:, None] * v[None, :]).sum() / (nv * nv)


@dataclass
class LossSpec:
    name: str
    factor: float = 1.0


def active_losses(task: str, fine_tune_task: str, *, use_merge_loss=False,
                  use_unet_loss=False, use_cont_loss=False,
                  use_mask_loss=False, intensity_factor=1.0,
                  perceptual_factor=1.0, reconstruction_factor=1.0
                  ) -> Dict[str, LossSpec]:
    """Which losses are active for a task, with their weights
    (loss_writer.py:181-201); raises for an auxiliary loss."""
    t = task.lower()
    out: Dict[str, LossSpec] = {}
    if "reconstruction" in t:
        out["perceptual"] = LossSpec("perceptual", perceptual_factor)
        out["reconstruction"] = LossSpec("reconstruction",
                                         reconstruction_factor)
        out["intensity"] = LossSpec("intensity", intensity_factor)
        if "tran" in t and use_cont_loss:
            out["contrastive"] = LossSpec("contrastive")
        if "tran" in t and use_mask_loss:
            out["mask"] = LossSpec("mask")
    elif t in ("lowfreqbert", "2dbert", "funcstruct"):
        if use_merge_loss:
            out["merge"] = LossSpec("merge")
        if use_unet_loss:
            out["unet"] = LossSpec("unet")
        out[fine_tune_task] = LossSpec(fine_tune_task)
    elif t in ("test", "vit", "swinfusion"):
        out[fine_tune_task] = LossSpec(fine_tune_task)
    aux = [name for name in out if name in AUXILIARY]
    if aux:
        raise NotImplementedError(f"auxiliary losses {aux} are not ported "
                                  f"to PyTorch yet (ROADMAP M10)")
    return out


def compute_losses(outputs: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor],
                   specs: Mapping[str, LossSpec]) -> Dict[str, torch.Tensor]:
    """Every active loss from the model outputs and the batch, weighted,
    plus their sum under 'total'. ``batch['valid']`` (B,) excludes pad rows
    when present."""
    target = batch.get("target")
    valid = batch.get("valid")
    vals: Dict[str, torch.Tensor] = {}
    for name, spec in specs.items():
        if name == "binary_classification":
            v = bce_with_logits(outputs[name].squeeze(-1), target, valid)
        elif name == "regression":
            v = l1_loss(outputs[name].squeeze(-1).float(), target.float(),
                        valid)
        elif name == "merge":
            v = merge_loss(outputs["processed_raw"],
                           outputs["embedding_per_ROIs"], valid=valid)
        else:
            raise NotImplementedError(f"loss {name!r} is not ported to "
                                      f"PyTorch yet (ROADMAP M10)")
        vals[name] = v * spec.factor
    vals["total"] = (sum(vals.values()) if vals
                     else torch.zeros((), dtype=torch.float32))
    return vals
