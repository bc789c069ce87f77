"""Training losses (counterpart of multimodal_neuroimage_tpu/train/losses.py).

The reference's loss zoo (reference losses.py, registry at
loss_writer.py:162-201) as batched torch expressions: the prediction
heads' criteria (``bce_with_logits``, ``l1_loss``), the auxiliary losses
(``merge_loss``, ``unet_loss``, ``contrastive_loss``, ``mask_loss``,
``reconstruction_loss``, ``intensity_loss`` over ``intensity_voxel_mask``)
and the registry ``active_losses`` / ``compute_losses``. The perceptual
loss needs weights of its own (nn/perceptual.py ``PerceptualLoss``): the
Trainer builds it when the registry activates it and hands it over in
``extra_fns``. Every loss takes ``valid`` (a (B,) 0/1 vector) and excludes
pad rows exactly, as the JAX package's do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch


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


def mse_loss(pred: torch.Tensor, target: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _masked_mean(_row_mean((pred - target) ** 2), valid)


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


def contrastive_loss(seq: torch.Tensor, margin: float = 60000.0,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cont_Loss (reference losses.py:128-156): over the ordered timestep
    pairs a > b, the squared distance summed over (batch, embedding);
    adjacent pairs pull together, the others push apart to ``margin``;
    divided by T (T - 1) 1000. The distances in the Gram form |a|^2 + |b|^2
    - 2 a.b (JAX's formula: its float32 cancellation is part of the
    value); a batch sum, so zeroed pad rows drop out exactly."""
    if valid is not None:
        seq = seq * valid.to(seq.dtype)[:, None, None]
    B, T, E = seq.shape
    x = seq.float().transpose(0, 1).reshape(T, B * E)
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    a = torch.arange(T, device=seq.device)
    diff = a[:, None] - a[None, :]
    per_pair = torch.where(diff == 1, torch.clamp(margin - d2, min=0.0), d2)
    total = torch.where(diff > 0, per_pair, torch.zeros_like(d2)).sum()
    return total / (T * (T - 1) * 1000.0)


def mask_loss(encoded: torch.Tensor, mask_idx: torch.Tensor,
              reconstructed: torch.Tensor, margin: float = 15000.0,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mask_Loss (reference losses.py:223-279): each masked timestep's
    reconstruction against every encoded timestep, neighbours within 1
    pulled, the others pushed to ``margin``; summed over the batch (the
    reference kept only its last item, not copied)."""
    B, T, E = encoded.shape
    enc = encoded.float()
    idx = mask_idx.long()
    rec = torch.gather(reconstructed.float(), 1,
                       idx[:, :, None].expand(-1, -1, E))      # (B, K, E)
    d2 = ((rec[:, :, None, :] - enc[:, None, :, :]) ** 2).sum(dim=-1)
    t = torch.arange(T, device=encoded.device)
    near = (idx[:, :, None] - t[None, None, :]).abs() <= 1
    per = torch.where(near, d2, torch.clamp(margin - d2, min=0.0))
    per = per / (T * (T - 1))
    per_item = per.sum(dim=2).mean(dim=1)
    if valid is None:
        return per_item.sum() / (B * 100.0)
    v = valid.to(per_item.dtype)
    return (per_item * v).sum() / (torch.clamp(v.sum(), min=1.0) * 100.0)


def _minmax01(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo + 1e-12)


def unet_loss(fmri_in: torch.Tensor, fmri_out: torch.Tensor,
              struct_in: torch.Tensor, struct_out: torch.Tensor,
              valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """UNet_Loss (reference losses.py:282-312): each item's MSE between the
    UNet's output and its min-max-normalised input, both modalities,
    summed, then / (10 B) (/ (10 nvalid) over the valid rows)."""
    B = fmri_in.shape[0]
    fo = fmri_out.reshape(fmri_in.shape).float()
    so = struct_out.reshape(struct_in.shape).float()
    f = ((fo - _minmax01(fmri_in.float())) ** 2).mean(dim=(-2, -1))
    s = ((so - _minmax01(struct_in.float())) ** 2).mean(dim=(-2, -1))
    per_item = (f + s).reshape(B, -1).sum(dim=1)
    if valid is None:
        return per_item.sum() / (10.0 * B)
    v = valid.to(per_item.dtype)
    return (per_item * v).sum() / (10.0 * torch.clamp(v.sum(), min=1.0))


def _row_quantile(rows: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row r's quantile at its own level q[r]: ``jnp.quantile``'s default
    (linear) arithmetic, sorted values at floor and ceil of q (n - 1)
    weighted 1 - w and w, NaN for a row holding one (``torch.quantile``
    takes no level a row and no row above 2^24 values)."""
    n = rows.shape[1]
    srt = rows.sort(dim=1).values
    pos = q.to(torch.float32) * (n - 1)
    low, high = pos.floor(), pos.ceil()
    w_high = pos - low
    w_low = 1.0 - w_high
    lo = torch.clamp(low, 0, n - 1).long()[:, None]
    hi = torch.clamp(high, 0, n - 1).long()[:, None]
    out = (srt.gather(1, lo)[:, 0].float() * w_low
           + srt.gather(1, hi)[:, 0].float() * w_high)
    out = torch.where(rows.isnan().any(dim=1),
                      torch.full_like(out, float("nan")), out)
    return out.to(rows.dtype)


def intensity_voxel_mask(y: torch.Tensor,
                         low_quantile: float = 0.9) -> torch.Tensor:
    """get_intense_voxels (reference losses.py:10-42) for (B, H, W, D, T)
    volumes: each (batch, TR) frame zeroed at and below its corner
    background value, then thresholded at a quantile of its own level;
    a bool mask of y's shape."""
    B, H, W, D, T = y.shape
    v = torch.where(y <= y[:, :1, :1, :1, :], torch.zeros_like(y), y).abs()
    flat = v.permute(0, 4, 1, 2, 3).reshape(B * T, H * W * D)
    n_pos = (flat > flat[:, 0:1]).sum(dim=1)
    q = 1.0 - (n_pos.to(torch.float32) / flat.shape[1]) * (1.0 - low_quantile)
    mask = flat > _row_quantile(flat, q)[:, None]
    return mask.reshape(B, T, H, W, D).permute(0, 2, 3, 4, 1)


def intensity_loss(pred: torch.Tensor, target: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 restricted to the target's intense-voxel mask (reference
    trainer.py:698-717); pad rows leave both the sum and the count."""
    mask = intensity_voxel_mask(target).to(torch.float32)
    if valid is not None:
        v = valid.to(torch.float32)
        mask = mask * v.reshape((v.shape[0],) + (1,) * (mask.ndim - 1))
    denom = torch.clamp(mask.sum(), min=1.0)
    return ((pred - target).abs() * mask).sum() / denom


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor,
                        valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    return l1_loss(pred, target, valid)


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
    (loss_writer.py:181-201)."""
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
    return out


def compute_losses(outputs: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor],
                   specs: Mapping[str, LossSpec],
                   extra_fns: Optional[Mapping[str, Callable]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """Every active loss from the model outputs and the batch, weighted,
    plus their sum under 'total' (JAX ``compute_losses``).
    ``batch['valid']`` (B,) excludes pad rows when present. ``extra_fns``
    holds the criteria with weights of their own ('perceptual'), and
    ``generator`` (a host torch.Generator) draws their random slices."""
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
        elif name == "unet":
            v = unet_loss(outputs["fMRI_input"], outputs["fMRI_output"],
                          outputs["struct_input"], outputs["struct_output"],
                          valid=valid)
        elif name == "contrastive":
            v = contrastive_loss(outputs["reconstructed_fmri_sequence"],
                                 valid=valid)
        elif name == "mask":
            v = mask_loss(outputs["encoded_inputs"], outputs["mask_list"],
                          outputs["reconstructed_fmri_sequence"], valid=valid)
        elif name == "reconstruction":
            v = reconstruction_loss(outputs["reconstructed_fmri_sequence"],
                                    batch["fmri_sequence"], valid)
        elif name == "intensity":
            v = intensity_loss(outputs["reconstructed_fmri_sequence"],
                               batch["fmri_sequence"], valid)
        elif name == "perceptual":
            if not extra_fns or "perceptual" not in extra_fns:
                raise KeyError(
                    "perceptual loss is active for this task but no "
                    "perceptual_fn was supplied: pass extra_fns={"
                    "'perceptual': PerceptualLoss(...)} (the Trainer wires "
                    "this automatically)")
            v = extra_fns["perceptual"](
                outputs["reconstructed_fmri_sequence"],
                batch["fmri_sequence"], generator, valid=valid)
        else:
            raise KeyError(f"unknown loss {name}")
        vals[name] = v * spec.factor
    vals["total"] = (sum(vals.values()) if vals
                     else torch.zeros((), dtype=torch.float32))
    return vals
