"""Optimizer factory and the train / eval steps (counterpart of multimodal_neuroimage_tpu/train/state.py).

Single device, float32: no mesh, no ``shard_map`` (multi-GPU is ROADMAP
M11), no bf16 policy (N1). The optimizer is K5 (ops/fused_update.py
``FusedAdam``) for adam / adamw without gradient accumulation, which is
what the JAX ``create_optimizer`` fuses; the unfused optax chains
(accumulation, other optimizers) are ROADMAP M5.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.nn.common import full_f32
from multimodal_neuroimage_tpu_torch.ops.fused_update import FusedAdam
from multimodal_neuroimage_tpu_torch.train.losses import (LossSpec,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.schedules import build_schedule

HEADS = ("binary_classification", "regression")
BATCH_KEYS = ("fmri_sequence", "fmri_raw_sequence", "fmri_lowfreq_sequence",
              "fmri_ultralowfreq_sequence", "struct", "target", "valid")


def create_optimizer(optim: str, params: Iterable[torch.nn.Parameter],
                     schedule: Callable[[int], float], weight_decay: float,
                     gradient_clipping: bool = False,
                     clip_max_norm: float = 1.0,
                     accumulation_steps: int = 1) -> FusedAdam:
    """Adam applies L2 into the gradient (torch.optim.Adam), AdamW decouples
    the decay; both run as the one-launch K5 update."""
    if optim.lower() not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optim}")
    if accumulation_steps > 1:
        raise NotImplementedError(
            f"accumulation_steps={accumulation_steps}: gradient accumulation "
            f"(the unfused optax MultiSteps chain) is ROADMAP M5")
    return FusedAdam(params, schedule, weight_decay, optim.lower(),
                     gradient_clipping, clip_max_norm)


def optimizer_from_config(cfg, params: Iterable[torch.nn.Parameter],
                          steps_per_epoch: int
                          ) -> Tuple[FusedAdam, Callable[[int], float]]:
    total = max(steps_per_epoch * cfg.nEpochs, 2)
    schedule = build_schedule(cfg.lr_policy, cfg.lr_init, total,
                              lr_step=cfg.lr_step, lr_gamma=cfg.lr_gamma,
                              lr_warmup=cfg.lr_warmup,
                              lr_T_mult=cfg.lr_T_mult)
    opt = create_optimizer(cfg.optim, params, schedule, cfg.weight_decay,
                           cfg.gradient_clipping, cfg.clip_max_norm,
                           cfg.accumulation_steps)
    return opt, schedule


def batch_to_device(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(batch[k], np.float32),
                               device=device)
            for k in BATCH_KEYS if k in batch}


def _check_dtype(compute_dtype: str) -> None:
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the port trains float32 only; "
            f"the bf16 policy is ROADMAP N1")


def make_train_step(model: torch.nn.Module, loss_specs: Dict[str, LossSpec],
                    optimizer: FusedAdam, compute_dtype: str = "float32",
                    device="cuda") -> Callable:
    """fn(batch, generator) -> (losses, preds): one optimizer step. The
    forward draws every dropout seed and DropPath factor from ``generator``
    (a host torch.Generator), so the same generator state gives the same
    step on the CPU and on the card. Forward and backward run in full
    float32 (no TF32 in matmuls or cuDNN convolutions)."""
    _check_dtype(compute_dtype)

    def train_step(batch: Mapping, generator: torch.Generator):
        model.train()
        inputs = batch_to_device(batch, device)
        optimizer.zero_grad()
        with full_f32():
            outputs = model(inputs, generator=generator)
            losses = compute_losses(outputs, inputs, loss_specs)
            losses["total"].backward()
        optimizer.step()
        return ({k: v.detach() for k, v in losses.items()},
                {k: outputs[k].detach() for k in HEADS if k in outputs})

    return train_step


def make_eval_step(model: torch.nn.Module, loss_specs: Dict[str, LossSpec],
                   compute_dtype: str = "float32", device="cuda") -> Callable:
    """fn(batch) -> (losses, preds) with dropout off."""
    _check_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(batch: Mapping):
        model.eval()
        inputs = batch_to_device(batch, device)
        with full_f32():
            outputs = model(inputs)
        losses = compute_losses(outputs, inputs, loss_specs)
        return losses, {k: outputs[k] for k in HEADS if k in outputs}

    return eval_step
