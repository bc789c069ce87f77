"""Optimizer factory and the train / eval steps (counterpart of multimodal_neuroimage_tpu/train/state.py).

Single device: no mesh, no ``shard_map`` (multi-GPU is ROADMAP M11). The
optimizer is K5 (ops/fused_update.py ``FusedAdam``) for adam / adamw:
what the JAX ``create_optimizer`` fuses, and with ``accumulation_steps``
k > 1 its ``optax.MultiSteps`` chain, K5 applied to the mean of k
micro-step gradients (``FusedAdam``'s docstring). Other optimizers raise.

``compute_dtype`` is the JAX step builders' policy. ``"float32"`` runs
everything in float32. ``"bfloat16"`` (the flagship's shipping default)
is JAX's ``loss_fn``: the forward sees the float32 master parameters
rounded to bf16 (``bf16_weights``, in place for the step) and the batch
cast to bf16 (explicit casts, not ``torch.autocast``, which rounds
elsewhere), each module computes in the dtype JAX promotes to, which under
this policy is its input's (nn/common.py), the outputs are widened to
float32 before the losses, and every parameter's gradient is rounded to
bf16 (``round_grads``) as the VJP of its bf16 cast gives it in JAX. K5
updates the float32 masters.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from multimodal_neuroimage_tpu_torch.nn.common import full_f32
from multimodal_neuroimage_tpu_torch.nn.swinfusion import set_compute_policy
from multimodal_neuroimage_tpu_torch.ops.fused_update import FusedAdam
from multimodal_neuroimage_tpu_torch.train.losses import (LossSpec,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.schedules import build_schedule

HEADS = ("binary_classification", "regression")
BATCH_KEYS = ("fmri_sequence", "fmri_raw_sequence", "fmri_lowfreq_sequence",
              "fmri_ultralowfreq_sequence", "struct", "smri", "dti", "target",
              "valid", "prs")


def create_optimizer(optim: str, params: Iterable[torch.nn.Parameter],
                     schedule: Callable[[int], float], weight_decay: float,
                     gradient_clipping: bool = False,
                     clip_max_norm: float = 1.0,
                     accumulation_steps: int = 1) -> FusedAdam:
    """Adam applies L2 into the gradient (torch.optim.Adam), AdamW decouples
    the decay; both run as the one-launch K5 update, every
    ``accumulation_steps`` micro-steps."""
    if optim.lower() not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optim}")
    return FusedAdam(params, schedule, weight_decay, optim.lower(),
                     gradient_clipping, clip_max_norm,
                     accumulation_steps=accumulation_steps)


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
    """Batch (numpy arrays, or tensors: the device gear's bands) -> float32
    tensors on ``device``."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
            for k in BATCH_KEYS if k in batch}


def check_compute_dtype(compute_dtype: str) -> None:
    """Refuse a compute dtype other than float32 and bfloat16; set the
    fusion stacks' stream policy from it."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype={compute_dtype!r}: float32 or "
                         f"bfloat16")
    set_compute_policy(compute_dtype)


@contextlib.contextmanager
def bf16_weights(params: Iterable[torch.Tensor],
                 flat: Optional[torch.Tensor] = None):
    """Within the block the float32 ``params`` hold their bf16 roundings
    (JAX ``_cast_tree`` of the parameters), which every consumer takes as
    JAX's promotion does (nn/common.py); on exit the float32 masters are
    back. When the parameters view one buffer (``FusedAdam``'s, or
    ``flatten_parameters``'), it is rounded and restored as one tensor; else
    the parameters are gathered and written back with multi-tensor copies.
    In place, so that the modules, the kernels and autograd see plain
    float32 parameters: a cast a parameter, or a view of a cast, cost device
    launches and host time a step in thousands. Gradients that accumulate
    in the block are float32; ``round_grads`` makes them the bf16 values
    JAX's VJP of the cast gives."""
    params = list(params)
    if flat is None:
        flat = _flat_buffer(params)
    with torch.no_grad():
        if flat is not None:
            saved = flat.clone()
            flat.copy_(flat.to(torch.bfloat16))
        else:
            saved = torch.cat([p.reshape(-1) for p in params])
            torch._foreach_copy_(params, _views(
                saved.to(torch.bfloat16).float(), params))
    try:
        yield
    finally:
        with torch.no_grad():
            if flat is not None:
                flat.copy_(saved)
            else:
                torch._foreach_copy_(params, _views(saved, params))


def _flat_buffer(params) -> Optional[torch.Tensor]:
    """The one float32 buffer that ``params`` view and fill, whole, if any
    (its element order is not needed: it is rounded and restored whole)."""
    storage = params[0].untyped_storage()
    if (any(p.dtype != torch.float32 or p.untyped_storage().data_ptr()
            != storage.data_ptr() for p in params)
            or storage.nbytes() != 4 * sum(p.numel() for p in params)):
        return None
    return torch.empty(0, dtype=torch.float32,
                       device=params[0].device).set_(storage)


def flatten_parameters(model: torch.nn.Module) -> None:
    """Move every parameter of ``model`` into one float32 buffer, each
    parameter a view of it (as ``FusedAdam`` does for training), so that
    ``bf16_weights`` rounds and restores them as one tensor."""
    params = list(model.parameters())
    flat = torch.empty(sum(p.numel() for p in params), dtype=torch.float32,
                       device=params[0].device)
    with torch.no_grad():
        off = 0
        for p in params:
            n = p.numel()
            flat[off:off + n].copy_(p.reshape(-1))
            p.data = flat[off:off + n].view_as(p)
            off += n


def _views(flat: torch.Tensor, params) -> list:
    """``flat`` cut into tensors shaped as ``params``."""
    return [t.view_as(p) for t, p in zip(
        flat.split([p.numel() for p in params]), params)]


def round_grads(grads: torch.Tensor) -> None:
    """Round (flat) float32 gradients to bf16 in place: what reaches each
    float32 master through the VJP of its bf16 cast."""
    with torch.no_grad():
        grads.copy_(grads.to(torch.bfloat16))


def forward_at(model: torch.nn.Module, inputs: Mapping, compute_dtype: str,
               generator=None) -> Dict[str, torch.Tensor]:
    """The model's forward under the compute policy (module docstring): at
    bf16 the inputs cast to bf16 and the outputs widened to float32, the
    parameters rounded by the caller (``bf16_weights``)."""
    if compute_dtype == "float32":
        return model(inputs, generator=generator)
    inputs = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
              for k, v in inputs.items()}
    out = model(inputs, generator=generator)
    return {k: v.float() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in out.items()}


def weights_at(model: torch.nn.Module, compute_dtype: str):
    """The parameters for a step at ``compute_dtype``: ``bf16_weights``
    under the bf16 policy, else as they are (a null context)."""
    if compute_dtype == "float32":
        return contextlib.nullcontext()
    return bf16_weights(model.parameters())


def make_train_step(model: torch.nn.Module, loss_specs: Dict[str, LossSpec],
                    optimizer: FusedAdam, compute_dtype: str = "float32",
                    device="cuda") -> Callable:
    """fn(batch, generator) -> (losses, preds): one optimizer step at
    ``compute_dtype`` (module docstring). The forward draws every dropout
    seed and DropPath factor from ``generator`` (a host torch.Generator),
    so the same generator state gives the same step on the CPU and on the
    card. Float32 products run in full float32 (no TF32 in matmuls or cuDNN
    convolutions)."""
    check_compute_dtype(compute_dtype)

    def train_step(batch: Mapping, generator: torch.Generator):
        model.train()
        set_compute_policy(compute_dtype)
        inputs = batch_to_device(batch, device)
        optimizer.zero_grad()
        with full_f32(), weights_at(model, compute_dtype):
            outputs = forward_at(model, inputs, compute_dtype, generator)
            losses = compute_losses(outputs, inputs, loss_specs)
            losses["total"].backward()
        if compute_dtype == "bfloat16":
            round_grads(optimizer.grads)
        optimizer.step()
        return ({k: v.detach() for k, v in losses.items()},
                {k: outputs[k].detach() for k in HEADS if k in outputs})

    return train_step


def make_eval_step(model: torch.nn.Module, loss_specs: Dict[str, LossSpec],
                   compute_dtype: str = "float32", device="cuda") -> Callable:
    """fn(batch) -> (losses, preds) with dropout off."""
    check_compute_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(batch: Mapping):
        model.eval()
        set_compute_policy(compute_dtype)
        inputs = batch_to_device(batch, device)
        with full_f32(), weights_at(model, compute_dtype):
            outputs = forward_at(model, inputs, compute_dtype)
        losses = compute_losses(outputs, inputs, loss_specs)
        return losses, {k: outputs[k] for k in HEADS if k in outputs}

    return eval_step
