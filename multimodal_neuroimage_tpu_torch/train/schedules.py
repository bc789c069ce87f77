"""Learning-rate schedules (counterpart of multimodal_neuroimage_tpu/train/schedules.py).

Plain functions of the (pre-increment) step count returning a float, one
for each of the reference's LrHandler policies:

  * 'step'      StepLR per iteration with a final-lr floor of 1e-7
  * 'SGDR'      warmup then cosine cycles whose peak decays by gamma
  * 'OneCycle'  optax.cosine_onecycle_schedule (torch OneCycleLR defaults)
  * 'CosAnn'    CosineAnnealingLR(T_max=100, eta_min=0) closed form
"""

from __future__ import annotations

import math
from typing import Callable, Optional

FINAL_LR = 1e-7
Schedule = Callable[[int], float]


def step_schedule(base_lr: float, step_size: int, gamma: float,
                  final_lr: float = FINAL_LR) -> Schedule:
    def fn(t: int) -> float:
        return max(base_lr * gamma ** (int(t) // step_size), final_lr)
    return fn


def sgdr_schedule(base_lr: float, total_iterations: int,
                  warmup_steps: Optional[int] = None, t_mult: int = 1,
                  gamma: float = 0.5, min_lr: float = 1e-9,
                  first_cycle_frac: float = 0.3) -> Schedule:
    """CosineAnnealingWarmUpRestarts: each cycle warms up linearly from
    min_lr to its gamma-decayed peak, then cosine-decays back to min_lr."""
    first_cycle = max(int(first_cycle_frac * total_iterations), 2)
    if warmup_steps is None:
        warmup_steps = int(total_iterations * 0.05)
    warmup_steps = min(warmup_steps, first_cycle - 1)
    starts, lengths = [], []
    start, length = 0, first_cycle
    while start < total_iterations * (max(t_mult, 1) + 1) + first_cycle:
        starts.append(start)
        lengths.append(length)
        start += length
        length = (length - warmup_steps) * max(t_mult, 1) + warmup_steps
        if len(starts) > 64:
            break

    def fn(t: int) -> float:
        cycle = sum(t >= s for s in starts) - 1
        cycle = min(max(cycle, 0), len(starts) - 1)
        tc = t - starts[cycle]
        peak = base_lr * gamma ** cycle
        if tc < warmup_steps:
            return min_lr + (peak - min_lr) * tc / max(warmup_steps, 1)
        return min_lr + (peak - min_lr) * 0.5 * (1.0 + math.cos(
            math.pi * (tc - warmup_steps)
            / max(lengths[cycle] - warmup_steps, 1)))
    return fn


def onecycle_schedule(base_lr: float, total_iterations: int) -> Schedule:
    """optax.cosine_onecycle_schedule(max(total, 2), base_lr, pct_start .3,
    div_factor 25, final_div_factor 1e4): cosine from base/25 up to base at
    30% of the steps, then down to base/25/1e4, held after the end."""
    steps = max(total_iterations, 2)
    bounds = [0, int(0.3 * steps), int(steps)]
    values = [base_lr / 25.0, base_lr, base_lr / 25.0 / 1e4]

    def fn(t: int) -> float:
        for i in range(2):
            if bounds[i] <= t < bounds[i + 1]:
                pct = (t - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1.0)
        return values[-1]
    return fn


def cosann_schedule(base_lr: float, t_max: int = 100,
                    eta_min: float = 0.0) -> Schedule:
    def fn(t: int) -> float:
        return eta_min + (base_lr - eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * t / t_max))
    return fn


def build_schedule(lr_policy: str, base_lr: float, total_iterations: int, *,
                   lr_step: int = 500, lr_gamma: float = 0.97,
                   lr_warmup: Optional[int] = None,
                   lr_T_mult: int = 1) -> Schedule:
    """Factory keyed like LrHandler.get_scheduler (learning_rate.py:59-81)."""
    if lr_policy == "step":
        return step_schedule(base_lr, lr_step, lr_gamma)
    if lr_policy == "SGDR":
        return sgdr_schedule(base_lr, total_iterations, lr_warmup, lr_T_mult)
    if lr_policy == "OneCycle":
        return onecycle_schedule(base_lr, total_iterations)
    if lr_policy == "CosAnn":
        return cosann_schedule(base_lr)
    raise NotImplementedError(f"lr policy {lr_policy}")
