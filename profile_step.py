"""Profile one training path of the PyTorch port on one CUDA card.

Run from the repository root: ``python3 profile_step.py hcp`` (or
``flagship``, optionally with a batch size, a fusion layout and a compute
dtype: ``python3 profile_step.py flagship 16 bp bfloat16``, ``python3
profile_step.py hcp 8 std bfloat16``). It builds the path's ``Trainer`` on
the synthetic cohort that ``chip_smoke.py`` trains (same seed and widths;
the flagship at batch 4, HCP at its batch 8, the std layout and float32
unless told otherwise), warms up 3 steps, then prints:

- the host split of a step: median of 10 steps with a CUDA synchronise after
  the forward (loss included), after the backward and after the optimizer;
- device busy time per step from ``torch.profiler`` over 5 more steps (the
  sum of the device self time of every kernel, copy and memset; one
  stream, so nothing overlaps) and the idle share, 1 - busy / step, against
  the unprofiled step and against the profiled wall (the profiler slows the
  host);
- kernels launched per step and the largest device items by self time.

Every number names the card and its power limit. Without a CUDA card it
exits with code 2.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as smoke


def _trainer(path: str, folder: str, batch: int, dtype: str):
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(smoke.SEED)
    if path == "hcp":
        cfg = smoke._hcp_cfg(compute_dtype=dtype)
        records = smoke._hcp_cohort(rng, smoke.N_TRAIN, 0)
    else:
        cfg = smoke._flagship_cfg(batch_size=batch, compute_dtype=dtype)
        records = smoke._cohort(rng, max(smoke.N_TRAIN, 2 * batch), 0)
    return Trainer(cfg, records, records[:cfg.batch_size], device="cuda",
                   experiment_folder=folder)


def _host_split(trainer, batches):
    """(forward, backward, optimizer) ms medians over 10 steps."""
    from multimodal_neuroimage_tpu_torch.nn.common import full_f32
    from multimodal_neuroimage_tpu_torch.train.losses import compute_losses
    from multimodal_neuroimage_tpu_torch.train.state import (batch_to_device,
                                                             forward_at,
                                                             round_grads,
                                                             weights_at)
    model, opt = trainer.model, trainer.optimizer
    dtype = trainer.cfg.compute_dtype
    split = []
    for i in range(10):
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = batch_to_device(batches[i % len(batches)], "cuda")
        opt.zero_grad()
        with full_f32(), weights_at(model, dtype):
            out = forward_at(model, inputs, dtype, trainer.generator)
            loss = compute_losses(out, inputs, trainer.loss_specs)["total"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
        if dtype == "bfloat16":
            round_grads(opt.grads)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        split.append((t1 - t0, t2 - t1, t3 - t2))
    return [1e3 * float(np.median(col)) for col in zip(*split)]


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "hcp"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else smoke.BATCH
    layout = sys.argv[3] if len(sys.argv) > 3 else "std"
    dtype = sys.argv[4] if len(sys.argv) > 4 else "float32"
    if (path not in ("hcp", "flagship") or layout not in ("std", "bp")
            or dtype not in ("float32", "bfloat16")):
        print(f"usage: {sys.argv[0]} [hcp|flagship [batch [std|bp "
              f"[float32|bfloat16]]]]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from multimodal_neuroimage_tpu_torch.ops import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as folder, \
            smoke._layout(layout):
        trainer = _trainer(path, folder, batch, dtype)
        batches = [b for b, _ in trainer.batches("train")]
        for i in range(3):
            trainer.train_step(batches[i % len(batches)], trainer.generator)
        fwd, bwd, opt = _host_split(trainer, batches)
        n = 5
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                trainer.train_step(batches[i % len(batches)],
                                   trainer.generator)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / n
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / n
    if busy == 0.0:
        raise RuntimeError("torch.profiler recorded no device time")
    launches = sum(e.count for e in device) / n
    bs = trainer.cfg.batch_size
    step = fwd + bwd + opt
    name = path if path == "hcp" else f"{path} ({layout} layout, {dtype})"
    print(f"{name} training step, batch {bs}: host split forward {fwd:.3f} "
          f"ms, backward {bwd:.3f} ms, optimizer {opt:.3f} ms (medians of "
          f"10 synchronised steps, sum {step:.3f} ms); device busy "
          f"{busy:.3f} ms a step, idle share {1 - busy / step:.3f} of that "
          f"sum ({1 - busy / wall:.3f} of the profiled wall, {wall:.3f} ms a "
          f"step); {launches:.0f} device items a step; card: {card}")
    print("largest device items (ms a step, calls a step):")
    for e in sorted(device, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n:9.3f} ms "
              f"{e.count / n:7.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
