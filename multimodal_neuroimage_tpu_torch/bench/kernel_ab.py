"""K8 and K4 forward, and the flagship steps around K4, timed in two or
more checkouts of the repository on one CUDA card, in turns.

    python -m multimodal_neuroimage_tpu_torch.bench.kernel_ab BASE [OTHER ...]

``BASE`` and each ``OTHER`` are repository roots; with no ``OTHER`` the
other side is this checkout. A worker process runs in each, in ``CYCLES``
cycles of the turns BASE, OTHER..., OTHER..., BASE; each imports the
package of its own checkout and builds that checkout's kernels there (a
side's first turn builds, its later turns find the library). Every side is
timed by this checkout's code (``bench/timing.py``, loaded by its path). A
worker times, ``ROUNDS`` times:

- K8, ten cases: each dot-shape formulation at f32 and bf16, ms per
  scores + context pair: the slope over chains of 2 and 10 pairs, as
  ``bench/dot_shapes.py`` takes it;
- K4 forward, six cases: the SwinV2 head's three stages at batch 4,
  attention dropout 0 and 0.1; the call time (CUDA events around 20
  back-to-back calls, as ``chip_smoke.py`` times every kernel) and the
  device time (one replay of a CUDA graph that captured 20 calls);

and once, the flagship ``FuncStructCross`` at batch 4 (random weights from
a seed, float32): 12 CUDA-synchronised training steps and 12 predict steps,
each after 3 of warm-up, on the host clock.

Prints each turn's JSON line, then for every case each side's median and
quartiles over all its samples and the ratio of its median to BASE's.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

K4_STAGES = ((36, 12, 3, 3), (36, 6, 6, 0), (9, 3, 12, 0))  # N, res, heads, shift
BATCH = 4
STEPS = 12
CYCLES, ROUNDS = 2, 2   # 8 samples a side for each kernel case, 48 a step


def _timing():
    """This checkout's bench/timing.py, whichever checkout's package the
    worker imports: every side is timed by the same code."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "timing.py")
    spec = importlib.util.spec_from_file_location("_kernel_ab_timing", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _step_times(fn):
    """Host-clock ms of ``STEPS`` CUDA-synchronised calls after 3 of
    warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _k8(out, T):
    from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds
    for bf16 in (False, True):
        for v in ds.VARIANTS:
            operands = ds.inputs(v, device="cuda")
            t2, t10 = (T.events_ms(
                lambda r=r: ds.dot_chain(v, *operands, r, bf16), iters=8,
                windows=3) for r in (2, 10))
            out["k8"].setdefault(f"{v} {'bf16' if bf16 else 'f32'}",
                                 []).append((t10 - t2) / 8)


def _k4(out, T):
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    rng = np.random.default_rng(5)
    for N, res, heads, shift in K4_STAGES:
        ws = int(np.sqrt(N))
        shape = (BATCH, (res // ws) ** 2, heads, N, 4)
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                   .cuda() for _ in range(3))
        bias = torch.from_numpy(rng.normal(size=(heads, N, N))
                                .astype(np.float32)).cuda()
        m = shift_attn_mask(res, res, ws, shift)
        mask = None if m is None else torch.from_numpy(m).cuda()
        for rate in (0.0, 0.1):
            def call(rate=rate, q=q, k=k, v=v, bias=bias, mask=mask):
                return att.fused_window_attention(q, k, v, bias, mask, 7, rate)
            key = f"N{N} heads{heads} rate {rate}"
            out["k4 call"].setdefault(key, []).append(T.events_ms(call))
            out["k4 device"].setdefault(key, []).append(T.graph_ms(call)[0])


def _flagship(out):
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                             multimodal_item)
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    cfg = Config(task="FuncStruct", dataset_name="multimodal",
                 multimodality_type="cross_attention", target="sex",
                 fine_tune_task="binary_classification", batch_size=BATCH,
                 compute_dtype="float32", preprocess="host").validate()
    rng = np.random.default_rng(3)
    items = []
    for i in range(BATCH):
        item = multimodal_item({"subject": f"s{i}",
                                "fmri": rng.normal(size=(84, 368)) + 100.0,
                                "struct": rng.normal(size=(84, 84))}, cfg)
        item["target"] = np.float32(i % 2)
        items.append(item)
    batch = collate(items)[0]
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1)).cuda()
    opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-4,
                           cfg.weight_decay)
    step = make_train_step(model, active_losses(cfg.task, cfg.fine_tune_task),
                           opt, "float32", "cuda")
    gen = torch.Generator().manual_seed(2)
    out["flagship"]["train step"] = _step_times(lambda: step(batch, gen))
    predict = make_predict_step(model, "float32", device="cuda")
    out["flagship"]["predict step"] = _step_times(lambda: predict(batch))


def worker() -> int:
    from multimodal_neuroimage_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = _timing()
    lib = build.library()
    out = {"root": os.getcwd(), "build_s": lib.build_seconds, "k8": {},
           "k4 call": {}, "k4 device": {}, "flagship": {}}
    for _ in range(ROUNDS):
        _k8(out, T)
        _k4(out, T)
    _flagship(out)
    print(json.dumps(out), flush=True)
    return 0


def _summary(samples) -> str:
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return f"{med:.4f} ({q1:.4f}-{q3:.4f})"


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        return worker()
    if not argv or not torch.cuda.is_available():
        print(__doc__ if argv else "kernel_ab: needs a CUDA card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    roots = [os.path.abspath(r) for r in argv] + ([here] if len(argv) == 1
                                                   else [])
    runs = {root: [] for root in roots}
    for _ in range(CYCLES):
        for root in roots + roots[::-1]:
            env = {**os.environ, "PYTHONPATH": root}
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker"],
                cwd=root, env=env, capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:],
                      file=sys.stderr)
                raise RuntimeError(f"the worker in {root} failed")
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(line), flush=True)
            runs[root].append(line)
    print("case: each side's median ms (q1-q3) over all its samples, and "
          "its median / BASE's; sides in order: " + ", ".join(roots))
    for group in ("k8", "k4 call", "k4 device", "flagship"):
        for case in runs[roots[0]][0][group]:
            pooled = [sum((r[group][case] for r in runs[root]), [])
                      for root in roots]
            base = np.median(pooled[0])
            print(f"{group} {case} (n={len(pooled[0])}): " + "; ".join(
                _summary(p) + ("" if i == 0 else
                               f" ({np.median(p) / base:.3f})")
                for i, p in enumerate(pooled)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
