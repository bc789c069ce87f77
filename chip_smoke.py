"""Drive the PyTorch port's serving path once on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (nvidia-smi) and builds the port's
   CUDA kernels from ``multimodal_neuroimage_tpu_torch/csrc`` with nvcc.
2. Holds each kernel against its plain PyTorch version on the card at the
   flagship's shapes (float32, TF32 off) and times both with CUDA events.
3. Serves the full-width flagship ``FuncStructCross`` (random weights from a
   seeded generator, saved and loaded through the port's checkpoint format):
   a ``Predictor`` answers 8 requests in batches of 4. Every kernel's launch
   count must be above 0 for that run, and the per-window logits must match
   the same weights run on the CPU through the plain versions.
4. Prints one JSON line of per-kernel results and, last, the ok line.

Any failed phase raises, so the exit code is non-zero and no ok line is
printed. Without a CUDA card it exits with code 2 before doing anything.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261016
BATCH = 4
N_REQUESTS = 8
# kernel vs plain version on the card: |got - want| <= ATOL + RTOL * |want|
ATOL, RTOL = 1e-4, 2e-4
# card vs CPU logits of the whole 2x16-layer BERT + 60-block SwinFusion +
# SwinV2 forward: float32 summation-order drift accumulates over depth
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-3


def _close(name: str, got: torch.Tensor, want: torch.Tensor,
           atol: float, rtol: float) -> float:
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if (err > bound).any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} over "
                             f"atol {atol} + rtol {rtol} * |want|")
    return err.max().item()


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _alternate(kernel, plain):
    """Times in turns (plain, kernel, kernel, plain) on one card."""
    p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kernel), _time_ms(kernel),
                      _time_ms(plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _kernel_cases(gen):
    """(name, kernel fn, plain fn, source, replaces) at flagship shapes."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    dev = "cuda"
    cases = []

    def lin(o, i):
        b = 1.0 / np.sqrt(i)
        return [_uniform(gen, (o, i), b), _uniform(gen, (o,), b)]

    def ln(c):
        return [1 + 0.1 * torch.randn(c, generator=gen),
                0.1 * torch.randn(c, generator=gen)]

    # K1: B=4, T=369, H=84, 12 heads, F=3072
    H, F_, T = 84, 3072, 369
    p = (lin(H, H) + lin(H, H) + lin(H, H) + lin(H, H) + ln(H)
         + lin(F_, H) + lin(H, F_) + ln(H))
    p = tuple(t.to(dev) for t in p)
    x = torch.randn(BATCH, T, H, generator=gen).to(dev)
    cases.append(("K1 bert_layer",
                  lambda: bl.bert_layer_call(x, p, 12, T),
                  lambda: bl.bert_layer_reference(x, p, 12, T),
                  "multimodal_neuroimage_tpu_torch/csrc/bert_layer.cu",
                  "multimodal_neuroimage_tpu/ops/bert_layer.py:914"))

    # K2/K3: B=4, 84x84 tokens in 196 windows of 36, C=12, 6 heads
    C, Hh, N, nW = 12, 6, 36, 196
    self_p = tuple(t.to(dev) for t in ln(C) + lin(3 * C, C) + lin(C, C)
                   + ln(C) + lin(4 * C, C) + lin(C, 4 * C))
    cross_p = tuple(t.to(dev) for t in ln(C) + ln(C) + lin(C, C)
                    + lin(2 * C, C) + lin(C, C) + ln(C) + lin(4 * C, C)
                    + lin(C, 4 * C))
    bias = (0.5 * torch.randn(Hh, N, N, generator=gen)).to(dev)
    xw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    yw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        cases.append((f"K2 fusion_block shift {shift}",
                      lambda mask=mask: fb.fused_fusion_block(
                          xw, self_p, bias, mask),
                      lambda mask=mask: fb.fusion_block_reference(
                          xw, self_p, bias, mask),
                      "multimodal_neuroimage_tpu_torch/csrc/fusion_block.cu",
                      "multimodal_neuroimage_tpu/ops/fusion_block.py:855"))
        cases.append((f"K3 cross_fusion_block shift {shift}",
                      lambda mask=mask: fb.fused_cross_fusion_block(
                          xw, yw, cross_p, bias, mask),
                      lambda mask=mask: fb.cross_fusion_block_reference(
                          xw, yw, cross_p, bias, mask),
                      "multimodal_neuroimage_tpu_torch/csrc/fusion_block.cu",
                      "multimodal_neuroimage_tpu/ops/fusion_block.py:855"))

    # K4: the SwinV2 head's three stages (N, nW, heads, shifted)
    for N4, res, heads, shift in ((36, 12, 3, 3), (36, 6, 6, 0),
                                  (9, 3, 12, 0)):
        ws = int(np.sqrt(N4))
        nw4 = (res // ws) ** 2
        shape = (BATCH, nw4, heads, N4, 4)
        q = torch.nn.functional.normalize(
            torch.randn(shape, generator=gen), dim=-1) * 10.0
        k = torch.nn.functional.normalize(torch.randn(shape, generator=gen),
                                          dim=-1)
        v = torch.randn(shape, generator=gen)
        b4 = 16 * torch.sigmoid(torch.randn(heads, N4, N4, generator=gen))
        m = shift_attn_mask(res, res, ws, shift)
        q, k, v, b4 = (t.to(dev) for t in (q, k, v, b4))
        mask = None if m is None else torch.from_numpy(m).to(dev)
        cases.append((f"K4 window_attention N{N4} nW{nw4} heads{heads}",
                      lambda q=q, k=k, v=v, b4=b4, mask=mask:
                          att.fused_window_attention(q, k, v, b4, mask),
                      lambda q=q, k=k, v=v, b4=b4, mask=mask:
                          att.attention_reference(q, k, v, b4, mask),
                      "multimodal_neuroimage_tpu_torch/csrc/window_attention.cu",
                      "multimodal_neuroimage_tpu/ops/attention.py:305"))
    return cases


def _requests(rng: np.random.Generator):
    reqs = []
    for i in range(N_REQUESTS):
        T = int(rng.integers(350, 369))
        t = np.arange(T)[None, :]
        drift = np.sin(2 * np.pi * t / rng.uniform(150, 400, (84, 1)))
        series = rng.normal(size=(84, T)) + 2.0 * drift + 100.0
        s = rng.normal(size=(84, 84))
        reqs.append({"subject": f"sub-{i:03d}", "fmri": series,
                     "struct": (s + s.T) / 2})
    return reqs


def _ptxas_summary(log: str):
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            rest = m.group(2)[n:]
            # one template argument, mangled as I L <type> <value> E
            name = m.group(2)[:n] + (f"<{rest[3:rest.index('E')]}>"
                                     if rest.startswith("IL") else "")
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"  {name}: {line.split(':', 1)[-1].strip()}")
    return lines


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        Predictor, make_predict_step)
    from multimodal_neuroimage_tpu_torch.config import Config

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lib = build.library()
    print(f"kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in _ptxas_summary(lib.build_log):
        print(line)

    gen = torch.Generator().manual_seed(SEED)
    results = {}
    for label, kernel, plain, source, replaces in _kernel_cases(gen):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _close(label, got, want, ATOL, RTOL)
        ms, plain_ms = _alternate(kernel, plain)
        print(f"{label}: max|err| {err:.3e} (atol {ATOL} + rtol {RTOL})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        key = label.split()[0] + " " + label.split()[1]
        r = results.setdefault(key, {"name": key, "route": "cuda",
                                     "source": source, "replaces": replaces,
                                     "max_abs_err": 0.0, "ms": 0.0,
                                     "plain_ms": 0.0, "cases": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["cases"] += 1

    cfg = Config(task="FuncStruct", dataset_name="multimodal",
                 multimodality_type="cross_attention", target="sex",
                 fine_tune_task="binary_classification", batch_size=BATCH,
                 compute_dtype="float32", preprocess="host").validate()
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED))
    requests = _requests(np.random.default_rng(SEED))
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        ckpt = save_checkpoint(os.path.join(tmp, "flagship.ckpt"),
                               model.state_dict(), {"val_threshold": 0.5})
        pred = Predictor(cfg, ckpt, requests, device="cuda")
        pred.predict()                                   # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        scores = pred.predict(write_csv=os.path.join(tmp, "predictions.csv"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launches()
        with open(os.path.join(tmp, "predictions.csv")) as f:
            rows = f.read().strip().splitlines()

    print(f"launches in the serving run: {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")
    if len(scores) != N_REQUESTS or len(rows) != N_REQUESTS + 1:
        raise AssertionError(f"expected {N_REQUESTS} subjects, got "
                             f"{len(scores)} scores, {len(rows) - 1} rows")
    for subject, row in scores.items():
        if not (0.0 < row["score"] < 1.0) or row["label"] != float(
                row["score"] > pred.threshold):
            raise AssertionError(f"bad prediction for {subject}: {row}")

    cpu_model = create_model(cfg)
    cpu_model.load_state_dict(model.state_dict())
    cpu_step = make_predict_step(cpu_model, "float32", device="cpu")
    logit_err = 0.0
    for batch, _ in pred.batches():
        got = pred.step(batch)["binary_classification"].cpu()
        want = cpu_step(batch)["binary_classification"]
        logit_err = max(logit_err, _close("serving logits", got, want,
                                          LOGIT_ATOL, LOGIT_RTOL))

    first, _ = next(pred.batches())
    fwd = _time_ms(lambda: pred.step(first), iters=5)
    print(f"served {N_REQUESTS} requests in {wall:.3f} s: "
          f"{N_REQUESTS / wall:.2f} requests/s end to end (host band split "
          f"included); predict step {fwd:.2f} ms per batch of {BATCH}; "
          f"logits vs CPU max|err| {logit_err:.3e} "
          f"(atol {LOGIT_ATOL} + rtol {LOGIT_RTOL}); card: {card}")

    kernels = []
    for key, fn in ops.kernels().items():
        r = results[key]
        kernels.append({"name": key, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": counts[key],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"] / r["cases"],
                        "plain_ms": r["plain_ms"] / r["cases"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
