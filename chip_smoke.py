"""Drive the PyTorch port's training and serving paths once on one CUDA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

1. Prints the card's name and power limit (nvidia-smi) and builds the port's
   CUDA kernels from ``multimodal_neuroimage_tpu_torch/csrc`` with nvcc.
2. Holds every kernel against its plain PyTorch version on the card at the
   flagship's shapes (float32, TF32 off, B = 4) and times both with CUDA
   events: K1-K4 forward; K1-K4 backward with dropout on (dx/dy and every
   parameter gradient against autograd through the plain forward); K5 over
   the flagship's parameter count.
3. Trains the full-width flagship ``FuncStructCross`` (random weights from a
   seeded generator) with ``Trainer`` on a synthetic in-memory cohort with a
   label-linked signal: 16 train and 8 val subjects, batch 4, 2 epochs, at
   the config's dropout rates. Every loss must be finite, every one of the
   nine kernels must have launched in that run, and a best-AUROC checkpoint
   must be written.
4. Serves the 8 val subjects from that checkpoint with ``Predictor``: the
   four forward kernels must launch, and the per-window logits must match
   the same checkpoint run on the CPU through the plain versions.
5. Takes one training step on the card and the same step on the CPU
   through the plain versions, from the same weights, batch and generator
   state, and compares the loss, every gradient and the updated parameters.
6. Times the training step (CUDA-synchronised median of 12 steps after 3 of
   warm-up), subjects/s and peak device memory.
7. Prints one JSON line of per-kernel results and, last, the ok line.

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
N_TRAIN, N_VAL = 16, 8
# kernel vs plain version on the card: |got - want| <= ATOL + RTOL * |want|
ATOL, RTOL = 1e-4, 2e-4
# a gradient summed over many rows (weights, biases, LN scales, the bias
# table) is held relative to its tensor's max-abs: both sides add thousands
# of float32 terms in different orders; SUM_ATOL is the floor for a
# gradient that is zero in exact arithmetic (the key bias: softmax ignores a
# shift shared by every key), whose computed value is rounding noise
SUM_REL, SUM_ATOL = 1e-4, 1e-5
# card vs CPU logits / loss of the whole 2x16-layer BERT + 60-block
# SwinFusion + SwinV2 forward: float32 summation-order drift over depth
LOGIT_ATOL, LOGIT_RTOL = 1e-3, 1e-3
# card vs CPU gradients of one training step, per tensor relative to its
# max-abs: the same drift, carried back through the whole depth
GRAD_REL = 1e-2
SOURCES = "multimodal_neuroimage_tpu_torch/csrc/"
TPU = "multimodal_neuroimage_tpu/ops/"


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


def _close_rel(name: str, got: torch.Tensor, want: torch.Tensor,
               rel: float) -> float:
    """max |got - want| <= rel * max|want| + SUM_ATOL."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs().max().item()
    bound = rel * want.abs().max().item() + SUM_ATOL
    if err > bound:
        raise AssertionError(f"{name}: max |err| {err:.3e} over {bound:.3e} "
                             f"({rel} * max|want| + {SUM_ATOL})")
    return err


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


def _alternate(kernel, plain, iters: int = 20):
    """Times in turns (plain, kernel, kernel, plain) on one card."""
    p1, k1, k2, p2 = (_time_ms(plain, iters), _time_ms(kernel, iters),
                      _time_ms(kernel, iters), _time_ms(plain, iters))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _uniform(gen, shape, bound):
    return (torch.rand(shape, generator=gen) * 2 - 1) * bound


def _lin(gen, o, i):
    b = 1.0 / np.sqrt(i)
    return [_uniform(gen, (o, i), b), _uniform(gen, (o,), b)]


def _ln(gen, c):
    return [1 + 0.1 * torch.randn(c, generator=gen),
            0.1 * torch.randn(c, generator=gen)]


def _plain_backward(fwd, inputs, g):
    """The plain backward alone: autograd through the plain forward,
    graph built once (retained), so that timing it leaves the forward
    out."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in inputs]
        out = fwd(*ins)
    return ins, lambda: torch.autograd.grad(out, ins, g, retain_graph=True)


class Results:
    """Per-kernel max error and times, summed over the kernel's cases."""

    def __init__(self):
        self.rows = {}

    def add(self, key, source, replaces, err, ms, plain_ms):
        r = self.rows.setdefault(key, {"name": key, "route": "cuda",
                                       "source": source,
                                       "replaces": replaces,
                                       "max_abs_err": 0.0, "ms": 0.0,
                                       "plain_ms": 0.0, "cases": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["cases"] += 1


def forward_kernels(gen, res: Results):
    """K1-K4 forward against their plain versions (inference)."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    dev = "cuda"
    cases = []
    H, F_, T = 84, 3072, 369
    p = tuple(t.to(dev) for t in (_lin(gen, H, H) * 1 + _lin(gen, H, H)
                                  + _lin(gen, H, H) + _lin(gen, H, H)
                                  + _ln(gen, H) + _lin(gen, F_, H)
                                  + _lin(gen, H, F_) + _ln(gen, H)))
    x = torch.randn(BATCH, T, H, generator=gen).to(dev)
    cases.append(("K1 bert_layer", "",
                  lambda: bl.bert_layer_call(x, p, 12, T),
                  lambda: bl.bert_layer_reference(x, p, 12, T),
                  "bert_layer.cu", "bert_layer.py:914"))
    C, Hh, N, nW = 12, 6, 36, 196
    self_p, cross_p, bias, xw, yw = _fusion_inputs(gen)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        cases.append(("K2 fusion_block", f"shift {shift}",
                      lambda mask=mask: fb.fused_fusion_block(
                          xw, self_p, bias, mask),
                      lambda mask=mask: fb.fusion_block_reference(
                          xw, self_p, bias, mask),
                      "fusion_block.cu", "fusion_block.py:855"))
        cases.append(("K3 cross_fusion_block", f"shift {shift}",
                      lambda mask=mask: fb.fused_cross_fusion_block(
                          xw, yw, cross_p, bias, mask),
                      lambda mask=mask: fb.cross_fusion_block_reference(
                          xw, yw, cross_p, bias, mask),
                      "fusion_block.cu", "fusion_block.py:855"))
    for args in _k4_inputs(gen):
        cases.append(("K4 window_attention", args[-1],
                      lambda a=args: att.fused_window_attention(*a[:5]),
                      lambda a=args: att.attention_reference(*a[:5]),
                      "window_attention.cu", "attention.py:305"))
    for key, label, kernel, plain, src, rep in cases:
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = _close(f"{key} {label}", got, want, ATOL, RTOL)
        ms, plain_ms = _alternate(kernel, plain)
        print(f"{key} {label}: max|err| {err:.3e} (atol {ATOL} + rtol "
              f"{RTOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        res.add(key, SOURCES + src, TPU + rep, err, ms, plain_ms)


def _fusion_inputs(gen):
    C, Hh, N, nW = 12, 6, 36, 196
    dev = "cuda"
    self_p = tuple(t.to(dev) for t in _ln(gen, C) + _lin(gen, 3 * C, C)
                   + _lin(gen, C, C) + _ln(gen, C) + _lin(gen, 4 * C, C)
                   + _lin(gen, C, 4 * C))
    cross_p = tuple(t.to(dev) for t in _ln(gen, C) + _ln(gen, C)
                    + _lin(gen, C, C) + _lin(gen, 2 * C, C) + _lin(gen, C, C)
                    + _ln(gen, C) + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))
    bias = (0.5 * torch.randn(Hh, N, N, generator=gen)).to(dev)
    xw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    yw = torch.randn(BATCH, nW, N, C, generator=gen).to(dev)
    return self_p, cross_p, bias, xw, yw


def _k4_inputs(gen):
    """The SwinV2 head's three stages: (q, k, v, bias, mask, label)."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    out = []
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
        mask = None if m is None else torch.from_numpy(m).cuda()
        out.append(tuple(t.cuda() for t in (q, k, v, b4)) + (
            mask, f"N{N4} nW{nw4} heads{heads}"))
    return out


def backward_kernels(gen, res: Results, n_params: int):
    """K1-K4 backward (dropout on) and K5 against their plain versions."""
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fused_update as fu
    dev = "cuda"
    rates, seed = (0.1, 0.1), 12345

    def report(key, label, errs, kernel, plain, src, rep):
        ms, plain_ms = _alternate(kernel, plain, iters=10)
        err = max(errs)
        print(f"{key} {label}: max|err| {err:.3e} (dx/dy: atol {ATOL} + "
              f"rtol {RTOL}; sums: {SUM_REL} * max|ref| + {SUM_ATOL})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        res.add(key, SOURCES + src, TPU + rep, err, ms, plain_ms)

    # K1: B 4 x T 369 x H 84, 12 heads, F 3072
    H, F_, T = 84, 3072, 369
    p = tuple(t.to(dev) for t in (_lin(gen, H, H) + _lin(gen, H, H)
                                  + _lin(gen, H, H) + _lin(gen, H, H)
                                  + _ln(gen, H) + _lin(gen, F_, H)
                                  + _lin(gen, H, F_) + _ln(gen, H)))
    x = torch.randn(BATCH, T, H, generator=gen).to(dev)
    g = torch.randn(BATCH, T, H, generator=gen).to(dev)
    _, resid = bl._launch_forward(x, p, 12, T, seed, rates, True, True)

    def k1():
        return bl.bert_layer_backward(g, x, p, resid, 12, T, seed, rates,
                                      True)

    dx, dps = k1()
    ins, plain = _plain_backward(
        lambda x_, *p_: bl.bert_layer_reference(x_, p_, 12, T, seed, rates,
                                                True), (x,) + p, g)
    want = plain()
    torch.cuda.synchronize()
    errs = [_close("K1 backward dx", dx, want[0], ATOL, RTOL)]
    errs += [_close_rel(f"K1 backward dparams[{i}]", a, b, SUM_REL)
             for i, (a, b) in enumerate(zip(dps, want[1:]))]
    report("K1 bert_layer backward", "", errs, k1, plain, "bert_layer.cu",
           "bert_layer.py:1008")

    # K2 / K3: B 4 x 196 windows x 36 x 12, 6 heads, dropout and DropPath
    self_p, cross_p, bias, xw, yw = _fusion_inputs(gen)
    gw = torch.randn(xw.shape, generator=gen).to(dev)
    dp = (torch.rand(BATCH, 2, generator=gen) > 0.1).float().to(dev) / 0.9
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).to(dev)
        for cross, params in ((False, self_p), (True, cross_p)):
            key = ("K3 cross_fusion_block backward" if cross
                   else "K2 fusion_block backward")
            _, x2r = fb._launch_forward(xw, yw if cross else None, params,
                                        bias, mask, dp, seed, rates, True,
                                        True, cross)
            if cross:
                def kern(params=params, mask=mask, x2r=x2r):
                    return fb.fused_cross_fusion_block_backward(
                        gw, xw, yw, params, bias, mask, dp, seed, rates, True,
                        x2r)
                got = kern()
                ins, plain = _plain_backward(
                    lambda x_, y_, b_, *p_, mask=mask:
                        fb.cross_fusion_block_reference(
                            x_, y_, p_, b_, mask, dp, seed, rates, True),
                    (xw, yw, bias) + params, gw)
                want = plain()
                torch.cuda.synchronize()
                errs = [_close(f"{key} dx", got[0], want[0], ATOL, RTOL),
                        _close(f"{key} dy", got[1], want[1], ATOL, RTOL),
                        _close_rel(f"{key} dbias", got[2], want[2], SUM_REL)]
                grads = got[3]
            else:
                def kern(params=params, mask=mask, x2r=x2r):
                    return fb.fused_fusion_block_backward(
                        gw, xw, params, bias, mask, dp, seed, rates, True,
                        x2r)
                got = kern()
                ins, plain = _plain_backward(
                    lambda x_, b_, *p_, mask=mask: fb.fusion_block_reference(
                        x_, p_, b_, mask, dp, seed, rates, True),
                    (xw, bias) + params, gw)
                want = [None] + list(plain())
                torch.cuda.synchronize()
                errs = [_close(f"{key} dx", got[0], want[1], ATOL, RTOL),
                        _close_rel(f"{key} dbias", got[1], want[2], SUM_REL)]
                grads = got[2]
            errs += [_close_rel(f"{key} dparams[{i}]", a, b, SUM_REL)
                     for i, (a, b) in enumerate(zip(grads, want[3:]))]
            report(key, f"shift {shift}", errs, kern, plain,
                   "fusion_block.cu", "fusion_block.py:905")

    # K4: the SwinV2 head's three stages
    for q, k, v, b4, mask, label in _k4_inputs(gen):
        out = att.fused_window_attention(q, k, v, b4, mask)
        g4 = torch.randn(q.shape, generator=gen).to(dev)

        def kern(q=q, k=k, v=v, b4=b4, mask=mask, out=out, g4=g4):
            return att.window_attention_backward(g4, q, k, v, b4, mask, out)

        got = kern()
        ins, plain = _plain_backward(
            lambda q_, k_, v_, b_, mask=mask: att.attention_reference(
                q_, k_, v_, b_, mask), (q, k, v, b4), g4)
        want = plain()
        torch.cuda.synchronize()
        errs = [_close(f"K4 backward d{n}", a, b, ATOL, RTOL)
                for n, a, b in zip("qkv", got[:3], want[:3])]
        errs.append(_close_rel("K4 backward dbias", got[3], want[3], SUM_REL))
        report("K4 window_attention backward", label, errs, kern, plain,
               "window_attention.cu", "attention.py:332")

    # K5 over the flagship's parameter count, AdamW with clipping
    pk, gk, mk = (torch.randn(n_params, generator=gen).to(dev)
                  for _ in range(3))
    nk = torch.rand(n_params, generator=gen).to(dev)
    clip = torch.tensor([0.5], device=dev)
    state = [t.clone() for t in (pk, mk, nk)]
    args = (clip, 1e-3, 10.0, 1000.0, 0.9, 0.999, 1e-8, 1e-5, True)
    fu.fused_adam_update(pk, gk, mk, nk, *args)
    fu.fused_adam_reference(state[0], gk, state[1], state[2], *args)
    torch.cuda.synchronize()
    errs = [_close(f"K5 {n}", a, b, ATOL, RTOL)
            for n, a, b in zip(("p", "mu", "nu"), (pk, mk, nk), state)]
    report("K5 fused_adam", f"{n_params} params", errs,
           lambda: fu.fused_adam_update(pk, gk, mk, nk, *args),
           lambda: fu.fused_adam_reference(state[0], gk, state[1], state[2],
                                           *args),
           "fused_update.cu", "fused_update.py:106")


def _cohort(rng, n, first):
    """In-memory records {subject, fmri (84, T), struct, target} with a
    label-linked signal: positives carry a slow fMRI oscillation and a
    stronger struct diagonal."""
    records = []
    for i in range(n):
        y = float(i % 2)
        T = int(rng.integers(350, 369))
        t = np.arange(T)[None, :]
        drift = np.sin(2 * np.pi * t / rng.uniform(150, 400, (84, 1)))
        fmri = (rng.normal(size=(84, T)) + 2.0 * drift + 100.0
                + 1.5 * y * np.sin(2 * np.pi * t / 40.0))
        s = rng.normal(size=(84, 84))
        records.append({"subject": f"sub-{first + i:03d}", "fmri": fmri,
                        "struct": (s + s.T) / 2 + 3.0 * y * np.eye(84),
                        "target": y})
    return records


def _flagship_cfg(**kw):
    from multimodal_neuroimage_tpu_torch.config import Config
    return Config(task="FuncStruct", dataset_name="multimodal",
                  multimodality_type="cross_attention", target="sex",
                  fine_tune_task="binary_classification", batch_size=BATCH,
                  compute_dtype="float32", preprocess="host", nEpochs=2,
                  experiment_title="flagship", seed=SEED, **kw).validate()


def _sign_stable_update_check(name, p_gpu, p_cpu, g_gpu, g_cpu, lr):
    """Updated parameters after one Adam step: where the gradient's sign is
    the same on both sides (|g_cpu| > 10 |g_gpu - g_cpu| + 1e-7) the update
    is +-lr(1 - O(eps/|g|)) on both, so the parameters must agree to 1e-5;
    where a gradient is so small that its sign differs between the two
    summation orders, the step may differ by up to 2 lr."""
    diff = (p_gpu - p_cpu).abs()
    stable = g_cpu.abs() > 10 * (g_gpu - g_cpu).abs() + 1e-7
    if not torch.isfinite(p_gpu).all():
        raise AssertionError(f"{name}: non-finite parameters")
    if stable.any() and diff[stable].max() > 1e-5:
        raise AssertionError(f"{name}: updated params differ by "
                             f"{diff[stable].max().item():.3e} where the "
                             f"gradient sign is stable")
    if diff.max() > 2 * lr + 1e-5:
        raise AssertionError(f"{name}: update differs by more than 2 lr")
    return diff.max().item(), int((~stable).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import load_checkpoint
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.ops import build
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        Predictor, make_predict_step)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer

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

    cfg = _flagship_cfg()
    n_params = sum(p.numel() for p in create_model(cfg).parameters())
    gen = torch.Generator().manual_seed(SEED)
    results = Results()
    forward_kernels(gen, results)
    backward_kernels(gen, results, n_params)

    rng = np.random.default_rng(SEED)
    train_records = _cohort(rng, N_TRAIN, 0)
    val_records = _cohort(rng, N_VAL, N_TRAIN)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        # ---- (b) the training run -----------------------------------------
        trainer = Trainer(cfg, train_records, val_records, device="cuda",
                          experiment_folder=tmp)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        metrics = trainer.training()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_counts = ops.launches()
        print(f"launches in the training run: {train_counts}")
        missing = [k for k, n in train_counts.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels not launched by the training "
                                 f"run: {missing}")
        if not np.isfinite(trainer.step_losses).all():
            raise AssertionError(f"non-finite training loss: "
                                 f"{trainer.step_losses}")
        ckpt = trainer.best_checkpoint()
        if ckpt is None:
            raise AssertionError("no best-AUROC checkpoint was written")
        meta = load_checkpoint(ckpt)["metadata"]
        print(f"trained {cfg.nEpochs} epochs x {trainer.steps_per_epoch} "
              f"steps in {train_wall:.1f} s; step losses "
              f"{[round(v, 4) for v in trainer.step_losses]}; "
              f"train_AUROC {metrics.get('train_AUROC')}, val_AUROC "
              f"{metrics.get('val_AUROC')}; best checkpoint "
              f"{os.path.basename(ckpt)} (val_AUROC {meta['best_auroc']}, "
              f"val_threshold {meta['val_threshold']})")

        # ---- serving from the trained checkpoint --------------------------
        requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                    for r in val_records]
        pred = Predictor(cfg, ckpt, requests, device="cuda")
        pred.predict()                                   # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        scores = pred.predict(write_csv=os.path.join(tmp, "predictions.csv"))
        torch.cuda.synchronize()
        serve_wall = time.perf_counter() - t0
        serve_counts = ops.launches()
        with open(os.path.join(tmp, "predictions.csv")) as f:
            rows = f.read().strip().splitlines()
        print(f"launches in the serving run: {serve_counts}")
        forward = [k for k in serve_counts
                   if "backward" not in k and "adam" not in k]
        if len(forward) != 4 or any(serve_counts[k] == 0 for k in forward):
            raise AssertionError(f"forward kernels not launched by the "
                                 f"serving run: {serve_counts}")
        if len(scores) != N_VAL or len(rows) != N_VAL + 1:
            raise AssertionError(f"expected {N_VAL} subjects, got "
                                 f"{len(scores)} scores, {len(rows) - 1} rows")
        for subject, row in scores.items():
            if not (0.0 < row["score"] < 1.0) or row["label"] != float(
                    row["score"] > pred.threshold):
                raise AssertionError(f"bad prediction for {subject}: {row}")
        cpu_model = create_model(cfg)
        cpu_model.load_state_dict(load_checkpoint(ckpt)["state_dict"])
        cpu_step = make_predict_step(cpu_model, "float32", device="cpu")
        logit_err = 0.0
        for batch, _ in pred.batches():
            got = pred.step(batch)["binary_classification"].cpu()
            want = cpu_step(batch)["binary_classification"]
            logit_err = max(logit_err, _close("serving logits", got, want,
                                              LOGIT_ATOL, LOGIT_RTOL))
        first, _ = next(pred.batches())
        fwd = _time_ms(lambda: pred.step(first), iters=5)
        print(f"served {N_VAL} requests in {serve_wall:.3f} s: "
              f"{N_VAL / serve_wall:.2f} requests/s end to end (host band "
              f"split included); predict step {fwd:.2f} ms per batch of "
              f"{BATCH}; logits vs CPU max|err| {logit_err:.3e} (atol "
              f"{LOGIT_ATOL} + rtol {LOGIT_RTOL}); card: {card}")

    # ---- (c) one training step on the card against the CPU ----------------
    specs = active_losses(cfg.task, cfg.fine_tune_task)
    batch, _ = next(trainer.batches("train"))
    lr = 1e-3
    models, opts, steps = {}, {}, {}
    for dev in ("cuda", "cpu"):
        m = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED + 1))
        m.to(dev)
        opts[dev] = create_optimizer("AdamW", m.parameters(), lambda t: lr,
                                     cfg.weight_decay)
        steps[dev] = make_train_step(m, specs, opts[dev], "float32", dev)
        models[dev] = m
    out = {dev: steps[dev](batch, torch.Generator().manual_seed(SEED + 2))
           for dev in ("cuda", "cpu")}
    torch.cuda.synchronize()
    loss_gpu = out["cuda"][0]["total"].item()
    loss_cpu = out["cpu"][0]["total"].item()
    _close("step loss", torch.tensor([loss_gpu]), torch.tensor([loss_cpu]),
           LOGIT_ATOL, LOGIT_RTOL)
    grad_err = upd_err = 0.0
    unstable = 0
    named = dict(models["cpu"].named_parameters())
    for n, p in models["cuda"].named_parameters():
        q = named[n]
        grad_err = max(grad_err, _close_rel(f"grad {n}", p.grad.cpu(),
                                            q.grad, GRAD_REL))
        e, u = _sign_stable_update_check(f"param {n}", p.detach().cpu(),
                                         q.detach(), p.grad.cpu(), q.grad, lr)
        upd_err, unstable = max(upd_err, e), unstable + u
    print(f"one training step, card vs CPU: loss {loss_gpu:.6f} vs "
          f"{loss_cpu:.6f}; every gradient within {GRAD_REL} * its max-abs "
          f"(worst abs err {grad_err:.3e}); updated params max|diff| "
          f"{upd_err:.3e}, {unstable} of {n_params} elements with a "
          f"sign-unstable gradient")
    del models, opts, steps, out

    # ---- (d) training-step time ------------------------------------------
    batches = [b for b, _ in trainer.batches("train")]
    for i in range(3):
        trainer.train_step(batches[i % len(batches)], trainer.generator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(12):
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)], trainer.generator)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"training step (fwd + bwd + K5, batch {BATCH}, host batch "
          f"prepared): median {med:.3f} ms (q1 {q1:.3f}, q3 {q3:.3f}) over "
          f"12 steps; {BATCH / med * 1e3:.2f} subjects/s; peak device memory "
          f"{peak:.0f} MiB; card: {card}")
    calls = {"K1 bert_layer backward": 32, "K2 fusion_block backward": 48,
             "K3 cross_fusion_block backward": 12,
             "K4 window_attention backward": 10, "K5 fused_adam": 1}
    share = {k: results.rows[k]["ms"] / results.rows[k]["cases"] * n
             for k, n in calls.items()}
    print("backward kernels per step (kernel ms x calls): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in sorted(share.items(),
                                             key=lambda kv: -kv[1])))

    kernels = []
    for key in ops.kernels():
        r = results.rows[key]
        kernels.append({"name": key, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": train_counts[key],
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"] / r["cases"],
                        "plain_ms": r["plain_ms"] / r["cases"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


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


if __name__ == "__main__":
    sys.exit(main())
