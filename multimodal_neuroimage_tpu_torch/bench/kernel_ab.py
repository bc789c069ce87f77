"""Kernels and the flagship steps around them, timed in two or more
checkouts of the repository on one CUDA card, in turns.

    python -m multimodal_neuroimage_tpu_torch.bench.kernel_ab [--cases LIST] BASE [OTHER ...]

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
- K4 forward and backward, six cases each: the SwinV2 head's three stages
  at batch 4, attention dropout 0 and 0.1; the call time (CUDA events
  around 20 back-to-back calls, as ``chip_smoke.py`` times every kernel)
  and the device time (one replay of a CUDA graph that captured 20 calls);
- K1's float32 forward (``k1_fwd``) at batch 4, 16 and 64 (T 369, H 84, 12
  heads, F 3072): the training forward (dropout 0.1, residuals saved) and
  the inference forward, 20 back-to-back calls;

- K1 backward (``k1``) at batch 4 and 16 (T 369, H 84, 12 heads, F 3072,
  dropout 0.1): CUDA events around 10 back-to-back calls;
- K1's mm16 form (``k1_16``, the bf16 policy's layer) at batch 4, 16 and
  64 (bf16-valued weights, dropout 0.1): the training forward with the
  residuals saved (20 back-to-back calls) and the backward (10);
- the same mm16 form at phase 2's ultralow BERT length (``k1_16_short``:
  t_valid 129 padded to 136, batch 8, 12 heads): the inference forward
  (``bert_layer_call16``, as ``chip_smoke.py``'s phase 2 times it), the
  training forward and the backward, each the call time (CUDA events
  around back-to-back calls) and the device time (a CUDA graph's replay);
- the fusion backward (``fusion``) at batch 16 and 64, dropout 0.1 and
  DropPath on, shift 0 and 3, self and cross: K2/K3 on (B, 196, 36, 12)
  windows and K7 on groups of G = 8, 10 back-to-back calls;
- K6 (``k6``) at HCP's (8, 2, 1201, 11), dropout 0 and 0.1: the bf16 form
  (bf16 q/k/v/dO) and the float32 form, each the forward (20 back-to-back
  calls) and the backward (10);
- the fusion forward (``fusion_fwd``) at batch 4, 16 and 64, shift 0 and 3,
  self and cross: K2/K3 on (B, 196, 36, 12) windows, and at batch 16 and 64
  K7 on groups of G = 8 on float32 and on bf16 streams; each the training
  forward (dropout 0.1, DropPath, x2r saved) and the inference forward, 20
  back-to-back calls;

and once, the flagship ``FuncStructCross`` (random weights from a seed,
float32): at batch 4 (``flagship``) 12 CUDA-synchronised training steps and
12 predict steps, and at batch 16 (``step16``) 12 training steps on each
fusion layout, std then bp; and HCP phase 1's ``TransformerNet`` at its
default bf16 policy (``hcp16``, batch 8, T 1201, 16 layers on K6's bf16
form): 12 training steps, and (``hcp``) the same at bf16 and at float32
(K6's float32 form) in turns, bf16, float32, float32, bf16; and the flagship at its bf16 policy on the std
layout (``bf16``): 12 training steps at batch 16, then 12 predict steps at
batch 4 and 16 at bf16 and at float32 in turns. Each after 3 of warm-up, on
the host clock.

``--cases`` picks the groups (comma-separated; default all of k8, k4,
k1_fwd, k1, k1_16, k1_16_short, fusion, k6, fusion_fwd, flagship, step16,
hcp16, hcp, bf16).

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
GROUPS = ("k8", "k4", "k1_fwd", "k1", "k1_16", "k1_16_short", "fusion", "k6",
          "fusion_fwd",
          "flagship", "step16", "hcp16", "hcp", "bf16")


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
        g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda()
        for rate in (0.0, 0.1):
            def call(rate=rate, q=q, k=k, v=v, bias=bias, mask=mask):
                return att.fused_window_attention(q, k, v, bias, mask, 7, rate)
            o = call()

            def back(rate=rate, q=q, k=k, v=v, bias=bias, mask=mask, o=o,
                     g=g):
                return att.window_attention_backward(g, q, k, v, bias, mask,
                                                     o, 7, rate)
            for name, fn in (("", call), ("backward ", back)):
                key = f"{name}N{N} heads{heads} rate {rate}"
                out["k4 call"].setdefault(key, []).append(T.events_ms(fn))
                out["k4 device"].setdefault(key, []).append(
                    T.graph_ms(fn)[0])


def _lin(gen, o, i):
    b = 1.0 / np.sqrt(i)
    return [(torch.rand(o, i, generator=gen) * 2 - 1) * b,
            (torch.rand(o, generator=gen) * 2 - 1) * b]


def _ln(gen, c):
    return [1 + 0.1 * torch.randn(c, generator=gen),
            0.1 * torch.randn(c, generator=gen)]


def _k1(out, T):
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    gen = torch.Generator().manual_seed(11)
    H, F_, L, rates, seed = 84, 3072, 369, (0.1, 0.1), 12345
    p = tuple(t.cuda() for t in sum((_lin(gen, H, H) for _ in range(4)), [])
              + _ln(gen, H) + _lin(gen, F_, H) + _lin(gen, H, F_)
              + _ln(gen, H))
    for B in (4, 16):
        x, g = (torch.randn(B, L, H, generator=gen).cuda() for _ in "xg")
        _, resid = bl._launch_forward(x, p, 12, L, seed, rates, True, True)
        out["k1 backward"].setdefault(f"batch {B}", []).append(T.events_ms(
            lambda: bl.bert_layer_backward(g, x, p, resid, 12, L, seed,
                                           rates, True), iters=10))


def _k1_fwd(out, T):
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    gen = torch.Generator().manual_seed(29)
    H, F_, L, rates, seed = 84, 3072, 369, (0.1, 0.1), 12345
    p = tuple(t.cuda() for t in sum((_lin(gen, H, H) for _ in range(4)), [])
              + _ln(gen, H) + _lin(gen, F_, H) + _lin(gen, H, F_)
              + _ln(gen, H))
    for B in (4, 16, 64):
        x = torch.randn(B, L, H, generator=gen).cuda()
        out["k1 forward"].setdefault(f"training batch {B}", []).append(
            T.events_ms(lambda x=x: bl._launch_forward(
                x, p, 12, L, seed, rates, True, True)))
        out["k1 forward"].setdefault(f"inference batch {B}", []).append(
            T.events_ms(lambda x=x: bl._launch_forward(
                x, p, 12, L, 0, (0.0, 0.0), False, False)))


def _k1_16(out, T):
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    gen = torch.Generator().manual_seed(19)
    H, F_, L, rates, seed = 84, 3072, 369, (0.1, 0.1), 12345
    p = tuple(t.to(torch.bfloat16).float().cuda() for t in
              sum((_lin(gen, H, H) for _ in range(4)), []) + _ln(gen, H)
              + _lin(gen, F_, H) + _lin(gen, H, F_) + _ln(gen, H))
    for B in (4, 16, 64):
        x, g = (torch.randn(B, L, H, generator=gen).cuda() for _ in "xg")

        def forward(x=x):
            return bl._launch_forward(x, p, 12, L, seed, rates, True, True,
                                      True)
        _, resid = forward()
        out["k1 mm16"].setdefault(f"forward batch {B}", []).append(
            T.events_ms(forward))
        out["k1 mm16"].setdefault(f"backward batch {B}", []).append(
            T.events_ms(lambda x=x, g=g, resid=resid: bl.bert_layer_backward16(
                g, x, p, resid, 12, L, seed, rates, True), iters=10))


def _fusion(out, T):
    gen = torch.Generator().manual_seed(13)
    G, C, Hh, N, nW = 8, 12, 6, 36, 196
    params = {False: tuple(t.cuda() for t in _ln(gen, C) + _lin(gen, 3 * C, C)
                           + _lin(gen, C, C) + _ln(gen, C)
                           + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C)),
              True: tuple(t.cuda() for t in _ln(gen, C) + _ln(gen, C)
                          + _lin(gen, C, C) + _lin(gen, 2 * C, C)
                          + _lin(gen, C, C) + _ln(gen, C)
                          + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))}
    bias = (0.5 * torch.randn(Hh, N, N, generator=gen)).cuda()
    for B in (16, 64):
        _fusion_batch(out, T, B, G, nW, N, C, params, bias, gen)


def _fusion_batch(out, T, B, G, nW, N, C, params, bias, gen):
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    xw, yw, gw = (torch.randn(B, nW, N, C, generator=gen).cuda()
                  for _ in "xyg")
    xg, yg, gg = (fbp.to_groups(t, G).contiguous() for t in (xw, yw, gw))
    dp = (torch.rand(B, 2, generator=gen) > 0.1).float().cuda() / 0.9
    train = (dp, 2468, (0.1, 0.1), True)
    for shift in (0, 3):
        m = shift_attn_mask(84, 84, 6, shift)
        mask = None if m is None else torch.from_numpy(m).cuda()
        for cross in (False, True):
            p = params[cross]
            _, x2r = fb._launch_forward(xw, yw if cross else None, p, bias,
                                        mask, *train, True, cross)
            _, x2g = fbp._launch_forward(xg, yg if cross else None, p, bias,
                                         mask, *train, True, cross, G)
            if cross:
                std = (lambda p=p, mask=mask, x2r=x2r:
                       fb.fused_cross_fusion_block_backward(
                           gw, xw, yw, p, bias, mask, *train, x2r))
                bp = (lambda p=p, mask=mask, x2g=x2g:
                      fbp.fused_cross_fusion_block_bp_backward(
                          gg, xg, yg, p, bias, mask, *train, x2g))
            else:
                std = (lambda p=p, mask=mask, x2r=x2r:
                       fb.fused_fusion_block_backward(
                           gw, xw, p, bias, mask, *train, x2r))
                bp = (lambda p=p, mask=mask, x2g=x2g:
                      fbp.fused_fusion_block_bp_backward(
                          gg, xg, p, bias, mask, *train, x2g))
            kind = "cross" if cross else "self"
            for name, fn in ((f"K{3 if cross else 2} {kind}", std),
                             (f"K7 {kind}", bp)):
                out["fusion backward"].setdefault(
                    f"{name} B{B} shift {shift}", []).append(
                        T.events_ms(fn, iters=10))


def _fusion_fwd(out, T):
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    gen = torch.Generator().manual_seed(23)
    G, C, Hh, N, nW = 8, 12, 6, 36, 196
    params = {False: tuple(t.cuda() for t in _ln(gen, C) + _lin(gen, 3 * C, C)
                           + _lin(gen, C, C) + _ln(gen, C)
                           + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C)),
              True: tuple(t.cuda() for t in _ln(gen, C) + _ln(gen, C)
                          + _lin(gen, C, C) + _lin(gen, 2 * C, C)
                          + _lin(gen, C, C) + _ln(gen, C)
                          + _lin(gen, 4 * C, C) + _lin(gen, C, 4 * C))}
    bias = (0.5 * torch.randn(Hh, N, N, generator=gen)).cuda()
    infer = (None, 0, (0.0, 0.0), False, False)
    for B in (4, 16, 64):
        xw, yw = (torch.randn(B, nW, N, C, generator=gen).cuda() for _ in "xy")
        dp = (torch.rand(B, 2, generator=gen) > 0.1).float().cuda() / 0.9
        train = (dp, 2468, (0.1, 0.1), True, True)
        streams = {"std": (xw, yw)}
        if B % G == 0:
            xg, yg = (fbp.to_groups(t, G).contiguous() for t in (xw, yw))
            streams["bp f32"] = (xg, yg)
            streams["bp bf16"] = (xg.to(torch.bfloat16), yg.to(torch.bfloat16))
        for shift in (0, 3):
            m = shift_attn_mask(84, 84, 6, shift)
            mask = None if m is None else torch.from_numpy(m).cuda()
            for cross in (False, True):
                kind = "cross" if cross else "self"
                for layout, (x, y) in streams.items():
                    y = y if cross else None
                    name = (f"K{3 if cross else 2} {kind}" if layout == "std"
                            else f"K7 {kind} {layout.split()[1]}")
                    for mode, args in (("train", train), ("infer", infer)):
                        if layout == "std":
                            fn = (lambda x=x, y=y, mask=mask, args=args,
                                  cross=cross: fb._launch_forward(
                                      x, y, params[cross], bias, mask, *args,
                                      cross))
                        else:
                            fn = (lambda x=x, y=y, mask=mask, args=args,
                                  cross=cross: fbp._launch_forward(
                                      x, y, params[cross], bias, mask, *args,
                                      cross, G))
                        out["fusion forward"].setdefault(
                            f"{name} {mode} B{B} shift {shift}", []).append(
                                T.events_ms(fn))


def _k6(out, T):
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    gen = torch.Generator().manual_seed(17)
    q, k, v, g = (torch.randn(8, 2, 1201, 11, generator=gen).cuda()
                  .to(torch.bfloat16) for _ in range(4))
    q = (q.float() / 3.3125).to(torch.bfloat16)
    for rate in (0.0, 0.1):
        _, out32, lse = att._launch_mha_forward16(q, k, v, 7, rate, True)
        out["k6"].setdefault(f"forward rate {rate}", []).append(T.events_ms(
            lambda rate=rate: att._launch_mha_forward16(q, k, v, 7, rate,
                                                        False)))
        out["k6"].setdefault(f"backward rate {rate}", []).append(
            T.events_ms(lambda rate=rate, out32=out32, lse=lse:
                        att.fused_attention_backward16(g, q, k, v, out32, lse,
                                                       7, rate), iters=10))
    q, k, v, g = (torch.randn(8, 2, 1201, 11, generator=gen).cuda()
                  for _ in range(4))
    q = q * 11 ** -0.5
    for rate in (0.0, 0.1):
        o, lse = att._launch_mha_forward(q, k, v, 7, rate)
        out["k6"].setdefault(f"f32 forward rate {rate}", []).append(
            T.events_ms(lambda rate=rate: att._launch_mha_forward(q, k, v, 7,
                                                                  rate)))
        out["k6"].setdefault(f"f32 backward rate {rate}", []).append(
            T.events_ms(lambda rate=rate, o=o, lse=lse:
                        att.fused_attention_backward(g, q, k, v, o, lse, 7,
                                                     rate), iters=10))


def _hcp_steps(out, dtypes):
    """HCP phase 1's training step at batch 8 on series of 900-1200 TRs
    (random weights from a seed) at each compute dtype of ``dtypes``, in
    that order: bfloat16 is the default policy (K6's bf16 form), float32
    runs K6's float32 form."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data.loader import collate, hcp_item
    steps = {}
    for dtype in dict.fromkeys(dtypes):
        cfg = Config(step=1, task="2DBERT", dataset_name="hcp",
                     target="sex", compute_dtype=dtype).validate()
        rng = np.random.default_rng(6)
        items = []
        for i in range(cfg.batch_size):
            item = hcp_item({"subject": f"h{i}", "fmri": rng.normal(
                size=(22, int(rng.integers(900, 1201)))) + 100.0}, cfg)
            item["target"] = np.float32(i % 2)
            items.append(item)
        batch = collate(items)[0]
        steps[dtype] = (cfg.batch_size, batch, _train_step(cfg, dtype)[1])
    gen = torch.Generator().manual_seed(2)
    for dtype in dtypes:
        B, batch, step = steps[dtype]
        name = "bf16" if dtype == "bfloat16" else "f32"
        out["hcp"].setdefault(f"{name} train step (batch {B})", []).extend(
            _step_times(lambda step=step, batch=batch: step(batch, gen)))


def _flagship_batch(B, rng):
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                             multimodal_item)
    cfg = Config(task="FuncStruct", dataset_name="multimodal",
                 multimodality_type="cross_attention", target="sex",
                 fine_tune_task="binary_classification", batch_size=B,
                 compute_dtype="float32", preprocess="host").validate()
    items = []
    for i in range(B):
        item = multimodal_item({"subject": f"s{i}",
                                "fmri": rng.normal(size=(84, 368)) + 100.0,
                                "struct": rng.normal(size=(84, 84))}, cfg)
        item["target"] = np.float32(i % 2)
        items.append(item)
    return cfg, collate(items)[0]


def _train_step(cfg, dtype="float32"):
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                             make_train_step)
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1)).cuda()
    opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-4,
                           cfg.weight_decay)
    step = make_train_step(model, active_losses(cfg.task, cfg.fine_tune_task),
                           opt, dtype, "cuda")
    return model, step


def _step16(out):
    from multimodal_neuroimage_tpu_torch.nn import swinfusion
    cfg, batch = _flagship_batch(16, np.random.default_rng(4))
    _, step = _train_step(cfg)
    gen = torch.Generator().manual_seed(2)
    for layout in ("std", "bp"):
        swinfusion._LAYOUT = layout
        out["flagship"][f"batch 16 train step ({layout})"] = _step_times(
            lambda: step(batch, gen))
    swinfusion._LAYOUT = "std"


def _bf16(out):
    """The flagship at its bf16 policy on the std layout: the training step
    at batch 16, then the predict step at batch 4 and 16, bf16 and float32
    in turns."""
    from multimodal_neuroimage_tpu_torch.nn import swinfusion
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    swinfusion._LAYOUT = "std"
    gen = torch.Generator().manual_seed(2)
    for B in (16, 4):
        cfg, batch = _flagship_batch(B, np.random.default_rng(5))
        model, step = _train_step(cfg, "bfloat16")
        if B == 16:
            out["flagship"]["bf16 batch 16 train step (std)"] = _step_times(
                lambda: step(batch, gen))
        for dtype in ("bfloat16", "float32", "float32", "bfloat16"):
            predict = make_predict_step(model, dtype, device="cuda")
            out["flagship"].setdefault(
                f"{dtype} batch {B} predict step", []).extend(
                    _step_times(lambda: predict(batch)))


def _flagship(out):
    from multimodal_neuroimage_tpu_torch.serve.predictor import (
        make_predict_step)
    cfg, batch = _flagship_batch(BATCH, np.random.default_rng(3))
    model, step = _train_step(cfg)
    gen = torch.Generator().manual_seed(2)
    out["flagship"]["train step"] = _step_times(lambda: step(batch, gen))
    predict = make_predict_step(model, "float32", device="cuda")
    out["flagship"]["predict step"] = _step_times(lambda: predict(batch))


def _k1_16_short(out, T):
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    gen = torch.Generator().manual_seed(23)
    H, F_, L, B, rates, seed = 84, 3072, 129, 8, (0.1, 0.1), 12345
    p = tuple(t.to(torch.bfloat16).float().cuda() for t in
              sum((_lin(gen, H, H) for _ in range(4)), []) + _ln(gen, H)
              + _lin(gen, F_, H) + _lin(gen, H, F_) + _ln(gen, H))
    x, g = (torch.randn(B, L, H, generator=gen).cuda() for _ in "xg")
    _, resid = bl._launch_forward(x, p, 12, L, seed, rates, True, True, True)
    for name, fn, iters in (
            ("inference forward", lambda: bl.bert_layer_call16(x, p, 12, L),
             20),
            ("training forward", lambda: bl._launch_forward(
                x, p, 12, L, seed, rates, True, True, True), 20),
            ("backward", lambda: bl.bert_layer_backward16(
                g, x, p, resid, 12, L, seed, rates, True), 10)):
        out["k1 mm16 T129 call"].setdefault(name, []).append(
            T.events_ms(fn, iters=iters))
        out["k1 mm16 T129 device"].setdefault(name, []).append(
            T.graph_ms(fn, iters=iters)[0])


def worker(groups) -> int:
    from multimodal_neuroimage_tpu_torch.ops import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    T = _timing()
    lib = build.library()
    out = {"root": os.getcwd(), "build_s": lib.build_seconds, "k8": {},
           "k4 call": {}, "k4 device": {}, "k1 forward": {},
           "k1 backward": {}, "k1 mm16": {}, "k1 mm16 T129 call": {},
           "k1 mm16 T129 device": {},
           "fusion backward": {}, "k6": {}, "fusion forward": {},
           "flagship": {}, "hcp": {}}
    for _ in range(ROUNDS):
        for name, fn in (("k8", _k8), ("k4", _k4), ("k1_fwd", _k1_fwd),
                         ("k1", _k1),
                         ("k1_16", _k1_16), ("k1_16_short", _k1_16_short),
                         ("fusion", _fusion), ("k6", _k6),
                         ("fusion_fwd", _fusion_fwd)):
            if name in groups:
                fn(out, T)
    if "flagship" in groups:
        _flagship(out)
    if "step16" in groups:
        _step16(out)
    if "hcp16" in groups:
        _hcp_steps(out, ("bfloat16",))
    if "hcp" in groups:
        _hcp_steps(out, ("bfloat16", "float32", "float32", "bfloat16"))
    if "bf16" in groups:
        _bf16(out)

    print(json.dumps(out), flush=True)
    return 0


def _summary(samples) -> str:
    q1, med, q3 = np.percentile(samples, [25, 50, 75])
    return f"{med:.4f} ({q1:.4f}-{q3:.4f})"


def main(argv) -> int:
    groups = GROUPS
    if argv[:1] == ["--cases"]:
        groups, argv = tuple(argv[1].split(",")), argv[2:]
        if set(groups) - set(GROUPS):
            print(f"kernel_ab: unknown cases {set(groups) - set(GROUPS)}; "
                  f"pick from {GROUPS}", file=sys.stderr)
            return 2
    if argv[:1] == ["--worker"]:
        return worker(groups)
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
                [sys.executable, os.path.abspath(__file__), "--cases",
                 ",".join(groups), "--worker"],
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
    for group in ("k8", "k4 call", "k4 device", "k1 forward", "k1 backward",
                  "k1 mm16", "k1 mm16 T129 call", "k1 mm16 T129 device",
                  "fusion backward", "k6", "fusion forward", "flagship",
                  "hcp"):
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
