"""K1 (the BERT layer) at the flagship's widths (T 369, H 84, 12 heads, F
3072, dropout 0.1): for each batch, each entry's device time split by
kernel (``torch.profiler``, per call), its launches per call, its device
scratch bytes and its call time.

    python -m multimodal_neuroimage_tpu_torch.bench.k1_split [f32] [B ...]

By default the mm16 form (the layer at the bf16 policy): the training
forward (``bert_layer_forward16`` with the residuals saved) and
``bert_layer_backward16``. With ``f32`` the float32 layer: the training
forward (residuals saved), the inference forward and the backward. Default
batches: 4, 16 and 64. It uses only entry points that older checkouts of the
port (with the mm16 form) have too, so that, run by its path with another
checkout's root on ``PYTHONPATH``, it splits that checkout's kernels. Needs a CUDA card;
prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

H, F_, T, HEADS = 84, 3072, 369, 12
RATES, SEED = (0.1, 0.1), 13579


def params16(gen, H=H, F_=F_, device="cuda"):
    """K1's 16 parameters as the bf16 policy gives them to the kernel: bf16
    values in float32 tensors (uniform weights at 1/sqrt(fan-in), LN scales
    near 1)."""
    def lin(o, i):
        b = i ** -0.5
        return [(torch.rand(o, i, generator=gen) * 2 - 1) * b,
                (torch.rand(o, generator=gen) * 2 - 1) * b]

    def ln(c):
        return [1 + 0.1 * torch.randn(c, generator=gen),
                0.1 * torch.randn(c, generator=gen)]
    p = sum((lin(H, H) for _ in range(4)), []) + ln(H) + lin(F_, H) \
        + lin(H, F_) + ln(H)
    return tuple(t.to(torch.bfloat16).float().to(device) for t in p)


def scratch_bytes(B: int, f32: bool = False) -> dict:
    """Device scratch of each entry at batch B (the residuals apart)."""
    from multimodal_neuroimage_tpu_torch.ops import build
    lib = build.library()
    if f32:
        fwd = 4 * lib.value("bert_layer_scratch_floats", B, T, H, F_)
        return {"forward": fwd, "inference": fwd,
                "backward": 4 * lib.value(
                    "bert_layer_backward_scratch_floats", B, T, H, F_,
                    HEADS),
                "resid": 4 * lib.value("bert_layer_resid_floats", B, T, H,
                                       HEADS)}
    return {"forward": 4 * lib.value("bert_layer_scratch16_floats",
                                     B, T, H, F_, HEADS),
            "backward": 4 * lib.value("bert_layer_backward16_scratch_floats",
                                      B, T, H, F_, HEADS),
            "resid": 4 * lib.value("bert_layer_resid_floats", B, T, H,
                                   HEADS)}


# the profiler's window held open this long before the first call and
# after the last call's end (``launch_split``)
WINDOW_PAD_S = 0.005


def launch_split(fn, iters: int = 10) -> dict:
    """{device item: (launches a call, device us a call)} of ``iters``
    calls of ``fn``, from ``torch.profiler``. The profiler keeps only the
    device activity that falls inside the window it recorded, so a window
    opened right before the first launch and closed right after the
    synchronize lost some launches, now and then all of them
    (``bench/profiler_windows.py``: 3 of 400 windows of 10 K4 backward
    calls); the window is held open ``WINDOW_PAD_S`` before the first
    call and after the last one's end."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us:
            out[e.key] = (e.count / iters, us / iters)
    return out


def entries(B: int, gen, f32: bool = False) -> dict:
    """{entry: closure} of one layer at batch B over seeded inputs: the
    training forward and the backward (and, ``f32``, the inference
    forward)."""
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    p = params16(gen)
    x, g = (torch.randn(B, T, H, generator=gen).cuda() for _ in "xg")
    mm16 = not f32
    _, resid = bl._launch_forward(x, p, HEADS, T, SEED, RATES, True, True,
                                  mm16)

    def forward():
        return bl._launch_forward(x, p, HEADS, T, SEED, RATES, True, True,
                                  mm16)

    def inference():
        return bl._launch_forward(x, p, HEADS, T, 0, (0.0, 0.0), False,
                                  False, mm16)

    def backward():
        return bl.bert_layer_backward(g, x, p, resid, HEADS, T, SEED, RATES,
                                      True, mm16)
    out = {"forward": forward, "backward": backward}
    if f32:
        out["inference"] = inference
    return out


def report(B: int, gen, f32: bool = False) -> dict:
    """Print and return the split, launches and scratch of the entries at
    batch B."""
    from multimodal_neuroimage_tpu_torch.bench.timing import events_ms
    fns = entries(B, gen, f32)
    res = {"batch": B, "scratch_bytes": scratch_bytes(B, f32)}
    form = "float32" if f32 else "mm16"
    for name, fn in fns.items():
        iters = 10 if name == "backward" else 20
        split = launch_split(fn)
        ms = events_ms(fn, iters)
        launches = sum(n for n, _ in split.values())
        busy = sum(us for _, us in split.values())
        print(f"K1 {form} {name} batch {B}: call {ms:.4f} ms, device "
              f"{busy / 1e3:.4f} ms in {launches:g} launches; scratch "
              f"{res['scratch_bytes'][name]} B")
        for key, (n, us) in sorted(split.items(), key=lambda kv: -kv[1][1]):
            print(f"    {us:9.2f} us  x{n:g}  {key[:110]}")
        res[name] = {"ms": ms, "device_ms": busy / 1e3,
                     "launches": launches, "split_us": {
                         k: us for k, (_, us) in split.items()}}
    return res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("k1_split: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    f32 = argv[:1] == ["f32"]
    gen = torch.Generator().manual_seed(3)
    for B in [int(a) for a in argv[f32:]] or [4, 16, 64]:
        report(B, gen, f32)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
