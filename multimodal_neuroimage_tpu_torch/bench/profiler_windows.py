"""What the profiler records of a window of short kernel calls: K4's
backward at the SwinV2 head's first stage at batch 4 (B 4, 4 windows, 3
heads, N 36, head dim 4: the case of tests/test_torch_cuda.py
``test_window_attention_backward_flagship_stages[4-0.0]``, whose window
once held no device event), ``windows`` windows each, in one of these
forms:

  bare      10 calls, synchronised, as ``bench/k1_split.launch_split``
            opened its window before (the profiler started right before
            the calls and stopped right after them)
  single    one call, the same way
  padded    one call, the window held open ``WINDOW_PAD_S`` before the
            call and after its end (host sleeps inside the window)
  cycle     10 calls recorded as the second of two cycles under
            ``torch.profiler.schedule(warmup=1, active=1)`` (a warm-up
            cycle first), captured when the cycle's trace is ready
  split     ``launch_split`` as it is now: 10 calls, the window held open
            as ``padded``

Prints the launches a call that each window recorded: how many windows
fell short of one, and which. Run each form in a fresh process:

    python -m multimodal_neuroimage_tpu_torch.bench.profiler_windows \\
        bare|single|padded|cycle|split [windows]

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def _window(fn, calls: int, pad: float) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return sum(e.count for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0.0)) / calls


def _cycle(fn) -> float:
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    cycles = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: cycles.append(
                     p.key_averages())) as prof:
        for _ in range(2):
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(e.count for e in cycles[-1]
               if getattr(e, "self_device_time_total", 0.0)) / 10


def _split(fn) -> float:
    from multimodal_neuroimage_tpu_torch.bench.k1_split import launch_split
    return sum(n for n, _ in launch_split(fn).values())


def main(argv) -> int:
    from multimodal_neuroimage_tpu_torch.bench.k1_split import WINDOW_PAD_S
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    form = argv[0]
    windows = int(argv[1]) if len(argv) > 1 else 30
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator().manual_seed(4)
    shape = (4, 4, 3, 36, 4)
    q, k, v, g = (torch.randn(*shape, generator=gen).cuda() for _ in "qkvg")
    bias = torch.randn(3, 36, 36, generator=gen).cuda()
    out = att.fused_window_attention(q, k, v, bias)

    def call():
        return att.window_attention_backward(g, q, k, v, bias, None, out)

    window = {"bare": lambda f: _window(f, 10, 0.0),
              "single": lambda f: _window(f, 1, 0.0),
              "padded": lambda f: _window(f, 1, WINDOW_PAD_S),
              "cycle": _cycle, "split": _split}[form]
    t0 = time.perf_counter()
    got = [window(call) for _ in range(windows)]
    short = [(i, n) for i, n in enumerate(got) if n < 1.0]
    print(f"{form}: {windows} windows in {time.perf_counter() - t0:.1f} s, "
          f"{len(short)} short of one launch a call (window, launches): "
          f"{short[:20]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
