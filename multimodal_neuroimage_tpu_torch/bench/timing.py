"""CUDA timers shared by ``chip_smoke.py`` and the benchmarks of this
package: a call time (CUDA events around back-to-back calls, the host's
enqueue included) and a device time (replays of a CUDA graph that captured
the calls, or ``torch.profiler``'s device self-time where capture fails).

It imports torch alone, so that ``kernel_ab.py`` can load it by its path and
time another checkout's package with the same code.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

WARMUP = 3


def events_ms(fn: Callable, iters: int = 20, windows: int = 1) -> float:
    """ms per call of ``iters`` back-to-back calls after ``WARMUP`` calls,
    timed with CUDA events; the least over ``windows`` windows."""
    for _ in range(WARMUP):
        fn()
    best = float("inf")
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def kernel_us(fn: Callable, iters: int = 20) -> Dict[str, float]:
    """{kernel name: device self-time per call, us} of ``iters`` calls,
    from ``torch.profiler``, its window held open as
    ``bench/k1_split.launch_split`` holds it (its docstring says why)."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_neuroimage_tpu_torch.bench.k1_split import WINDOW_PAD_S
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    times = ((e.key, getattr(e, "self_device_time_total", 0.0))
             for e in prof.key_averages())
    return {key: us / iters for key, us in times if us}


def graph_ms(fn: Callable, iters: int = 20,
             stream=None) -> Tuple[float, str]:
    """Device time of one call, without the host's enqueue: one replay of a
    CUDA graph that captured ``iters`` calls (mean of 5 replays, timed with
    events) over ``iters``; where capture fails, the profiler's device
    self-time of the kernels of ``iters`` calls over ``iters``. ``stream``:
    the side stream the caller built ``fn``'s autograd graph on, so that its
    backward is captured there. Returns (ms, "graph" or "profiler")."""
    s = stream or torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            for _ in range(iters):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (5 * iters), "graph"
    except RuntimeError as exc:
        print(f"  (graph capture failed: {exc}; timing with the profiler)")
        torch.cuda.synchronize()
    return sum(kernel_us(fn, iters).values()) / 1e3, "profiler"
