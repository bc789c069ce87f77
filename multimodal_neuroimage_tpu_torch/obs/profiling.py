"""Trace annotations, a profiler trace of a run, and the analytic operation
counts (counterpart of multimodal_neuroimage_tpu/obs/profiling.py).

  * ``trace_annotation(name)``: ``torch.profiler.record_function`` (a
    named range in a profiler trace) plus an NVTX range on a CUDA device,
    the reference's range_push / range_pop (trainer.py:373-377);
  * ``profile_trace(dir)``: ``torch.profiler.profile`` over the CPU and,
    where there is one, the CUDA device around a region, its Chrome trace
    written into ``dir`` (the reference's ``--profiling`` under Nsight,
    main.py:98);
  * the analytic operation counts of the attention stacks (the reference's
    per-module ``flops()``, swin_v2_module.py:184-195, 310-322,
    model.py:1540-1555), exactly as the JAX package counts them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from multimodal_neuroimage_tpu_torch.parallel.mesh import rank


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in a profiler trace, and on a CUDA device in NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: str = "cuda"):
    """Profile the enclosed region (CPU activity, and CUDA activity when
    ``device`` is a CUDA device) and write its Chrome trace,
    ``trace_rank<r>_<pid>_<ns>.json`` (r this process's rank,
    parallel/mesh.py), into ``log_dir``, also when the region
    raises; a no-op when ``log_dir`` is empty. The trace's kernel events name every kernel that ran."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        # written when the region raises too: a failing run's trace is the
        # one most worth reading
        path = os.path.join(
            log_dir, f"trace_rank{rank()}_{os.getpid()}_{time.time_ns()}"
                     f".json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")


# ---------------------------------------------------------------------------
# Analytic cost model
# ---------------------------------------------------------------------------

def attention_flops(tokens: int, dim: int, heads: int) -> int:
    """One MHSA block: qkv + scores + context + out proj
    (swin_v2_module.py:184-195 structure)."""
    head_dim = dim // heads
    return (tokens * dim * 3 * dim            # qkv
            + heads * tokens * head_dim * tokens  # q @ k^T
            + heads * tokens * tokens * head_dim  # attn @ v
            + tokens * dim * dim)             # out proj


def mlp_flops(tokens: int, dim: int, mlp_ratio: float = 4.0) -> int:
    return int(2 * tokens * dim * dim * mlp_ratio)


def swin_block_flops(h: int, w: int, dim: int, heads: int, window: int,
                     mlp_ratio: float = 4.0) -> int:
    """One Swin block (swin_v2_module.py:310-322)."""
    n_windows = (h * w) // (window * window)
    return (n_windows * attention_flops(window * window, dim, heads)
            + mlp_flops(h * w, dim, mlp_ratio)
            + 2 * dim * h * w)                # norms


def swin_encoder_flops(img: int = 84, patch: int = 7, embed_dim: int = 12,
                       depths=(2, 2, 6), heads=(3, 6, 12), window: int = 6,
                       mlp_ratio: float = 4.0) -> int:
    """Full SwinV2 classifier cost (model.py:1540-1555 shape)."""
    res = img // patch
    total = img * img * embed_dim * patch * patch  # patch embed conv
    for i, (d, h) in enumerate(zip(depths, heads)):
        dim = embed_dim * 2 ** i
        r = res // 2 ** i
        total += d * swin_block_flops(r, r, dim, h, window, mlp_ratio)
        if i < len(depths) - 1:
            total += (r // 2) ** 2 * 4 * dim * 2 * dim  # patch merging
    return total


def bert_flops(seq: int, hidden: int, layers: int,
               intermediate: int = 3072) -> int:
    per_layer = (attention_flops(seq, hidden, 1)
                 + 2 * seq * hidden * intermediate)
    return layers * per_layer
