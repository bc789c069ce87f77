"""Where K2/K3's forward spends its cycles, phase by phase, on one CUDA card.

    python -m multimodal_neuroimage_tpu_torch.bench.fusion_probe [--batch B]...
        [ROOT ...]

For each repository root (default: this checkout), the script compiles
that root's ``csrc/fusion_block.cu`` with a ``clock64`` probe at the
forward's barriers into a library of its own (under this checkout's
``_build/``; the builds run side by side),
runs the training forward (dropout 0.1, DropPath, x2r saved) of the self
and the cross block at the flagship's shapes ((B, 196, 36, 12), 6 heads,
shift 3) through this checkout's ``ops/fusion_block.py``, and prints the
cycles thread 0 of every block saw between consecutive barriers, summed
over blocks, and each phase's share. A phase ends at a barrier, so its
cycles include the wait for the block's slowest warp.

The forward's source marks its barriers with ``FUSION_FWD_MARK(i)``
(empty unless the probe defines it). A source without the marks (the
one-window forward that ``fusion_forward_window`` ran before the
multi-window one, the baseline that PERF.md's per-phase split compares
with) is marked here: its i-th ``__syncthreads()`` becomes mark i, and
mark 0 goes before its first staging.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import torch

from multimodal_neuroimage_tpu_torch.ops import build

PHASES = 16
NAMES = {1: "wait / stage x", 2: "LN1", 3: "q k v", 4: "attention",
         5: "proj", 6: "LN2", 7: "fc1 + GELU", 8: "fc2"}

_PROBE = r"""
#define FUSION_PROBE_PHASES %d
__device__ unsigned long long fusion_probe_cycles[FUSION_PROBE_PHASES];
__device__ unsigned long long fusion_probe_counts[FUSION_PROBE_PHASES];
__device__ __forceinline__ void fusion_probe_mark(int i) {
  __shared__ long long fusion_probe_prev;
  if (threadIdx.x == 0) {
    const long long t = clock64();
    if (i > 0) {
      atomicAdd(&fusion_probe_cycles[i], (unsigned long long)(t - fusion_probe_prev));
      atomicAdd(&fusion_probe_counts[i], 1ull);
    }
    fusion_probe_prev = t;
  }
}
#define FUSION_FWD_MARK(i) fusion_probe_mark(i)
#define FUSION_FWD_MARK_SYNC(i) \
  do {                          \
    __syncthreads();            \
    fusion_probe_mark(i);       \
  } while (0)
""" % PHASES

_READ = r"""
extern "C" int fusion_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, fusion_probe_cycles, sizeof(fusion_probe_cycles));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(out + FUSION_PROBE_PHASES, fusion_probe_counts,
                                   sizeof(fusion_probe_counts));
}
extern "C" int fusion_probe_reset() {
  static const unsigned long long zero[FUSION_PROBE_PHASES] = {0};
  cudaError_t e = cudaMemcpyToSymbol(fusion_probe_cycles, zero, sizeof(zero));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyToSymbol(fusion_probe_counts, zero, sizeof(zero));
}
"""


def _mark_old_forward(src: str) -> str:
    """Marks in the one-window forward body (``fusion_forward_window``)."""
    start = src.index("fusion_forward_window(float* smem")
    end = src.index("\n}\n", start)
    body = src[start:end]
    body = body.replace("  stage_rows(xs,", "  FUSION_FWD_MARK(0);\n  stage_rows(xs,", 1)
    count = iter(range(1, PHASES))
    body = re.sub(r"__syncthreads\(\);",
                  lambda _: f"__syncthreads(); FUSION_FWD_MARK({next(count)});",
                  body)
    return src[:start] + body + src[end:]


class _ProbeLibrary:
    """The probe build of one root's fusion_block.cu, called as
    ``build.library()``'s KernelLibrary is (only the entries it has)."""

    def __init__(self, path: Path):
        self._lib = ctypes.CDLL(str(path))

    def _fn(self, name):
        fn = getattr(self._lib, name)
        if name in build._SIGNATURES:
            fn.restype, fn.argtypes = build._SIGNATURES[name]
        return fn

    def value(self, name, *args):
        return self._fn(name)(*args)

    def call(self, name, *args):
        err = self._fn(name)(*args)
        if err:
            raise RuntimeError(f"{name} failed: cudaError {err}")

    def cycles(self):
        out = (ctypes.c_ulonglong * (2 * PHASES))()
        if self._lib.fusion_probe_read(out):
            raise RuntimeError("fusion_probe_read failed")
        return list(out[:PHASES]), list(out[PHASES:])

    def reset(self):
        if self._lib.fusion_probe_reset():
            raise RuntimeError("fusion_probe_reset failed")


def start_build(root: Path):
    """Start nvcc on the probe build of ``root``; returns (library path,
    process or None)."""
    csrc = root / "multimodal_neuroimage_tpu_torch" / "csrc"
    files = {n: (csrc / n).read_text()
             for n in ("common.cuh", "fusion_block.cuh", "fusion_block.cu")}
    if "FUSION_FWD_MARK" not in files["fusion_block.cuh"]:
        files["fusion_block.cuh"] = _mark_old_forward(files["fusion_block.cuh"])
    files["fusion_block.cu"] = _PROBE + files["fusion_block.cu"] + _READ
    digest = hashlib.sha1("".join(files.values()).encode()).hexdigest()[:12]
    out = build.BUILD_DIR / f"probe_{digest}"
    lib = out / "libfusion_probe.so"
    if lib.exists():
        return lib, None
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for name, text in files.items():
        (out / name).write_text(text)
    cmd = ([build._nvcc()] + build.ARCH_FLAGS
           + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-shared", "-o", str(lib), str(out / "fusion_block.cu")])
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_build(lib: Path, proc) -> _ProbeLibrary:
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + log[-4000:])
    return _ProbeLibrary(lib)


def _inputs(B: int, cross: bool, gen):
    C, H, N, nW, Ch = 12, 6, 36, 196, 48

    def lin(o, i):
        return [torch.randn(o, i, generator=gen) * i ** -0.5,
                0.1 * torch.randn(o, generator=gen)]

    def ln(c):
        return [1 + 0.1 * torch.randn(c, generator=gen),
                0.1 * torch.randn(c, generator=gen)]
    qkv = ln(C) + lin(C, C) + lin(2 * C, C) if cross else lin(3 * C, C)
    params = tuple(t.cuda() for t in ln(C) + qkv + lin(C, C) + ln(C)
                   + lin(Ch, C) + lin(C, Ch))
    x, y = (torch.randn(B, nW, N, C, generator=gen).cuda() for _ in "xy")
    bias = (0.5 * torch.randn(H, N, N, generator=gen)).cuda()
    dp = ((torch.rand(B, 2, generator=gen) > 0.1).float() / 0.9).cuda()
    return params, x, y, bias, dp


def probe(lib: _ProbeLibrary, label: str, B: int) -> None:
    from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    mask = torch.from_numpy(shift_attn_mask(84, 84, 6, 3)).cuda()
    gen = torch.Generator().manual_seed(3)
    saved = build.library
    build.library = lambda: lib
    try:
        for cross in (False, True):
            params, x, y, bias, dp = _inputs(B, cross, gen)

            def call():
                return fb._launch_forward(x, y if cross else None, params,
                                          bias, mask, dp, 2468, (0.1, 0.1),
                                          True, True, cross)
            call()
            torch.cuda.synchronize()
            lib.reset()
            iters = 10
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                call()
            end.record()
            torch.cuda.synchronize()
            cycles, counts = lib.cycles()
            total = sum(cycles)
            print(f"{label} K{3 if cross else 2} training forward, B {B}: "
                  f"{start.elapsed_time(end) / iters:.4f} ms a call with the "
                  f"probe; {total / iters:.0f} block-cycles a call; "
                  f"{counts[2] // iters} block-items a call")
            for i in range(1, PHASES):
                if counts[i]:
                    print(f"  phase {i} ({NAMES.get(i, '?')}): "
                          f"{cycles[i] / total:.3f} of the cycles, "
                          f"{cycles[i] / counts[i]:.0f} cycles a block-item")
    finally:
        build.library = saved


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, action="append", default=None)
    parser.add_argument("roots", nargs="*")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fusion_probe: needs a CUDA card")
        return 2
    here = Path(__file__).resolve().parents[2]
    roots = [Path(root).resolve() for root in args.roots or [str(here)]]
    builds = [start_build(root) for root in roots]
    for root, (path, proc) in zip(roots, builds):
        lib = finish_build(path, proc)
        for B in args.batch or [16]:
            probe(lib, str(root), B)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
