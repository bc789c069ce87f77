"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source for Hopper (``sm_90a``), one process a
source, all at once, and links them into one shared library with a plain C
interface; ``ctypes`` loads it. The library lands in
``multimodal_neuroimage_tpu_torch/_build/`` (git-ignored) under a name keyed
by a hash of the sources, so an edited kernel is rebuilt and an unchanged
one is loaded as is. Nothing here runs at import time: the first wrapper
call on a CUDA tensor builds, which is why the CPU tests can import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float
_L = ctypes.c_longlong
# (restype, argtypes) of every exported function; pointers and the stream
# are void*. Launchers return a cudaError_t (0 = success).
_SIGNATURES = {
    "window_attention_forward": (_I, [_P] * 6 + [_I] * 6 + [_D, _P]),
    "window_attention_backward": (_I, [_P] * 13 + [_I] * 6 + [_D, _P]),
    "window_attention_backward_scratch_floats": (_L, [_I] * 4),
    "window_attention_backward_counters": (_L, [_I] * 3),
    "fusion_block_forward": (_I, [_I] + [_P] * 6 + [_I] * 6
                             + [_P, _I, _D, _D, _I, _P, _P]),
    "fusion_block_backward": (_I, [_I] + [_P] * 11 + [_I] * 6
                              + [_P, _I, _D, _D, _I, _P]),
    "fusion_block_grad_floats": (_L, [_I] * 5),
    "fusion_block_backward_scratch_floats": (_L, [_I] * 7),
    "fusion_block_bp_forward": (_I, [_I] + [_P] * 6 + [_I] * 7
                                + [_P, _I, _D, _D, _I, _P, _P]),
    "fusion_block_bp_backward": (_I, [_I] + [_P] * 11 + [_I] * 7
                                 + [_P, _I, _D, _D, _I, _P]),
    "fusion_block_bp_backward_scratch_floats": (_L, [_I] * 8),
    "fusion_block_bp_forward16": (_I, [_I] + [_P] * 6 + [_I] * 7
                                  + [_P, _I, _D, _D, _I, _P, _P]),
    "fusion_block_bp_backward16": (_I, [_I] + [_P] * 11 + [_I] * 7
                                   + [_P, _I, _D, _D, _I, _P]),
    "fusion_block_bp_backward16_scratch_floats": (_L, [_I] * 8),
    "fusion_block_bp_backward16_occupancy": (_I, [_I] * 8 + [_P]),
    "fusion_block_backward_occupancy": (_I, [_I] * 7 + [_P]),
    "fusion_block_bp_backward_occupancy": (_I, [_I] * 8 + [_P]),
    "fusion_block_forward_occupancy": (_I, [_I] * 7 + [_P]),
    "bert_layer_forward": (_I, [_P] * 5 + [_I] * 8 + [_D, _D, _P]),
    "bert_layer_forward_simt": (_I, [_P] * 5 + [_I] * 8 + [_D, _D, _P]),
    "bert_layer_scratch_floats": (_L, [_I] * 4),
    "bert_layer_scratch_simt_floats": (_L, [_I] * 4),
    "bert_layer_resid_floats": (_L, [_I] * 4),
    "bert_layer_backward": (_I, [_P] * 7 + [_I] * 8 + [_D, _D, _I, _P]),
    "bert_layer_backward_scratch_floats": (_L, [_I] * 5),
    "bert_layer_forward16": (_I, [_P] * 5 + [_I] * 8 + [_D, _D, _P]),
    "bert_layer_scratch16_floats": (_L, [_I] * 5),
    "bert_layer_backward16": (_I, [_P] * 7 + [_I] * 8 + [_D, _D, _P]),
    "bert_layer_backward16_scratch_floats": (_L, [_I] * 5),
    "fused_adam_update": (_I, [_P] * 4 + [_L, _P, _F, _F, _F, _D, _D, _D,
                                          _D, _I, _P]),
    "mha_forward": (_I, [_P] * 5 + [_I] * 4 + [_D, _P]),
    "mha_backward": (_I, [_P] * 10 + [_I] * 4 + [_D, _P]),
    "mha_forward_simt": (_I, [_P] * 5 + [_I] * 4 + [_D, _P]),
    "mha_backward_simt": (_I, [_P] * 10 + [_I] * 4 + [_D, _P]),
    "mha_forward16": (_I, [_P] * 6 + [_I] * 4 + [_D, _P]),
    "mha_backward16": (_I, [_P] * 10 + [_I] * 4 + [_D, _P]),
    "mha_forward16_simt": (_I, [_P] * 6 + [_I] * 4 + [_D, _P]),
    "mha_backward16_simt": (_I, [_P] * 10 + [_I] * 4 + [_D, _P]),
    "batched_matmul": (_I, [_P] * 4 + [_I] * 5 + [_L] * 4
                       + [_F, _F, _I, _I, _I, _P]),
    "kernels_error_string": (ctypes.c_char_p, [_I]),
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        self._fns = {}
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = self._fns[name] = getattr(self._lib, name)
            fn.restype, fn.argtypes = restype, argtypes

    def value(self, name: str, *args):
        """Call a query function (no launch) and return its result."""
        return self._fns[name](*args)

    def call(self, name: str, *args) -> None:
        """Launch through entry point ``name``; raise on a CUDA error. A
        tensor argument passes as its data pointer, and the first one's
        device is made current for the launch: ``stream_of`` gives that
        device's stream, and a kernel launched while another device is
        current would run there (a rank's ``cuda:1``, ``--device
        cuda:1``)."""
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        if (dev is not None and dev.type == "cuda"
                and dev.index != torch.cuda.current_device()):
            with torch.cuda.device(dev):
                err = self._fns[name](*args)
        else:
            err = self._fns[name](*args)
        if err != 0:
            msg = self._lib.kernels_error_string(err).decode()
            raise RuntimeError(f"{name} failed: cudaError {err} ({msg})")


_LIBRARY: Optional[KernelLibrary] = None


def _sources():
    return sorted(SOURCE_DIR.glob("*.cu")), sorted(SOURCE_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the port's CUDA kernels cannot be built")


def build() -> tuple:
    """Compile the sources if no library for their hash exists yet.
    Returns (path, seconds spent compiling, compiler output).

    An exclusive ``fcntl`` lock on ``_build/build.lock`` makes the ranks of
    one machine build once: the first compiles, the others wait and then
    load its library. The kernel releases the lock when its holder exits,
    so a build that was killed leaves no lock behind."""
    cu, cuh = _sources()
    digest = hashlib.sha256()
    for f in cu + cuh:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(ARCH_FLAGS).encode())
    out = BUILD_DIR / f"libmnt_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():             # another process built it
                return out, 0.0, ""
            return _compile(cu, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile(cu, out: Path) -> tuple:
    """nvcc every source at once and link ``out`` (``build``)."""
    nvcc = _nvcc()
    stem = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    # one nvcc per source, all running at once (each writes its output to
    # its own log file, so no pipe can fill while another is waited on)
    jobs = []
    for f in cu:
        obj = BUILD_DIR / f"{stem}.{f.stem}.o"
        log = BUILD_DIR / f"{stem}.{f.stem}.log"
        cmd = ([nvcc] + ARCH_FLAGS
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                  "-I", str(SOURCE_DIR), "-c", str(f), "-o", str(obj)])
        with open(log, "w") as fh:
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=fh, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, obj, log, proc in jobs:
        proc.wait()
        logs.append(log.read_text())
        log.unlink()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{logs[-1]}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = ([nvcc] + ARCH_FLAGS + ["-shared", "-o", str(tmp)]
               + [str(obj) for _, obj, _, _ in jobs])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for _, obj, _, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)
    return out, seconds, "".join(logs)


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is None:
        path, seconds, log = build()
        _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY


# the current stream's raw handle without building a torch.cuda.Stream
# object, where PyTorch (a CUDA build) offers it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream",
                      lambda index: torch.cuda.current_stream(index).cuda_stream)


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return _RAW_STREAM(t.get_device())


def check_cuda_f32(name: str, t: torch.Tensor, shape=None) -> None:
    """Wrapper-side validation before a pointer goes to a kernel: one test
    a tensor when it passes, the reason when it does not."""
    if (t.is_cuda and t.dtype is torch.float32 and t.is_contiguous()
            and (shape is None or t.shape == shape)):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape=None) -> None:
    """check_cuda_f32 for a kernel argument of any dtype (the bf16 streams
    of the bf16 policy's kernels)."""
    if (t.is_cuda and t.dtype is dtype and t.is_contiguous()
            and (shape is None or t.shape == shape)):
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                     f"got {tuple(t.shape)}")


def pointer_array(tensors) -> ctypes.Array:
    """Host array of device pointers (the kernels' parameter lists)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
