"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface for Hopper (``sm_90a``); ``ctypes`` loads it. The library lands in
``multimodal_neuroimage_tpu_torch/_build/`` (git-ignored) under a name keyed
by a hash of the sources, so an edited kernel is rebuilt and an unchanged
one is loaded as is. Nothing here runs at import time: the first wrapper
call on a CUDA tensor builds, which is why the CPU tests can import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
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
# (restype, argtypes) of every exported function; pointers and the stream
# are void*. Launchers return a cudaError_t (0 = success).
_SIGNATURES = {
    "window_attention_forward": (_I, [_P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P]),
    "fusion_block_forward": (_I, [_I, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _P]),
    "bert_layer_forward": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P]),
    "bert_layer_scratch_floats": (ctypes.c_longlong, [_I, _I, _I, _I]),
    "kernels_error_string": (ctypes.c_char_p, [_I]),
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self._lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self._lib, name)
            fn.restype, fn.argtypes = restype, argtypes

    def value(self, name: str, *args):
        """Call a query function (no launch) and return its result."""
        return getattr(self._lib, name)(*args)

    def call(self, name: str, *args) -> None:
        """Launch through entry point ``name``; raise on a CUDA error."""
        err = getattr(self._lib, name)(*args)
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
    Returns (path, seconds spent compiling, compiler output)."""
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ([_nvcc()] + ARCH_FLAGS
           + ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-I", str(SOURCE_DIR), "-o", str(tmp)]
           + [str(f) for f in cu])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds, proc.stdout + proc.stderr


def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    global _LIBRARY
    if _LIBRARY is None:
        path, seconds, log = build()
        _LIBRARY = KernelLibrary(path, seconds, log)
    return _LIBRARY


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_f32(name: str, t: torch.Tensor, shape=None) -> None:
    """Wrapper-side validation before a pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def pointer_array(tensors) -> ctypes.Array:
    """Host array of device pointers (the kernels' parameter lists)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
