"""The native host gear (``preprocess="native"``): ctypes bindings for the
repository's C++ batch loader ``native/fastpipe.cpp`` (counterpart of
multimodal_neuroimage_tpu/data/native.py, over the same source).

The first call builds ``fastpipe.cpp`` with the JAX package's flags (``g++
-O3 -march=native -shared -fPIC -std=c++17 -pthread ... -lz``) into
``multimodal_neuroimage_tpu_torch/_build/`` (git-ignored) under a name
keyed by a hash of the source, and loads it. There is no fallback: when the
library cannot be built or loaded, ``library()`` raises with the
compiler's or the loader's message, and so does every batch asked of the
gear. The entry points take whole batches: parallel ``.npy`` parsing, the
FIR band split, z-scoring and padding in C++ threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "fastpipe.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]

_LOCK = threading.Lock()
_LIB = None

_P64 = ctypes.POINTER(ctypes.c_int64)
_PF = ctypes.POINTER(ctypes.c_float)
# (restype, argtypes) of the entry points this gear calls
_SIGNATURES = {
    "fastpipe_bandsplit_batch": (ctypes.c_int, [
        ctypes.c_char_p, _P64, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PF, _PF,
        _PF, ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]),
    "fastpipe_matrix_batch": (ctypes.c_int, [
        ctypes.c_char_p, _P64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PF,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int]),
}


def build(source: Path, out_dir: Path) -> Path:
    """Compile ``source`` into a shared library in ``out_dir`` (reused when
    one of the same source is there); raises RuntimeError with the
    compiler's message when it fails."""
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    out = Path(out_dir) / f"libfastpipe_{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(source), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"preprocess='native': building {source} failed: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"preprocess='native': {' '.join(cmd)} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build(SOURCE, BUILD_DIR)))
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _LIB = lib
        return _LIB


def _pack_paths(paths: List[str]) -> Tuple[bytes, np.ndarray]:
    blobs = [p.encode() + b"\0" for p in paths]
    offsets = np.zeros(len(paths) + 1, dtype=np.int64)
    offsets[1:] = np.cumsum([len(b) for b in blobs])
    return b"".join(blobs), offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bandsplit_batch(paths: List[str], taps: np.ndarray, *, skip_tr: int = 20,
                    t_max: int = 368, n_rois: int = 84, nthreads: int = 0
                    ) -> Dict[str, np.ndarray]:
    """Parallel ``.npy`` load, FIR band split, per-ROI z-score and padding
    of a batch of ABCD series: ``raw``, ``low`` and ``ultralow`` as (n,
    t_max, n_rois) float32, and the native ``lengths``."""
    lib = library()
    n = len(paths)
    blob, offsets = _pack_paths(paths)
    taps = np.ascontiguousarray(taps, dtype=np.float64)
    out = {k: np.empty((n, t_max, n_rois), np.float32)
           for k in ("raw", "low", "ultralow")}
    lengths = np.empty((n,), np.int32)
    err = ctypes.create_string_buffer(512)
    rc = lib.fastpipe_bandsplit_batch(
        blob, _ptr(offsets, ctypes.c_int64), n, _ptr(taps, ctypes.c_double),
        len(taps), skip_tr, t_max, n_rois, _ptr(out["raw"], ctypes.c_float),
        _ptr(out["low"], ctypes.c_float),
        _ptr(out["ultralow"], ctypes.c_float), _ptr(lengths, ctypes.c_int32),
        nthreads, err, len(err))
    if rc != 0:
        raise RuntimeError(f"fastpipe_bandsplit_batch: {err.value.decode()}")
    out["lengths"] = lengths
    return out


def matrix_batch(paths: List[str], rows: int = 84, cols: int = 84,
                 nthreads: int = 0) -> np.ndarray:
    """Parallel ``.npy`` load and global z-score of (rows, cols) matrices,
    as (n, rows, cols) float32."""
    lib = library()
    n = len(paths)
    blob, offsets = _pack_paths(paths)
    out = np.empty((n, rows, cols), np.float32)
    err = ctypes.create_string_buffer(512)
    rc = lib.fastpipe_matrix_batch(
        blob, _ptr(offsets, ctypes.c_int64), n, rows, cols,
        _ptr(out, ctypes.c_float), nthreads, err, len(err))
    if rc != 0:
        raise RuntimeError(f"fastpipe_matrix_batch: {err.value.decode()}")
    return out
