"""Minimal NIfTI-1 reader and writer (the port's own copy of
multimodal_neuroimage_tpu/data/nifti.py; the reference reads the 4-D fMRI
volumes with nibabel, reference datasets.py:130-169).

Supports the subset the ``fMRI_image`` dataset needs: single-file ``.nii``
/ ``.nii.gz``, NIfTI-1 headers in either byte order, the common dtypes,
data in the standard Fortran-order layout, and optional scl_slope /
scl_inter scaling. ``read_nifti`` returns the data as nibabel's
``get_fdata`` does: float64, shape per ``dim``.
"""

from __future__ import annotations

import gzip
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def read_nifti_header(path: str) -> Tuple[int, ...]:
    """Peek a NIfTI-1 file's logical shape without reading the data (used
    by the native batch loader to size its output buffer)."""
    with _open(path) as f:
        header = f.read(348)
    if len(header) < 348:
        raise ValueError(f"{path}: truncated NIfTI header")
    byteorder = "<"
    if struct.unpack("<i", header[:4])[0] != 348:
        if struct.unpack(">i", header[:4])[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        byteorder = ">"
    dim = struct.unpack(byteorder + "8h", header[40:56])
    return tuple(int(d) for d in dim[1:1 + dim[0]])


def read_nifti(path: str) -> np.ndarray:
    """Load a NIfTI-1 volume as float64 (nibabel ``get_fdata`` semantics)."""
    with _open(path) as f:
        header = f.read(348)
        if len(header) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", header[:4])[0]
        byteorder = "<"
        if sizeof_hdr != 348:
            sizeof_hdr = struct.unpack(">i", header[:4])[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            byteorder = ">"
        magic = header[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack(byteorder + "8h", header[40:56])
        ndim = dim[0]
        shape = tuple(int(d) for d in dim[1:1 + ndim])
        datatype = struct.unpack(byteorder + "h", header[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(byteorder)
        scl_slope = struct.unpack(byteorder + "f", header[112:116])[0]
        scl_inter = struct.unpack(byteorder + "f", header[116:120])[0]
        vox_offset = struct.unpack(byteorder + "f", header[108:112])[0]

        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        raw = f.read(count * dtype.itemsize)
        data = np.frombuffer(raw, dtype=dtype, count=count)
    data = data.reshape(shape, order="F").astype(np.float64)
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    return data


def write_nifti(path: str, data: np.ndarray) -> None:
    """Write a float32 NIfTI-1 single file (testing/synthetic support)."""
    data = np.asarray(data, dtype=np.float32)
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", header, 40, *dim)
    struct.pack_into("<h", header, 70, 16)        # float32
    struct.pack_into("<h", header, 72, 32)        # bitpix
    struct.pack_into("<f", header, 108, 352.0)    # vox_offset
    struct.pack_into("<f", header, 112, 1.0)      # scl_slope
    struct.pack_into("<8f", header, 76, 0, *([1.0] * 7))  # pixdim
    header[344:348] = b"n+1\x00"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(bytes(header))
        f.write(np.asfortranarray(data).tobytes(order="F"))
