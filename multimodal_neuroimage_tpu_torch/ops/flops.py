"""The products each kernel does, by formula, and the hook through which a
count of a step's work (obs/profiling.py) sees a kernel.

A kernel's count is the product count of its plain version at the same
shapes: 2 * M * N * K a product, batch dimensions multiplied in, as JAX's
census counts a ``dot_general`` (multimodal_neuroimage_tpu/obs/
profiling.py ``_dot_flops``). The backward's count is that of the VJP of
the plain forward, the products that autograd runs for every gradient the
kernel returns. Nothing of a kernel's own arithmetic enters it: the
3xTF32 splits, bf16 hi + lo halves, head dims padded to 16, scores
recomputed in a backward and tiles computed twice all count zero, and so
does the plain backward's recompute of its forward on the CPU. The count of
one call is therefore the same on the CPU and on the card, at float32 and
at bf16, on the std and the bp fusion layout, whatever implements the
kernel. tests/test_torch_flops.py holds every formula against the census
of the plain version's forward and of its forward and backward.

Each wrapper runs its kernel, or its plain version, inside
:func:`kernel` with its formula's count; a census that counts kernels by
formula adds the count and skips the products inside (the plain version's
on the CPU), and every other census lets them through.
"""

from __future__ import annotations

import contextlib
from typing import List

# the censuses running now, innermost last (obs/profiling.py); a module
# list, not a thread-local one: autograd runs a CUDA backward on a thread of
# its own
CENSUSES: List[object] = []


@contextlib.contextmanager
def kernel(name: str, flops: int):
    """Around one call of kernel ``name`` (its launch or its plain
    version), whose formula gives ``flops`` products."""
    census = CENSUSES[-1] if CENSUSES else None
    if census is None or not census.formulas:
        yield
        return
    census.add_kernel(name, int(flops))
    census.depth += 1
    try:
        yield
    finally:
        census.depth -= 1


# ---- the formulas: forward, and backward = 2 x forward where every operand of
# every product takes a gradient -------------------------------------------------

def bert_layer(B: int, T: int, H: int, F: int, backward: bool = False) -> int:
    """K1, either form (float32, mm16): q, k, v, Wo, the FFN's two products
    over B * T rows, the scores and the context over T keys (the masked
    keys included, as the plain version computes them)."""
    fwd = 2 * B * T * H * (4 * H + 2 * F) + 4 * B * T * T * H
    return 2 * fwd if backward else fwd


def fusion_block(B: int, nW: int, N: int, C: int, Ch: int,
                 backward: bool = False) -> int:
    """K2 (self) and K3 (cross) on (B, nW, N, C) windows, and K7 on the same
    subjects group-major: q, k, v (from x, or q from x and k, v from y),
    the projection, fc1 and fc2 (hidden width Ch) over B * nW * N rows, the
    scores and the context over N keys."""
    R = B * nW * N
    fwd = 2 * R * C * (4 * C + 2 * Ch) + 4 * R * N * C
    return 2 * fwd if backward else fwd


def attention(B: int, heads: int, T: int, S: int, D: int,
              backward: bool = False) -> int:
    """K4 (B * nW windows, T = S = N) and K6 (T = S): scores and context,
    D a head."""
    fwd = 4 * B * heads * T * S * D
    return 2 * fwd if backward else fwd


def batched_matmul(batch: int, M: int, N: int, K: int) -> int:
    """K8: one batched product (no backward)."""
    return 2 * batch * M * N * K
