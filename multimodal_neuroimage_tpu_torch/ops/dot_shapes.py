"""K8: the dot-shape micro-benchmark's batched product and its chains.

Counterpart of scripts/bench_dot_shapes.py (``_mk``: the Pallas kernel that
chains ``reps`` scores + context batched products of the fusion window
attention, in five formulations at the flagship's G = 8 geometry). The CUDA
kernel is one batched product, ``C[b] = alpha * A[b] B[b]`` with float32
accumulation (``csrc/dot_shapes.cu``); a chain of ``reps`` pairs is
``2 * reps`` launches of it, the context product's left operand scaled by
1e-3 (the script's ``S * 1e-3``). bf16 operands are rounded once, as the
script's ``cast`` does, after that scale. The JAX kernel ran the chain in
every one of its ``NCH`` grid cells on block 0 of each input; here the
cells are an outer batch level whose inputs broadcast (batch stride 0).

:func:`batched_matmul` launches the kernel on CUDA tensors (or raises) and
runs its plain version on CPU tensors; :func:`dot_chain` is the chain
through it and :func:`dot_chain_reference` the same chain in
``torch.einsum`` (the plain version). :func:`choose_config` picks the
kernel's block tile and split-K factor for a product's shape, and
:func:`k_slices` gives the k range of each split, as the kernel computes
them.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ops import build, flops

# the flagship geometry of the script (G = 8 lane group)
B, NW, NP, C, H = 8, 196, 40, 12, 6
BC = B * C            # 96
L = B * H * NP        # 1920
LS = H * NP           # 240 (subject-major lane axis)
WC = 28               # windows per cell
NCH = NW // WC        # 7 cells
FOLD = 4              # ffold: windows folded into rows
VARIANTS = ("cur", "sm", "st", "ffold", "flat")
SCALE = 1e-3          # the context product's left operand: S * 1e-3


def shapes(variant: str) -> List[Tuple[int, ...]]:
    """The three operand shapes of a variant (``_mk``'s table); the chain's
    output has the first one's shape."""
    table: Dict[str, List[Tuple[int, ...]]] = {
        "cur": [(WC, NP, BC), (WC, BC, L), (WC, L, BC)],
        "sm": [(WC, B * NP, BC), (WC, BC, LS), (WC, LS, BC)],
        "st": [(WC, L, BC), (WC, BC, NP), (WC, NP, BC)],
        "ffold": [(WC // FOLD, FOLD * NP, BC), (WC // FOLD, BC, FOLD * L),
                  (WC // FOLD, FOLD * L, BC)],
        "flat": [(WC * NP, BC), (BC, L), (L, BC)],
    }
    if variant not in table:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return table[variant]


def pair_flops(variant: str, cells: int = NCH) -> int:
    """Operations of one scores + context pair over ``cells`` cells (2 per
    multiply-add)."""
    a, b, c = shapes(variant)
    batch = int(np.prod(a[:-2]))
    M, K, N = a[-2], a[-1], b[-1]
    return cells * batch * 2 * (M * K * N + M * N * c[-1])


def inputs(variant: str, seed: int = 0, device=None) -> List[torch.Tensor]:
    """The script's operands: normal * 0.1 from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
            .to(device) for s in shapes(variant)]


def _round(t: torch.Tensor, bf16: bool) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32) if bf16 else t


# ---- the kernel's configurations --------------------------------------------------

# block tiles (BM, BN) of csrc/dot_shapes.cu, in its order
TILES = ((128, 128), (64, 128), (48, 128), (128, 48), (64, 96), (48, 96))
K_CHUNK = 32          # split-K granularity (DOT_KCHUNK)
SMS = 132             # streaming multiprocessors of an H100 SXM
SPLIT_BELOW = 4 * SMS  # split K while a product has fewer blocks than this
MIN_CHUNKS = 4        # ... keeping at least this many k chunks a split
MAX_BATCH = 65535     # the grid's z extent
# (tile, splits) that replaces choose_config's pick when set: a hook for
# tests and the per-product timing that reaches every configuration
_CONFIG: Optional[Tuple[int, int]] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def choose_config(M: int, N: int, K: int, batch: int) -> Tuple[int, int]:
    """(tile, splits) of K8 for a batch of (M, K) x (K, N) products: the
    tile whose padded output is least (then the larger tile, then the wider
    one), and split-K where the grid has fewer than ``SPLIT_BELOW`` blocks
    and K holds at least two splits of ``MIN_CHUNKS`` chunks. Cached: a
    chain asks for the same few shapes on every call."""
    if min(M, N, K, batch) < 1 or batch > MAX_BATCH:
        raise ValueError(f"no K8 configuration for M={M}, N={N}, K={K}, "
                         f"batch={batch} (each >= 1, batch <= {MAX_BATCH})")

    def cost(i):
        bm, bn = TILES[i]
        return (_cdiv(M, bm) * bm * _cdiv(N, bn) * bn, -bm * bn, -bn)
    tile = min(range(len(TILES)), key=cost)
    bm, bn = TILES[tile]
    blocks = _cdiv(M, bm) * _cdiv(N, bn) * batch
    chunks = _cdiv(K, K_CHUNK)
    splits = 1
    if blocks < SPLIT_BELOW and chunks >= 2 * MIN_CHUNKS:
        splits = min(_cdiv(SPLIT_BELOW, blocks), chunks // MIN_CHUNKS)
    return tile, splits


def k_slices(K: int, splits: int) -> List[Tuple[int, int]]:
    """[k0, k1) of each split, as the kernel cuts K: split s takes chunks
    [s * nc // splits, (s + 1) * nc // splits) of nc = ceil(K / K_CHUNK)."""
    nc = _cdiv(K, K_CHUNK)
    if not 1 <= splits <= nc:
        raise ValueError(f"splits must be in [1, {nc}] for K={K}, got "
                         f"{splits}")
    return [(s * nc // splits * K_CHUNK,
             min((s + 1) * nc // splits * K_CHUNK, K)) for s in range(splits)]


# ---- the kernel ----------------------------------------------------------------

def _batch_strides(t: torch.Tensor, name: str):
    """(outer, outer stride, inner, inner stride) of t's batch dims (up to
    two; a stride of 0 broadcasts); its last two dims must be row-major."""
    nd, shape, stride = t.dim(), t.shape, t.stride()
    if nd < 2 or nd > 4:
        raise ValueError(f"{name}: expected 2 to 4 dims, got {nd}")
    if stride[-1] != 1 or stride[-2] != shape[-1]:
        raise ValueError(f"{name}: the last two dims must be row-major")
    if nd == 4:
        return shape[0], stride[0], shape[1], stride[1]
    return (1, 0, shape[0], stride[0]) if nd == 3 else (1, 0, 1, 0)


def batched_matmul(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
                   bf16: bool = False) -> torch.Tensor:
    """(*batch, M, K) x (*batch, K, N) -> (*batch, M, N) float32 with every
    operand element ``alpha * a`` / ``b`` rounded to bf16 first when
    ``bf16``. On CUDA tensors the K8 kernel (batch dims may broadcast with
    stride 0, e.g. ``expand``) with the (tile, splits) of
    :func:`choose_config`; on CPU tensors the plain version."""
    if a.device.type == "cpu":
        _check_shapes(a, b)
        with flops.kernel("K8 dot_shapes", _flops(a, b)):
            return torch.matmul(_round(a * alpha, bf16), _round(b, bf16))
    return _launch(a, b, alpha, BF16 if bf16 else F32)


def _flops(a: torch.Tensor, b: torch.Tensor) -> int:
    return flops.batched_matmul(int(np.prod(a.shape[:-2], dtype=np.int64)),
                                a.shape[-2], b.shape[-1], a.shape[-1])


batched_matmul.launches = 0

# K8's modes: float32 throughout; every operand rounded to bf16 at load
# (after alpha); as BF16 with ``a`` in bfloat16, already scaled and rounded;
# as BF16 with the output stored as bfloat16(out_scale * C), in one split
F32, BF16, BF16_A, BF16_OUT = range(4)


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")


def _launch(a: torch.Tensor, b: torch.Tensor, alpha: float, mode: int,
            out_scale: float = 0.0) -> torch.Tensor:
    """One K8 launch in ``mode`` on CUDA tensors (or raise). ``BF16_A``
    takes ``a`` in bfloat16 and alpha 1; ``BF16_OUT`` returns bfloat16."""
    _check_shapes(a, b)
    a_dtype = torch.bfloat16 if mode == BF16_A else torch.float32
    for name, t, dtype in (("a", a, a_dtype), ("b", b, torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if mode == BF16_A and alpha != 1.0:
        raise ValueError("a bfloat16 a is taken as scaled: alpha must be 1")
    outer, sa0, inner, sa1 = _batch_strides(a, "a")
    _, sb0, _, sb1 = _batch_strides(b, "b")
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    # the kernel refuses a tile or a split count outside its domain
    tile, splits = _CONFIG or choose_config(M, N, K, outer * inner)
    if mode == BF16_OUT:
        splits = 1
    out = torch.empty(a.shape[:-2] + (M, N), device=a.device,
                      dtype=torch.bfloat16 if mode == BF16_OUT
                      else torch.float32)
    part = (torch.empty(splits * out.numel(), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    with flops.kernel("K8 dot_shapes", _flops(a, b)):
        build.library().call("batched_matmul", a, b.data_ptr(),
                             out.data_ptr(),
                             None if part is None else part.data_ptr(),
                             outer, inner, M, N, K, sa0, sa1, sb0, sb1,
                             float(alpha), float(out_scale), mode, tile,
                             splits, build.stream_of(a))
    batched_matmul.launches += 1
    return out


# ---- the chains ------------------------------------------------------------------

def _cells(t: torch.Tensor, cells: int) -> torch.Tensor:
    """Every cell reads the same operand: a stride-0 outer batch level."""
    return t.unsqueeze(0).expand(cells, *t.shape)


def dot_chain(variant: str, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, reps: int, bf16: bool = False,
              cells: int = NCH) -> torch.Tensor:
    """``reps`` chained pairs ``S = a b; a = (1e-3 S) c`` in each of
    ``cells`` cells, through :func:`batched_matmul` (2 * reps launches on
    the card): the output is (cells, *shapes(variant)[0]). At bf16 on the
    card the scores product stores bf16(1e-3 S) and the context product
    takes it as its rounded operand: the values the plain chain's
    ``cast(S * 1e-3)`` gives, in half the bytes."""
    shapes(variant)
    a, b, c = (_cells(t, cells) for t in (a, b, c))
    for _ in range(reps):
        if bf16 and a.is_cuda:
            s = _launch(a, b, 1.0, BF16_OUT, SCALE)
            a = _launch(s, c, 1.0, BF16_A)
        else:
            s = batched_matmul(a, b, 1.0, bf16)
            a = batched_matmul(s, c, SCALE, bf16)
    return a.contiguous()


def dot_chain_reference(variant: str, a: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, reps: int, bf16: bool = False,
                        cells: int = NCH) -> torch.Tensor:
    """The plain version of :func:`dot_chain`: the same chain in
    ``torch.einsum`` over the cells' broadcast operands."""
    shapes(variant)
    eq = "...mk,...kn->...mn"
    a, b, c = (_cells(t, cells) for t in (a, b, c))
    b, c = _round(b, bf16), _round(c, bf16)
    for _ in range(reps):
        s = torch.einsum(eq, _round(a, bf16), b)
        a = torch.einsum(eq, _round(s * SCALE, bf16), c)
    return a.contiguous()
