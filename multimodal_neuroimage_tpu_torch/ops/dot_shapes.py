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
``torch.einsum`` (the plain version).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ops import build

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


# ---- the kernel ----------------------------------------------------------------

def _batch_strides(t: torch.Tensor, name: str):
    """(outer, inner) sizes and strides of t's batch dims (up to two; a
    stride of 0 broadcasts); its last two dims must be row-major."""
    if t.ndim < 2 or t.ndim > 4:
        raise ValueError(f"{name}: expected 2 to 4 dims, got {t.ndim}")
    if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
        raise ValueError(f"{name}: the last two dims must be row-major")
    lead = list(zip(t.shape[:-2], t.stride()[:-2]))
    lead = [(1, 0)] * (2 - len(lead)) + lead
    return lead


def batched_matmul(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0,
                   bf16: bool = False) -> torch.Tensor:
    """(*batch, M, K) x (*batch, K, N) -> (*batch, M, N) float32 with every
    operand element ``alpha * a`` / ``b`` rounded to bf16 first when
    ``bf16``. On CUDA tensors the K8 kernel (batch dims may broadcast with
    stride 0, e.g. ``expand``); on CPU tensors the plain version."""
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")
    if a.device.type == "cpu":
        return torch.matmul(_round(a * alpha, bf16), _round(b, bf16))
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    (outer, sa0), (inner, sa1) = _batch_strides(a, "a")
    _, (sb0, sb1) = zip(*_batch_strides(b, "b"))
    M, K, N = a.shape[-2], a.shape[-1], b.shape[-1]
    out = torch.empty(*a.shape[:-2], M, N, dtype=torch.float32,
                      device=a.device)
    build.library().call("batched_matmul", a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), outer, inner, M, N, K, sa0, sa1, sb0,
                         sb1, float(alpha), int(bf16), build.stream_of(a))
    batched_matmul.launches += 1
    return out


batched_matmul.launches = 0


# ---- the chains ------------------------------------------------------------------

def _cells(t: torch.Tensor, cells: int) -> torch.Tensor:
    """Every cell reads the same operand: a stride-0 outer batch level."""
    return t.unsqueeze(0).expand(cells, *t.shape)


def dot_chain(variant: str, a: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, reps: int, bf16: bool = False,
              cells: int = NCH) -> torch.Tensor:
    """``reps`` chained pairs ``S = a b; a = (1e-3 S) c`` in each of
    ``cells`` cells, through :func:`batched_matmul` (2 * reps launches on
    the card): the output is (cells, *shapes(variant)[0])."""
    shapes(variant)
    a, b, c = (_cells(t, cells) for t in (a, b, c))
    for _ in range(reps):
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
