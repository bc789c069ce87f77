"""Time the dot-shape formulations of the fusion window attention on one
CUDA card (counterpart of scripts/bench_dot_shapes.py).

    python -m multimodal_neuroimage_tpu_torch.bench.dot_shapes [f32|bf16] [variants...]

Each variant (``cur``, ``sm``, ``st``, ``ffold``, ``flat``; all by default)
runs the script's chain of scores + context batched products in every one
of its 7 cells through the K8 kernel (ops/dot_shapes.py). The time per pair
is the script's slope over the chain length, (t(10) - t(2)) / 8, each t the
best of 3 windows of 8 CUDA-event-timed chains. Beside it: the least time
the card could take for one pair (its operations over the card's peak rate
for the operand type, or its bytes, each input read once and the output
written once, over the memory rate, whichever is larger), and the same
slope for ``torch.bmm`` on the cells' materialised operands (bf16 operands
in bf16 there, a yardstick only). Default type bf16, as the script's.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense bf16, HBM3
PEAK_OPS = {False: 67e12, True: 989e12}
PEAK_BYTES = 3.35e12


def bound_ms(variant: str, bf16: bool):
    """(ms, "operations" or "bytes") of one pair over the 7 cells."""
    a, b, c = ds.shapes(variant)
    elems = sum(int(torch.Size(s).numel()) for s in (a, b, c))
    nbytes = 4 * (elems + ds.NCH * int(torch.Size(a).numel()))
    t_ops = ds.pair_flops(variant) / PEAK_OPS[bf16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _chain_ms(run, reps: int, iters: int = 8) -> float:
    run(reps)                                       # warm-up
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run(reps)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _bmm_chain(variant: str, operands, bf16: bool):
    """The chain on torch.bmm over materialised (cells * batch, M, K)
    operands."""
    dt = torch.bfloat16 if bf16 else torch.float32
    a, b, c = (t.to(dt).unsqueeze(0).expand(ds.NCH, *t.shape)
               .reshape(-1, *t.shape[-2:]).contiguous() for t in operands)

    def run(reps):
        q = a
        for _ in range(reps):
            q = torch.bmm(torch.bmm(q, b) * ds.SCALE, c)
        return q
    return run


def time_variant(variant: str, bf16: bool, r1: int = 2,
                 r2: int = 10) -> Dict[str, float]:
    """ms per pair of the K8 chain and of torch.bmm's, with the bound."""
    operands = ds.inputs(variant, device="cuda")
    t1, t2 = (_chain_ms(lambda r: ds.dot_chain(variant, *operands, r, bf16),
                        r) for r in (r1, r2))
    bmm = _bmm_chain(variant, operands, bf16)
    b1, b2 = (_chain_ms(bmm, r) for r in (r1, r2))
    bound, by = bound_ms(variant, bf16)
    return {"ms": (t2 - t1) / (r2 - r1), "bmm_ms": (b2 - b1) / (r2 - r1),
            "bound_ms": bound, "bound_by": by, "t1": t1, "t2": t2}


def run(dtype: str = "bf16", variants: Sequence[str] = ds.VARIANTS,
        verbose: bool = True) -> Dict[str, Dict[str, float]]:
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"dtype must be f32 or bf16, got {dtype!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("the dot-shape benchmark needs a CUDA card")
    out = {}
    for v in variants:
        r = out[v] = time_variant(v, dtype == "bf16")
        if verbose:
            print(f"{v:6s} {dtype:5s} {r['ms']:8.4f} ms per scores+context "
                  f"pair over {ds.NW} windows (r2={r['t1']:.3f} ms, "
                  f"r10={r['t2']:.3f} ms); bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); torch.bmm {r['bmm_ms']:.4f} ms per "
                  f"pair", flush=True)
    return out


def main(argv: Sequence[str]) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    run(argv[0] if argv else "bf16", argv[1:] or ds.VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
