"""Time the dot-shape formulations of the fusion window attention on one
CUDA card (counterpart of scripts/bench_dot_shapes.py).

    python -m multimodal_neuroimage_tpu_torch.bench.dot_shapes [f32|bf16] [variants...]
    python -m multimodal_neuroimage_tpu_torch.bench.dot_shapes products [variants...]

Each variant (``cur``, ``sm``, ``st``, ``ffold``, ``flat``; all by default)
runs the script's chain of scores + context batched products in every one
of its 7 cells through the K8 kernel (ops/dot_shapes.py). The time per pair
is the script's slope over the chain length, (t(10) - t(2)) / 8, each t the
best of 3 windows of 8 CUDA-event-timed chains; then the same slope on the
device alone, each t one replay of a CUDA graph that captured the chain
(mean of 5), which leaves out the host's time to enqueue the launches.
Beside it: the least time the card could take for one pair (its operations
over the card's peak rate for the operand type, or its bytes, each input
read once and the output written once, over the memory rate, whichever is
larger), and the same slopes for ``torch.bmm`` on the cells' materialised
operands (bf16 operands in bf16 there, a yardstick only). Default type
bf16, as the script's.

``products`` shows where a bf16 chain's time goes: for each variant
(default ``flat sm cur``) over its 7 cells, the device time of the chain's
two K8 products as ``dot_chain`` launches them, the scores product (its
output bf16(1e-3 S)) on each of K8's six tiles (``ops/dot_shapes.py``
``TILES``) and the context product on the chooser's tile and split; of
``torch.bmm`` on the same products (operands materialised in bf16 before
timing); and of a fill of a bf16 tensor the size of S (the time to write it
once): ``torch.profiler``'s device self-time per call over 20 calls, in us.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence

import torch

from multimodal_neuroimage_tpu_torch.bench.timing import (events_ms, graph_ms,
                                                          kernel_us)
from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense bf16, HBM3
PEAK_OPS = {False: 67e12, True: 989e12}
PEAK_BYTES = 3.35e12
R1, R2 = 2, 10        # the two chain lengths of the slope


def bound_ms(variant: str, bf16: bool):
    """(ms, "operations" or "bytes") of one pair over the 7 cells."""
    a, b, c = ds.shapes(variant)
    elems = sum(int(torch.Size(s).numel()) for s in (a, b, c))
    nbytes = 4 * (elems + ds.NCH * int(torch.Size(a).numel()))
    t_ops = ds.pair_flops(variant) / PEAK_OPS[bf16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def slope_ms(run, device: bool = False) -> float:
    """ms per pair of ``run(reps)``: (t(R2) - t(R1)) / (R2 - R1), each t
    the best of 3 windows of 8 event-timed chains, or with ``device`` one
    graph replay of the chain."""
    def t(reps):
        if device:
            return graph_ms(lambda: run(reps), iters=1)[0]
        return events_ms(lambda: run(reps), iters=8, windows=3)
    return (t(R2) - t(R1)) / (R2 - R1)


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


def _chains(variant: str, bf16: bool):
    operands = ds.inputs(variant, device="cuda")

    def k8(reps):
        return ds.dot_chain(variant, *operands, reps, bf16)
    return k8, _bmm_chain(variant, operands, bf16)


def time_variant(variant: str, bf16: bool) -> Dict[str, float]:
    """ms per pair of the K8 chain and of torch.bmm's (call time), with the
    bound."""
    k8, bmm = _chains(variant, bf16)
    bound, by = bound_ms(variant, bf16)
    return {"ms": slope_ms(k8), "bmm_ms": slope_ms(bmm), "bound_ms": bound,
            "bound_by": by}


def device_variant(variant: str, bf16: bool) -> Dict[str, float]:
    """The same slopes on the device alone (graph replays). Kept apart from
    :func:`time_variant`: a captured chain counts its launches once, at
    capture, and its replays not at all."""
    k8, bmm = _chains(variant, bf16)
    return {"device_ms": slope_ms(k8, True),
            "bmm_device_ms": slope_ms(bmm, True)}


def run(dtype: str = "bf16", variants: Sequence[str] = ds.VARIANTS,
        verbose: bool = True,
        device: bool = True) -> Dict[str, Dict[str, float]]:
    """Each variant's :func:`time_variant`, and its :func:`device_variant`
    with ``device``."""
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"dtype must be f32 or bf16, got {dtype!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("the dot-shape benchmark needs a CUDA card")
    out = {}
    for v in variants:
        r = out[v] = time_variant(v, dtype == "bf16")
        if device:
            r.update(device_variant(v, dtype == "bf16"))
        if verbose:
            dev = (f"; device alone: K8 {r['device_ms']:.4f} ms, torch.bmm "
                   f"{r['bmm_device_ms']:.4f} ms" if device else "")
            print(f"{v:6s} {dtype:5s} {r['ms']:8.4f} ms per scores+context "
                  f"pair over {ds.NW} windows; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); torch.bmm {r['bmm_ms']:.4f} ms per "
                  f"pair{dev}", flush=True)
    if verbose and len(out) > 1:
        k8, bmm = (min(out, key=lambda v: out[v][key])
                   for key in ("ms", "bmm_ms"))
        print(f"fastest formulation at {dtype}: {k8} on K8 "
              f"({out[k8]['ms']:.4f} ms a pair), {bmm} on torch.bmm "
              f"({out[bmm]['bmm_ms']:.4f} ms a pair)", flush=True)
    return out


def _us(fn) -> str:
    return ", ".join(f"{k[:48]} {us:.2f}" for k, us in kernel_us(fn).items())


def products(variant: str) -> None:
    """Print the device time of each bf16 product of ``variant`` (see the
    module's note)."""
    a, b, c = ds.inputs(variant, device="cuda")
    A, B, C = (ds._cells(t, ds.NCH) for t in (a, b, c))
    print(f"{variant}: scores {tuple(A.shape)} x {tuple(B.shape)}", flush=True)
    try:
        for tile, (bm, bn) in enumerate(ds.TILES):
            ds._CONFIG = (tile, 1)
            us = _us(lambda: ds._launch(A, B, 1.0, ds.BF16_OUT, ds.SCALE))
            print(f"  scores tile {bm}x{bn}: {us}", flush=True)
    finally:
        ds._CONFIG = None
    S = ds._launch(A, B, 1.0, ds.BF16_OUT, ds.SCALE)
    tile, splits = ds.choose_config(S.shape[-2], C.shape[-1], S.shape[-1],
                                    S[..., 0, 0].numel())
    print(f"  context (tile {ds.TILES[tile]}, {splits} splits): "
          f"{_us(lambda: ds._launch(S, C, 1.0, ds.BF16_A))}")
    a16, b16, c16 = (t.bfloat16().unsqueeze(0).expand(ds.NCH, *t.shape)
                     .reshape(-1, *t.shape[-2:]).contiguous()
                     for t in (a, b, c))
    s16 = torch.bmm(a16, b16)
    print(f"  torch.bmm scores: {_us(lambda: torch.bmm(a16, b16))}; context: "
          f"{_us(lambda: torch.bmm(s16, c16))}")
    fill = torch.empty(S.numel(), dtype=torch.bfloat16, device="cuda")
    print(f"  fill {fill.numel() * 2 / 1e6:.1f} MB: "
          f"{_us(lambda: fill.fill_(1.0))}", flush=True)


def main(argv: Sequence[str]) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv[:1] == ["products"]:
        if not torch.cuda.is_available():
            raise RuntimeError("the dot-shape benchmark needs a CUDA card")
        for v in argv[1:] or ("flat", "sm", "cur"):
            products(v)
        return 0
    run(argv[0] if argv else "bf16", argv[1:] or ds.VARIANTS)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
