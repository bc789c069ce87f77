"""Trace annotations, a profiler trace of a run, and the analytic operation
counts (counterpart of multimodal_neuroimage_tpu/obs/profiling.py).

  * ``trace_annotation(name)``: ``torch.profiler.record_function`` (a
    named range in a profiler trace) plus an NVTX range on a CUDA device,
    the reference's range_push / range_pop (trainer.py:373-377);
  * ``profile_trace(dir)``: ``torch.profiler.profile`` over the CPU and,
    where there is one, the CUDA device around a region, its Chrome trace
    written into ``dir`` (the reference's ``--profiling`` under Nsight,
    main.py:98);
  * the analytic operation counts of the attention stacks (the reference's
    per-module ``flops()``, swin_v2_module.py:184-195, 310-322,
    model.py:1540-1555), exactly as the JAX package counts them;
  * the count of a step's work, JAX's ``traced_flops``, ``jaxpr_flops``
    and ``compiled_cost`` (below), the denominator of a utilization.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from multimodal_neuroimage_tpu_torch.ops import flops as kernel_flops
from multimodal_neuroimage_tpu_torch.ops import library
from multimodal_neuroimage_tpu_torch.parallel.mesh import rank


@contextlib.contextmanager
def trace_annotation(name: str):
    """A named range in a profiler trace, and on a CUDA device in NVTX."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: str = "cuda"):
    """Profile the enclosed region (CPU activity, and CUDA activity when
    ``device`` is a CUDA device) and write its Chrome trace,
    ``trace_rank<r>_<pid>_<ns>.json`` (r this process's rank,
    parallel/mesh.py), into ``log_dir``, also when the region
    raises; a no-op when ``log_dir`` is empty. The trace's kernel events name every kernel that ran."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        # written when the region raises too: a failing run's trace is the
        # one most worth reading
        path = os.path.join(
            log_dir, f"trace_rank{rank()}_{os.getpid()}_{time.time_ns()}"
                     f".json")
        prof.export_chrome_trace(path)
        print(f"[profile] trace written to {path}")


# ---------------------------------------------------------------------------
# Analytic cost model
# ---------------------------------------------------------------------------

def attention_flops(tokens: int, dim: int, heads: int) -> int:
    """One MHSA block: qkv + scores + context + out proj
    (swin_v2_module.py:184-195 structure)."""
    head_dim = dim // heads
    return (tokens * dim * 3 * dim            # qkv
            + heads * tokens * head_dim * tokens  # q @ k^T
            + heads * tokens * tokens * head_dim  # attn @ v
            + tokens * dim * dim)             # out proj


def mlp_flops(tokens: int, dim: int, mlp_ratio: float = 4.0) -> int:
    return int(2 * tokens * dim * dim * mlp_ratio)


def swin_block_flops(h: int, w: int, dim: int, heads: int, window: int,
                     mlp_ratio: float = 4.0) -> int:
    """One Swin block (swin_v2_module.py:310-322)."""
    n_windows = (h * w) // (window * window)
    return (n_windows * attention_flops(window * window, dim, heads)
            + mlp_flops(h * w, dim, mlp_ratio)
            + 2 * dim * h * w)                # norms


def swin_encoder_flops(img: int = 84, patch: int = 7, embed_dim: int = 12,
                       depths=(2, 2, 6), heads=(3, 6, 12), window: int = 6,
                       mlp_ratio: float = 4.0) -> int:
    """Full SwinV2 classifier cost (model.py:1540-1555 shape)."""
    res = img // patch
    total = img * img * embed_dim * patch * patch  # patch embed conv
    for i, (d, h) in enumerate(zip(depths, heads)):
        dim = embed_dim * 2 ** i
        r = res // 2 ** i
        total += d * swin_block_flops(r, r, dim, h, window, mlp_ratio)
        if i < len(depths) - 1:
            total += (r // 2) ** 2 * 4 * dim * 2 * dim  # patch merging
    return total


def bert_flops(seq: int, hidden: int, layers: int,
               intermediate: int = 3072) -> int:
    per_layer = (attention_flops(seq, hidden, 1)
                 + 2 * seq * hidden * intermediate)
    return layers * per_layer


# ---------------------------------------------------------------------------
# The count of a step's work
# ---------------------------------------------------------------------------
#
# JAX's census counts ``dot_general`` only, 2 * M * N * K a product with the
# batch dimensions multiplied in. Its convolutions (the SwinFusion stems'
# ``TorchConv`` and the SwinV2 patch embedding's ``nn.Conv``) are
# ``conv_general_dilated``, which it does not count, and neither does this
# one: the products counted are those of torch's flop formulas (mm, addmm,
# bmm, baddbmm, _scaled_mm, the fused attentions) and of the registered
# ops of ops/library.py (their kernels' formulas), never a convolution.

_aten = torch.ops.aten

PRODUCTS: Dict[object, Callable] = {
    op: formula for op, formula in flop_registry.items()
    if isinstance(op, torch._ops.OpOverloadPacket)
    and "conv" not in op._qualified_op_name}


def _library_op(func) -> Optional[str]:
    """The name of a registered op of ops/library.py, else None."""
    name = getattr(getattr(func, "_schema", None), "name", "")
    prefix = library.NAMESPACE + "::"
    return name[len(prefix):] if name.startswith(prefix) else None


def _count(packet, args, kwargs, out) -> int:
    """The products of one op by its formula."""
    return int(PRODUCTS[packet](*args, **kwargs, out_val=out))


class Census(TorchDispatchMode):
    """Counts the products of what runs inside it (module comment above).

    ``formulas=True``: every kernel call (ops/flops.py ``kernel``) and every
    registered op counts by its formula, the products inside it skipped;
    ``formulas=False``: only what torch itself runs, a kernel's launch being
    opaque (its plain version on the CPU counts as it runs). ``total`` is
    the count, ``kernels`` its kernels' share by kernel name."""

    def __init__(self, formulas: bool = True):
        super().__init__()
        self.formulas = formulas
        self.depth = 0
        self.total = 0
        self.kernels: Dict[str, int] = collections.Counter()

    def add_kernel(self, name: str, n: int) -> None:
        self.total += n
        self.kernels[name] += n

    def __enter__(self):
        kernel_flops.CENSUSES.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernel_flops.CENSUSES.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = getattr(func, "_overloadpacket", None)
        if packet not in PRODUCTS:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self.depth:
            return out
        lib = _library_op(func)
        if lib is not None:
            if self.formulas:
                self.add_kernel(lib, _count(packet, args, kwargs, out))
        elif packet in PRODUCTS:
            self.total += _count(packet, args, kwargs, out)
        return out


def traced_flops(fn: Callable, *args) -> int:
    """The products of one call of ``fn(*args)``, which runs once (its side
    effects, an optimizer step's among them, happen): every product torch
    runs, autograd's backward included, and every kernel by its formula
    (ops/flops.py), so the count is the same on the CPU and on the card, at
    either dtype and on either fusion layout. JAX counts the products of
    the traced step and of its VJP alike; its counts hold no convolution,
    and neither does this one."""
    with Census(formulas=True) as census:
        fn(*args)
    return census.total


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def _linear(x, w, *args, **kwargs) -> int:
    return 2 * _prod(x.shape[:-1]) * _prod(w.shape)


def _matmul(a, b, *args, **kwargs) -> int:
    sa = tuple(a.shape) if a.dim() > 1 else (1,) + tuple(a.shape)
    sb = tuple(b.shape) if b.dim() > 1 else tuple(b.shape) + (1,)
    batch = torch.broadcast_shapes(sa[:-2], sb[:-2])
    return 2 * _prod(batch) * sa[-2] * sa[-1] * sb[-1]


def _einsum(equation, operands, *args, **kwargs) -> int:
    """Two operands: 2 x the product of every index's size (each output
    element sums over the contracted ones); one operand has no product.
    An ellipsis stands for the operand's leading dimensions."""
    if len(operands) == 1:
        return 0
    if len(operands) != 2:
        raise ValueError(f"no census of a {len(operands)}-operand einsum "
                         f"({equation!r})")
    sizes = {}
    terms = equation.replace(" ", "").split("->")[0].split(",")
    for term, t in zip(terms, operands):
        names = list(term.replace("...", ""))
        if "..." in term:
            at = term.index("...")
            names[at:at] = [f"...{i}" for i in range(t.dim() - len(names))]
        for name, n in zip(names, t.shape):
            sizes[name] = max(sizes.get(name, 1), int(n))
    return 2 * _prod(sizes.values())


# the products of a captured graph's composite nodes (torch.export keeps
# linear, matmul and einsum as they were called)
_COMPOSITE = {_aten.linear: _linear, _aten.matmul: _matmul,
              _aten.einsum: _einsum}


def graph_flops(program) -> int:
    """Static product census of a captured graph (JAX's ``jaxpr_flops``):
    a ``torch.export.ExportedProgram`` or an ``fx.GraphModule`` whose
    nodes carry their values (``meta["val"]``, as export records them).
    Products are read from those shapes (linear, matmul and einsum nodes
    as export keeps them, and the ATen products), each registered op of
    ops/library.py counts by its formula, nested graphs are entered and a
    ``cond`` counts its larger branch, as JAX's does."""
    module = getattr(program, "graph_module", program)
    total = 0
    for node in module.graph.nodes:
        if node.op != "call_function":
            continue
        target = node.target
        if isinstance(target, torch._ops.HigherOrderOperator):
            subs = [getattr(module, a.target) for a in node.args
                    if isinstance(a, torch.fx.Node) and a.op == "get_attr"
                    and isinstance(getattr(module, a.target),
                                   torch.fx.GraphModule)]
            counts = [graph_flops(g) for g in subs]
            total += (max(counts, default=0) if target.name() == "cond"
                      else sum(counts))
            continue
        args, kwargs = torch.fx.node.map_arg(
            (node.args, node.kwargs),
            lambda n: n.meta.get("val") if isinstance(n, torch.fx.Node)
            else n)
        packet = getattr(target, "_overloadpacket", None)
        if packet in _COMPOSITE:
            total += _COMPOSITE[packet](*args, **kwargs)
        elif packet in PRODUCTS:
            total += _count(packet, args, kwargs, node.meta.get("val"))
    return total


def compiled_cost(fn: Callable, *args) -> Dict[str, float]:
    """The library's own count of one call of ``fn(*args)`` (XLA's
    ``cost_analysis``): the products torch runs, each kernel's launch
    opaque, as XLA cannot see inside a ``tpu_custom_call``. On the CPU,
    where every kernel is its plain version, it counts those products as
    they run: a forward's equal ``traced_flops``, a backward's hold in
    addition the plain backwards' recompute of their forward. On the card
    it is lower than ``traced_flops`` by exactly the kernels' share. Only
    ``"flops"`` has a counterpart: XLA's ``bytes accessed``,
    ``transcendentals``, ``optimal_seconds`` and ``utilization*`` keys have
    none."""
    with Census(formulas=False) as census:
        fn(*args)
    return {"flops": float(census.total)}
