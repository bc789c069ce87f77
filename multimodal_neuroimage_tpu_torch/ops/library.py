"""The forward kernels as registered torch ops: the port's counterpart of
the TPU custom call in an exported program.

The wrappers launch their kernels through ``ctypes`` on data pointers
(ops/build.py), which a tracer's fake tensors do not have, so
``torch.export`` cannot trace through them. Each inference forward that
the serving path launches is therefore also a ``torch.library.custom_op``
in the ``neuroimage`` namespace, one a kernel, with a fake implementation
that gives its output's shape and dtype (its first input's):

  bert_layer_forward          K1 (``bert_layer_call``; ``mm16``: its
                              bf16-product form, ``bert_layer_call16``)
  fusion_block_forward        K2 (y None) and K3 (``fused_fusion_block``,
                              ``fused_cross_fusion_block``)
  window_attention_forward    K4 (``fused_window_attention``)
  mha_forward                 K6 (``fused_attention``), float32 or bf16
  fusion_block_bp_forward     K7, self (y None) and cross
                              (``fused_fusion_block_bp``), on float32 or
                              bf16 streams

An op's implementation dispatches on its input's device and dtype: a CUDA
tensor launches the kernel of its form through the wrapper's launcher
(which counts the launch on that wrapper, so an exported program's kernels
show in ``ops.launches()``, and raises when the kernel cannot be built or
launched); a CPU tensor runs the plain version. Dropout is off: these are
the inference forms.

The wrappers reach these ops only while a trace runs
(``torch.compiler.is_exporting()``) and only at inference, through
``in_trace``; the eager path keeps its direct launches. Within
``plain_versions()`` a trace takes the plain versions instead, so the
exported graph holds no registered op and runs with ``torch`` alone
(serve/export.py ``portable=True``).

``full_f32`` is the numerics the model's forwards run at (no TF32), which
an exported program does not record: serve/export.py runs an artifact
under it, as the live model runs its forward.

Each op's products are its kernel's formula (ops/flops.py), registered
with ``torch.utils.flop_counter``: torch's ``FlopCounterMode`` and the
port's census (obs/profiling.py) read an op by it.

This module imports nothing of the port at import time but ops/flops.py
(the kernel modules load at an op's first call), so an exported program
loads without any model module (serve/export.py ``load_exported``). The
training forwards and the backward kernels are not registered.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from multimodal_neuroimage_tpu_torch.ops import flops

NAMESPACE = "neuroimage"
_NO_DROPOUT = (0.0, 0.0)
_PLAIN = False


@contextlib.contextmanager
def full_f32():
    """Run float32 matmuls and cuDNN convolutions in full float32 (no TF32),
    restoring the previous settings on exit. cuDNN convs default to TF32,
    which keeps about three decimal digits."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def plain_versions():
    """Within the block a trace takes every kernel's plain version, not its
    registered op."""
    global _PLAIN
    saved, _PLAIN = _PLAIN, True
    try:
        yield
    finally:
        _PLAIN = saved


# ---- each kernel's plain version ---------------------------------------------

def _plain_k1(x, params, heads, t_valid, mm16):
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    return bl.bert_layer_reference(x, params, heads, t_valid, 0, _NO_DROPOUT,
                                   False, mm16)


def _plain_k2k3(x, y, params, bias, mask):
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    return fb._block_reference(x, y, params, bias, mask, None, 0, _NO_DROPOUT,
                               False, y is not None)


def _plain_k4(q, k, v, bias, mask):
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    return att.attention_reference(q, k, v, bias, mask)


def _plain_k6(q, k, v):
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    plain = (att.mha_reference16 if q.dtype == torch.bfloat16
             else att.mha_reference)
    return plain(q, k, v)


def _plain_k7(x, y, params, bias, mask, group):
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    if x.dtype == torch.bfloat16:
        return fbp.fusion_block_bp_reference16(
            x, params, bias, mask, None, 0, _NO_DROPOUT, False, y, group)[0]
    return fbp._bp_reference(x, y, params, bias, mask, None, 0, _NO_DROPOUT,
                             False, y is not None, group)


# ---- the ops: the launch on a CUDA tensor, the plain version on the CPU ----

@torch.library.custom_op(f"{NAMESPACE}::bert_layer_forward", mutates_args=())
def bert_layer_forward(x: Tensor, params: List[Tensor], heads: int,
                       t_valid: int, mm16: bool) -> Tensor:
    if x.device.type == "cpu":
        return _plain_k1(x, params, heads, t_valid, mm16)
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    return bl._launch_forward(x, params, heads, t_valid, 0, _NO_DROPOUT,
                              False, False, mm16)[0]


@torch.library.custom_op(f"{NAMESPACE}::fusion_block_forward",
                         mutates_args=())
def fusion_block_forward(x: Tensor, y: Optional[Tensor],
                         params: List[Tensor], bias: Tensor,
                         mask: Optional[Tensor]) -> Tensor:
    if x.device.type == "cpu":
        return _plain_k2k3(x, y, params, bias, mask)
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    return fb._launch_forward(x, y, params, bias, mask, None, 0, _NO_DROPOUT,
                              False, False, y is not None)[0]


@torch.library.custom_op(f"{NAMESPACE}::window_attention_forward",
                         mutates_args=())
def window_attention_forward(q: Tensor, k: Tensor, v: Tensor, bias: Tensor,
                             mask: Optional[Tensor]) -> Tensor:
    if q.device.type == "cpu":
        return _plain_k4(q, k, v, bias, mask)
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    return att._launch_forward(q, k, v, bias, mask)


@torch.library.custom_op(f"{NAMESPACE}::mha_forward", mutates_args=())
def mha_forward(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    if q.device.type == "cpu":
        return _plain_k6(q, k, v)
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    if q.dtype == torch.bfloat16:
        return att._launch_mha_forward16(q, k, v, 0, 0.0, False)[0]
    return att._launch_mha_forward(q, k, v, 0, 0.0)[0]


@torch.library.custom_op(f"{NAMESPACE}::fusion_block_bp_forward",
                         mutates_args=())
def fusion_block_bp_forward(x: Tensor, y: Optional[Tensor],
                            params: List[Tensor], bias: Tensor,
                            mask: Optional[Tensor], group: int) -> Tensor:
    if x.device.type == "cpu":
        return _plain_k7(x, y, params, bias, mask, group)
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    return fbp._launch_forward(x, y, params, bias, mask, None, 0, _NO_DROPOUT,
                               False, False, y is not None, group)[0]


# kernel: (its registered op, its plain version), called alike
_OPS = {"bert_layer": (bert_layer_forward, _plain_k1),
        "fusion_block": (fusion_block_forward, _plain_k2k3),
        "window_attention": (window_attention_forward, _plain_k4),
        "mha": (mha_forward, _plain_k6),
        "fusion_block_bp": (fusion_block_bp_forward, _plain_k7)}


def _like_first(x, *args):
    """Every op's output has its first input's shape and dtype."""
    return torch.empty_like(x)


for _op, _ in _OPS.values():
    _op.register_fake(_like_first)


# ---- each op's products, from its arguments' shapes --------------------------

def _k1_flops(x, params, heads, t_valid, mm16, out_shape=None):
    B, T, H = x
    return flops.bert_layer(B, T, H, params[10][0])


def _k2k3_flops(x, y, params, bias, mask, out_shape=None):
    B, nW, N, C = x
    return flops.fusion_block(B, nW, N, C, params[-4][0])


def _k4_flops(q, k, v, bias, mask, out_shape=None):
    B, nW, H, N, D = q
    return flops.attention(B * nW, H, N, k[-2], D)


def _k6_flops(q, k, v, out_shape=None):
    B, H, T, D = q
    return flops.attention(B, H, T, k[-2], D)


def _k7_flops(x, y, params, bias, mask, group, out_shape=None):
    ngroups, nW, N, GC = x
    return flops.fusion_block(ngroups * group, nW, N, GC // group,
                              params[-4][0])


for _op, _formula in ((bert_layer_forward, _k1_flops),
                      (fusion_block_forward, _k2k3_flops),
                      (window_attention_forward, _k4_flops),
                      (mha_forward, _k6_flops),
                      (fusion_block_bp_forward, _k7_flops)):
    register_flop_formula(getattr(torch.ops.neuroimage,
                                  _op._qualname.split("::")[1]))(_formula)


def ops() -> List[str]:
    """The qualified names of the registered ops."""
    return [op._qualname for op, _ in _OPS.values()]


def in_trace(kernel: str, *args):
    """``kernel``'s inference forward while a trace runs (a key of
    ``_OPS``, the op's arguments): its registered op, or within
    ``plain_versions()`` its plain version."""
    op, plain = _OPS[kernel]
    return plain(*args) if _PLAIN else op(*args)
