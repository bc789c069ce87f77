"""K7: the SwinFusion self and cross blocks on group-major streams, forward
and backward.

Counterpart of multimodal_neuroimage_tpu/ops/fusion_block_bp.py
``fused_fusion_block_bp`` / ``fused_cross_fusion_block_bp`` (the bp layout
of ``FUSION_LAYOUT=bp``). The batch of B subjects is cut into ngroups =
B / G groups of G = :func:`group_size` (B) subjects; a stream is
group-major, ``(ngroups, nW, N, G*C)``, subject ``b = g*G + j`` in lanes
``[j*C, (j+1)*C)`` of group ``g``. One CUDA kernel each way, templated on
cross (``csrc/fusion_block_bp.cu``), runs K2/K3's block per (group, window),
walking its G subjects; the autograd Function around them dispatches on the
device of x: CUDA tensors launch the kernels (or raise), CPU tensors run
:func:`fusion_block_bp_reference` / :func:`cross_fusion_block_bp_reference`
and autograd through them (the plain versions).

The block is K2/K3's; only the dropout masks differ from the std layout's.
They are the JAX bp kernels', bit for bit (hash coordinates of
``_forward_bp`` and its backward, NP = round_up(N, 8), L = G*H*NP):

  proj, fc2   row w*NP + n, column g*G*C + j*C + c
  fc1         row w*NP + n, column g*G*C + j*Ch + f  (the group offset is
              G*C, not G*Ch: group g+1's hidden masks overlap group g's, as
              in the JAX package)
  attention   row w*NP + n, column g*L + (j*H + h)*NP + key, draw 3

with no batch term in any row. With dropout off the bp and std blocks are
one function.

Contract (as K2/K3's): x, y group-major windows with N unpadded; bias
``(H, N, N)``; mask ``(nW, N, N)`` or None; dp ``(B, 2)`` or None, in which
case ``group`` gives G; params the same 12-tuple (self) and 16-tuple
(cross) in torch ``(out, in)`` layout.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from multimodal_neuroimage_tpu_torch.ops import build
from multimodal_neuroimage_tpu_torch.ops.fusion_block import (
    _block_reference, _check_params, _check_streams, _iota, _ptr,
    launch_backward, round_up)


def group_size(B: int) -> int:
    """The largest divisor of B that is at most ``FUSION_BP_GROUP`` (read
    at each call, default 8), as the JAX package's ``group_size``."""
    cap = max(1, int(os.environ.get("FUSION_BP_GROUP", "8")))
    g = min(B, cap)
    while B % g:
        g -= 1
    return g


def to_groups(x: torch.Tensor, G: int) -> torch.Tensor:
    """(B, *mid, C) -> group-major (B/G, *mid, G*C)."""
    B, C, mid = x.shape[0], x.shape[-1], x.shape[1:-1]
    t = x.reshape(B // G, G, -1, C).transpose(1, 2)
    return t.reshape(B // G, *mid, G * C)


def from_groups(x: torch.Tensor, G: int) -> torch.Tensor:
    """Group-major (ngroups, *mid, G*C) -> (ngroups*G, *mid, C)."""
    ng, GC, mid = x.shape[0], x.shape[-1], x.shape[1:-1]
    t = x.reshape(ng, -1, G, GC // G).transpose(1, 2)
    return t.reshape(ng * G, *mid, GC // G)


def bp_keys(G: int, C: int, H: int, Ch: int):
    """The bp layout's dropout coordinates (module docstring) for
    ``_block_reference``: rows w*NP + n for every subject, and per-subject
    column offsets of the C-wide, Ch-wide and attention draws."""
    def keys(B, nW, N, NP, device):
        rows = (_iota(nW, device).reshape(1, nW, 1, 1) * NP
                + _iota(N, device).reshape(1, 1, N, 1))
        b = _iota(B, device).reshape(B, 1, 1, 1)
        g, j = b // G, b % G
        return (rows, g * G * C + j * C, g * G * C + j * Ch,
                g * G * H * NP + j * H * NP)
    return keys


def _group(x: torch.Tensor, dp: Optional[torch.Tensor],
           group: Optional[int]) -> int:
    """G of a group-major stream: from dp's B when given, else ``group``."""
    ng, GC = x.shape[0], x.shape[-1]
    G = dp.shape[0] // ng if dp is not None else group
    if G is None or G < 1 or GC % G or (dp is not None and
                                        dp.shape[0] != ng * G):
        raise ValueError(f"cannot cut a ({ng}, ..., {GC}) group-major stream "
                         f"into subjects (dp {None if dp is None else tuple(dp.shape)}, "
                         f"group {group})")
    if group is not None and group != G:
        raise ValueError(f"dp gives {G} subjects a group, group says {group}")
    return G


# ---- plain versions -----------------------------------------------------------

def _bp_reference(x, y, params, bias, mask, dp, seed, rates, training,
                  cross: bool, G: int):
    C = x.shape[-1] // G
    keys = bp_keys(G, C, bias.shape[0], params[-4].shape[0])
    out = _block_reference(from_groups(x, G),
                           from_groups(y, G) if cross else None, params,
                           bias, mask, dp, seed, rates, training, cross, keys)
    return to_groups(out, G)


def fusion_block_bp_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                              bias: torch.Tensor,
                              mask: Optional[torch.Tensor] = None,
                              dp: Optional[torch.Tensor] = None,
                              seed: int = 0,
                              rates: Tuple[float, float] = (0.0, 0.0),
                              training: bool = False,
                              group: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch self block over group-major windows: the std block per
    subject with the bp layout's dropout masks."""
    return _bp_reference(x, None, params, bias, mask, dp, seed, rates,
                         training, False, _group(x, dp, group))


def cross_fusion_block_bp_reference(x: torch.Tensor, y: torch.Tensor,
                                    params: Sequence[torch.Tensor],
                                    bias: torch.Tensor,
                                    mask: Optional[torch.Tensor] = None,
                                    dp: Optional[torch.Tensor] = None,
                                    seed: int = 0,
                                    rates: Tuple[float, float] = (0.0, 0.0),
                                    training: bool = False,
                                    group: Optional[int] = None
                                    ) -> torch.Tensor:
    """Plain PyTorch directed cross block (q from x, k/v from y) over
    group-major windows; returns the updated x stream."""
    return _bp_reference(x, y, params, bias, mask, dp, seed, rates,
                         training, True, _group(x, dp, group))


def fusion_block_bp_reference_backward(g, x, y, params, bias, mask=None,
                                       dp=None, seed: int = 0,
                                       rates=(0.0, 0.0), training=False,
                                       cross: bool = False, group=None):
    """Plain backward: autograd through the plain forward. Returns
    (dx, dy or None, dbias, dparams)."""
    G = _group(x, dp, group)
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        ys = y.detach().requires_grad_() if cross else None
        bs = bias.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        out = _bp_reference(xs, ys, ps, bs, mask, dp, seed, rates, training,
                            cross, G)
        inputs = [xs] + ([ys] if cross else []) + [bs] + ps
        grads = torch.autograd.grad(out, inputs, g)
    dx, rest = grads[0], list(grads[1:])
    dy = rest.pop(0) if cross else None
    return dx, dy, rest[0], tuple(rest[1:])


# ---- CUDA launches -----------------------------------------------------------

def _check(x, y, params, bias, mask, dp, cross: bool, G: int):
    ng, nW, N, GC = x.shape
    _check_streams(x, y, bias, mask, dp, cross, ng * G)
    return (ng, nW, N, GC // G) + _check_params(params, bias, GC // G, cross)


def _launch_forward(x, y, params, bias, mask, dp, seed, rates, training,
                    save: bool, cross: bool, G: int):
    ng, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross, G)
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    out = torch.empty_like(x)
    x2r = torch.empty_like(x) if save else None
    build.library().call(
        "fusion_block_bp_forward", int(cross), x.data_ptr(), _ptr(y),
        build.pointer_array(params), bias.data_ptr(), _ptr(mask),
        out.data_ptr(), ng, G, nW, N, C, H, Ch, _ptr(dp), int(seed),
        float(attn_rate), float(drop_rate), round_up(N, 8), _ptr(x2r),
        build.stream_of(x))
    (fused_cross_fusion_block_bp if cross
     else fused_fusion_block_bp).launches += 1
    return out, x2r


def _backward(g, x, y, params, bias, mask, dp, seed, rates, training, x2r,
              cross: bool, G: int):
    if x.device.type == "cpu":
        return fusion_block_bp_reference_backward(
            g, x, y, params, bias, mask, dp, seed, rates, training, cross, G)
    ng, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross, G)
    return launch_backward("fusion_block_bp_backward", (ng, G, nW), g, x, y,
                           params, bias, mask, dp, seed, rates, training, x2r,
                           cross, N, C, H, Ch)


def fused_fusion_block_bp_backward(g, x, params, bias, mask=None, dp=None,
                                   seed=0, rates=(0.0, 0.0), training=False,
                                   x2r=None, group=None):
    """K7 self backward: (dx, dbias, dparams). CUDA tensors launch the
    kernel (x2r from the CUDA forward); CPU tensors take the plain
    backward."""
    dx, _, dbias, dparams = _backward(g, x, None, params, bias, mask, dp,
                                      seed, rates, training, x2r, False,
                                      _group(x, dp, group))
    if x.device.type != "cpu":
        fused_fusion_block_bp_backward.launches += 1
    return dx, dbias, dparams


def fused_cross_fusion_block_bp_backward(g, x, y, params, bias, mask=None,
                                         dp=None, seed=0, rates=(0.0, 0.0),
                                         training=False, x2r=None,
                                         group=None):
    """K7 cross backward: (dx, dy, dbias, dparams), dispatching as the self
    backward."""
    out = _backward(g, x, y, params, bias, mask, dp, seed, rates, training,
                    x2r, True, _group(x, dp, group))
    if x.device.type != "cpu":
        fused_cross_fusion_block_bp_backward.launches += 1
    return out


class _FusionBlockBpFunction(torch.autograd.Function):
    """Forward and backward of one group-major block; CUDA kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, y, bias, mask, dp, seed, rates, training, save,
                cross, G, *params):
        if x.device.type == "cpu":
            out = _bp_reference(x, y, params, bias, mask, dp, seed, rates,
                                training, cross, G)
            x2r = None
        else:
            out, x2r = _launch_forward(x, y, params, bias, mask, dp, seed,
                                       rates, training, save, cross, G)
        ctx.meta = (seed, rates, training, cross, G)
        ctx.save_for_backward(x, y, bias, mask, dp, x2r, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        seed, rates, training, cross, G = ctx.meta
        x, y, bias, mask, dp, x2r, *params = ctx.saved_tensors
        g = g.contiguous()
        if cross:
            dx, dy, dbias, dparams = fused_cross_fusion_block_bp_backward(
                g, x, y, params, bias, mask, dp, seed, rates, training, x2r,
                G)
        else:
            dx, dbias, dparams = fused_fusion_block_bp_backward(
                g, x, params, bias, mask, dp, seed, rates, training, x2r, G)
            dy = None
        return (dx, dy, dbias, None, None, None, None, None, None, None,
                None, *dparams)


def _apply(x, y, params, bias, mask, dp, seed, rates, training, cross,
           group):
    G = _group(x, dp, group)
    tensors = [x, bias, *params] + ([y] if cross else [])
    save = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return _FusionBlockBpFunction.apply(x, y, bias, mask, dp, int(seed),
                                        tuple(rates), bool(training), save,
                                        cross, G, *params)


def fused_fusion_block_bp(x: torch.Tensor, params: Sequence[torch.Tensor],
                          bias: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          dp: Optional[torch.Tensor] = None, seed: int = 0,
                          rates: Tuple[float, float] = (0.0, 0.0),
                          training: bool = False,
                          group: Optional[int] = None) -> torch.Tensor:
    """Self block over group-major windows (differentiable): the CUDA
    kernels on CUDA tensors, the plain version on CPU tensors."""
    return _apply(x, None, params, bias, mask, dp, seed, rates, training,
                  False, group)


def fused_cross_fusion_block_bp(x: torch.Tensor, y: torch.Tensor,
                                params: Sequence[torch.Tensor],
                                bias: torch.Tensor,
                                mask: Optional[torch.Tensor] = None,
                                dp: Optional[torch.Tensor] = None,
                                seed: int = 0,
                                rates: Tuple[float, float] = (0.0, 0.0),
                                training: bool = False,
                                group: Optional[int] = None) -> torch.Tensor:
    """Directed cross block over group-major windows (q from x, k/v from y;
    differentiable in both streams), dispatching as
    :func:`fused_fusion_block_bp`."""
    return _apply(x, y, params, bias, mask, dp, seed, rates, training, True,
                  group)


fused_fusion_block_bp.launches = 0
fused_cross_fusion_block_bp.launches = 0
fused_fusion_block_bp_backward.launches = 0
fused_cross_fusion_block_bp_backward.launches = 0
