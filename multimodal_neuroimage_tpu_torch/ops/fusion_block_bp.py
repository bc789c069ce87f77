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

The bf16 form (the bf16 policy's bp stacks, whose streams JAX casts to bf16
and whose kernels then turn mm16 on): x, y, the output, the saved x2r, the
cotangent and dx, dy are bf16; the block computes in float32 with every
product on bf16-rounded operands and the mm16 softmax
(:func:`fusion_block_bp_reference16`, and the written-out
:func:`fusion_block_bp_reference_backward16`); the kernels are the same
ones instantiated on bf16 streams (``fusion_block_bp_forward16`` /
``_backward16``). A bf16 stream on the card launches them or raises.

Contract (as K2/K3's): x, y group-major windows with N unpadded; bias
``(H, N, N)``; mask ``(nW, N, N)`` or None; dp ``(B, 2)`` or None, in which
case ``group`` gives G; params the same 12-tuple (self) and 16-tuple
(cross) in torch ``(out, in)`` layout.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.ops import build
from multimodal_neuroimage_tpu_torch.ops.fusion_block import (
    DRAW_ATTN, DRAW_MLP1, DRAW_MLP2, DRAW_PROJ, LOGIT_CAP,
    _block_reference, _check_params, _check_streams, _iota, _ptr,
    bf16_round, gelu_grad, launch_backward, ln_bwd, ln_parts, mix_keep,
    round_up)


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


# ---- the bf16 form (bf16 streams, mm16 products) -----------------------------

def _fwd16(x, y, params, bias, mask, dp, seed, rates, training, cross: bool,
           G: int) -> dict:
    """The block on bf16 group-major streams as the JAX bp kernel computes
    it with mm16 (``_forward_bp``): streams widened to float32, every
    product on bf16-rounded operands with float32 sums (q * scale and k in
    the scores, the dropped probabilities and v in the context), the packed
    mm16 softmax (logits capped at 80, denominators summed from bf16(e),
    p = e * bf16(1 / den)); LayerNorms, residuals and dropout in float32.
    Works per subject on (B, nW, N, C) windows; keeps what the backward
    needs."""
    bf = bf16_round
    mm = lambda a, w: bf(a) @ bf(w).t()
    xs = from_groups(x, G).float()
    ys = from_groups(y, G).float() if cross else None
    B, nW, N, C = xs.shape
    H = bias.shape[0]
    hd = C // H
    prm = [p.float() for p in params]
    if cross:
        (g1, b1, g1y, b1y, wq, bq, wkv, bkv,
         wp, bp, g2, b2, w1, b1m, w2, b2m) = prm
        h1, xh1, r1 = ln_parts(xs, g1, b1)
        hk, xhk, rk = ln_parts(ys, g1y, b1y)
        q = mm(h1, wq) + bq
        k, v = (mm(hk, wkv) + bkv).chunk(2, -1)
    else:
        (g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m) = prm
        h1, xh1, r1 = ln_parts(xs, g1, b1)
        hk, xhk, rk = h1, None, None
        q, k, v = (mm(h1, wqkv) + bqkv).chunk(3, -1)
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    NP = round_up(N, 8)
    rows, off_c, off_h, off_a = bp_keys(G, C, H, w1.shape[0])(
        B, nW, N, NP, xs.device)

    def hidden(draw, width, off):
        if drop_rate <= 0.0:
            return None
        return mix_keep(rows, _iota(width, xs.device) + off, drop_rate, seed,
                        draw)

    def split(t):
        return t.reshape(B, nW, N, H, hd).transpose(2, 3)

    qs = bf(split(q) * hd ** -0.5)
    s = torch.einsum("bwhnd,bwhmd->bwhnm", qs, bf(split(k))) + bias.float()
    if mask is not None:
        s = s + mask.float()[None, :, None]
    e = torch.exp(torch.clamp(s, max=LOGIT_CAP))
    den = bf(e).sum(dim=-1, keepdim=True)
    p = e * bf(1.0 / torch.clamp(den, min=1e-38))
    keep = None
    if attn_rate > 0.0:
        cols = _iota(H, xs.device)[:, None, None] * NP + _iota(N, xs.device)
        keep = mix_keep(rows[:, :, None], cols + off_a[..., None], attn_rate,
                        seed, DRAW_ATTN)
    pd = p * keep if keep is not None else p
    o = torch.einsum("bwhnm,bwhmd->bwhnd", bf(pd), bf(split(v)))
    o = o.transpose(2, 3).reshape(B, nW, N, C)
    dp1, dp2 = ((1.0, 1.0) if dp is None
                else (dp[:, 0].float().reshape(B, 1, 1, 1),
                      dp[:, 1].float().reshape(B, 1, 1, 1)))
    m_proj, m1, m2 = (hidden(DRAW_PROJ, C, off_c),
                      hidden(DRAW_MLP1, w1.shape[0], off_h),
                      hidden(DRAW_MLP2, C, off_c))
    a = mm(o, wp) + bp
    if m_proj is not None:
        a = a * m_proj
    x2r = xs + dp1 * a
    h2, xh2, r2 = ln_parts(x2r, g2, b2)
    u = mm(h2, w1) + b1m
    gu = F.gelu(u)
    if m1 is not None:
        gu = gu * m1
    z = mm(gu, w2) + b2m
    if m2 is not None:
        z = z * m2
    out = x2r + dp2 * z
    return dict(out=out, x2r=x2r, xs=xs, ys=ys, h1=h1, xh1=xh1, r1=r1,
                hk=hk, xhk=xhk, rk=rk, q=q, qs=qs, k=k, v=v, p=p, pd=pd,
                keep=keep, o=o, dp1=dp1, dp2=dp2, m_proj=m_proj, m1=m1,
                m2=m2, h2=h2, xh2=xh2, r2=r2, u=u, gu=gu, prm=prm)


def fusion_block_bp_reference16(x, params, bias, mask=None, dp=None, seed=0,
                                rates=(0.0, 0.0), training=False, y=None,
                                group=None):
    """Plain bf16 form of the bp block (self, or cross when ``y`` is
    given): (out, x2r), bf16 group-major like x."""
    G = _group(x, dp, group)
    f = _fwd16(x, y, params, bias, mask, dp, seed, rates, training,
               y is not None, G)
    return (to_groups(f["out"], G).to(x.dtype),
            to_groups(f["x2r"], G).to(x.dtype))


def fusion_block_bp_reference_backward16(g, x, y, params, bias, mask=None,
                                         dp=None, seed: int = 0,
                                         rates=(0.0, 0.0), training=False,
                                         cross: bool = False, group=None):
    """The bf16 form's plain backward, written out as the JAX bp backward
    kernel computes it with mm16 (``_make_bwd_kernel_bp``): products of
    bf16-rounded operands, seg = bf16(sum bf16(dp p)) (``_seg_rows``), the
    LayerNorms over the saved (bf16) x2r and the widened inputs. Returns
    (dx, dy or None, dbias, dparams): dx and dy bf16 as the streams, dbias
    and dparams float32 (the caller casts them to their tensors' dtypes)."""
    G = _group(x, dp, group)
    f = _fwd16(x, y, params, bias, mask, dp, seed, rates, training, cross, G)
    bf = bf16_round
    B, nW, N, C = f["xs"].shape
    H = bias.shape[0]
    hd = C // H
    if cross:
        (g1, b1, g1y, b1y, wq, bq, wkv, bkv,
         wp, bp, g2, b2, w1, b1m, w2, b2m) = f["prm"]
    else:
        (g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m) = f["prm"]
    gs = from_groups(g, G).float()
    rows = lambda t: t.reshape(-1, t.shape[-1])
    colsum = lambda t: rows(t).sum(dim=0)
    tn = lambda a, b: bf(rows(a)).t() @ bf(rows(b))     # sum_rows a^T b
    mask_or = lambda t, m: t * m if m is not None else t

    # MLP / LN2 over the saved x2r (bf16 in device memory)
    x2r = bf(f["x2r"])
    h2, xh2, r2 = ln_parts(x2r, g2, b2)
    u = bf(h2) @ bf(w1).t() + b1m
    gu = mask_or(F.gelu(u), f["m1"])
    dz = mask_or(f["dp2"] * gs, f["m2"])
    dw2 = tn(dz, gu)
    du = mask_or(bf(dz) @ bf(w2), f["m1"]) * gelu_grad(u)
    dw1 = tn(du, h2)
    dh2 = bf(du) @ bf(w1)
    dg2, db2 = colsum(dh2 * xh2), colsum(dh2)
    dx2r = gs + ln_bwd(dh2, xh2, r2, g2)

    # proj, attention
    da = mask_or(f["dp1"] * dx2r, f["m_proj"])
    do = bf(da) @ bf(wp)
    dwp, dbp = tn(da, f["o"]), colsum(da)

    def split(t):
        return t.reshape(B, nW, N, H, hd).transpose(2, 3)

    p, keep = f["p"], f["keep"]
    dO = split(do)
    dpd = torch.einsum("bwhnd,bwhmd->bwhnm", bf(dO), bf(split(f["v"])))
    dv = torch.einsum("bwhnm,bwhnd->bwhmd", bf(f["pd"]), bf(dO))
    dp_ = dpd * keep if keep is not None else dpd
    seg = bf(bf(dp_ * p).sum(dim=-1, keepdim=True))
    ds = p * (dp_ - seg)
    dbias = ds.sum(dim=(0, 1))
    dq = torch.einsum("bwhnm,bwhmd->bwhnd", bf(ds),
                      bf(split(f["k"]))) * hd ** -0.5
    dk = torch.einsum("bwhnm,bwhnd->bwhmd", bf(ds), f["qs"])
    merge = lambda t: t.transpose(2, 3).reshape(B, nW, N, C)
    dq, dk, dv = merge(dq), merge(dk), merge(dv)
    dh1 = bf(dq) @ bf(wq if cross else wqkv[:C])
    if cross:
        dwq, dbq = tn(dq, f["h1"]), colsum(dq)
        dkv = torch.cat([dk, dv], dim=-1)
        dwkv, dbkv = tn(dkv, f["hk"]), colsum(dkv)
        dhk = bf(dk) @ bf(wkv[:C]) + bf(dv) @ bf(wkv[C:])
        dgy, dby = colsum(dhk * f["xhk"]), colsum(dhk)
        dy = ln_bwd(dhk, f["xhk"], f["rk"], g1y)
    else:
        dqkv = torch.cat([dq, dk, dv], dim=-1)
        dwqkv, dbqkv = tn(dqkv, f["h1"]), colsum(dqkv)
        dh1 = dh1 + bf(dk) @ bf(wqkv[C:2 * C]) + bf(dv) @ bf(wqkv[2 * C:])
    dg1, db1 = colsum(dh1 * f["xh1"]), colsum(dh1)
    dx = dx2r + ln_bwd(dh1, f["xh1"], f["r1"], g1)
    tail = (dwp, dbp, dg2, db2, dw1, colsum(du), dw2, colsum(dz))
    if cross:
        dparams = (dg1, db1, dgy, dby, dwq, dbq, dwkv, dbkv) + tail
        dy = to_groups(dy, G).to(x.dtype)
    else:
        dparams = (dg1, db1, dwqkv, dbqkv) + tail
        dy = None
    return to_groups(dx, G).to(x.dtype), dy, dbias, dparams


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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    _check_streams(x, y, bias, mask, dp, cross, ng * G, x.dtype)
    return (ng, nW, N, GC // G) + _check_params(params, bias, GC // G, cross)


def _launch_forward(x, y, params, bias, mask, dp, seed, rates, training,
                    save: bool, cross: bool, G: int):
    ng, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross, G)
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    out = torch.empty_like(x)
    x2r = torch.empty_like(x) if save else None
    bf16 = x.dtype == torch.bfloat16
    build.library().call(
        "fusion_block_bp_forward16" if bf16 else "fusion_block_bp_forward",
        int(cross), x.data_ptr(), _ptr(y),
        build.pointer_array(params), bias.data_ptr(), _ptr(mask),
        out.data_ptr(), ng, G, nW, N, C, H, Ch, _ptr(dp), int(seed),
        float(attn_rate), float(drop_rate), round_up(N, 8), _ptr(x2r),
        build.stream_of(x))
    if bf16:
        (fused_cross_fusion_block_bp16 if cross
         else fused_fusion_block_bp16).launches += 1
    else:
        (fused_cross_fusion_block_bp if cross
         else fused_fusion_block_bp).launches += 1
    return out, x2r


def _backward(g, x, y, params, bias, mask, dp, seed, rates, training, x2r,
              cross: bool, G: int):
    bf16 = x.dtype == torch.bfloat16
    if x.device.type == "cpu":
        plain = (fusion_block_bp_reference_backward16 if bf16
                 else fusion_block_bp_reference_backward)
        return plain(g, x, y, params, bias, mask, dp, seed, rates, training,
                     cross, G)
    ng, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross, G)
    out = launch_backward(
        "fusion_block_bp_backward16" if bf16 else "fusion_block_bp_backward",
        (ng, G, nW), g, x, y, params, bias, mask, dp, seed, rates, training,
        x2r, cross, N, C, H, Ch)
    if bf16:
        (fused_cross_fusion_block_bp_backward16 if cross
         else fused_fusion_block_bp_backward16).launches += 1
    elif cross:
        fused_cross_fusion_block_bp_backward.launches += 1
    else:
        fused_fusion_block_bp_backward.launches += 1
    return out


def fused_fusion_block_bp_backward(g, x, params, bias, mask=None, dp=None,
                                   seed=0, rates=(0.0, 0.0), training=False,
                                   x2r=None, group=None):
    """K7 self backward: (dx, dbias, dparams). CUDA tensors launch the
    kernel (x2r from the CUDA forward); CPU tensors take the plain
    backward."""
    dx, _, dbias, dparams = _backward(g, x, None, params, bias, mask, dp,
                                      seed, rates, training, x2r, False,
                                      _group(x, dp, group))
    return dx, dbias, dparams


def fused_cross_fusion_block_bp_backward(g, x, y, params, bias, mask=None,
                                         dp=None, seed=0, rates=(0.0, 0.0),
                                         training=False, x2r=None,
                                         group=None):
    """K7 cross backward: (dx, dy, dbias, dparams), dispatching as the self
    backward."""
    return _backward(g, x, y, params, bias, mask, dp, seed, rates, training,
                     x2r, True, _group(x, dp, group))


class _FusionBlockBpFunction(torch.autograd.Function):
    """Forward and backward of one group-major block; CUDA kernels on CUDA
    tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, y, bias, mask, dp, seed, rates, training, save,
                cross, G, *params):
        if x.device.type == "cpu":
            if x.dtype == torch.bfloat16:
                out = fusion_block_bp_reference16(
                    x, params, bias, mask, dp, seed, rates, training, y, G)[0]
            else:
                out = _bp_reference(x, y, params, bias, mask, dp, seed,
                                    rates, training, cross, G)
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


def fused_fusion_block_bp16(x, params, bias, mask=None, dp=None, seed=0,
                            rates=(0.0, 0.0), training=False, group=None):
    """:func:`fused_fusion_block_bp` on bf16 streams; its ``launches`` count
    the bf16 form's forward launches."""
    return fused_fusion_block_bp(x.to(torch.bfloat16), params, bias, mask, dp,
                                 seed, rates, training, group)


def fused_cross_fusion_block_bp16(x, y, params, bias, mask=None, dp=None,
                                  seed=0, rates=(0.0, 0.0), training=False,
                                  group=None):
    """:func:`fused_cross_fusion_block_bp` on bf16 streams (launch count as
    :func:`fused_fusion_block_bp16`)."""
    return fused_cross_fusion_block_bp(
        x.to(torch.bfloat16), y.to(torch.bfloat16), params, bias, mask, dp,
        seed, rates, training, group)


def fused_fusion_block_bp_backward16(g, x, params, bias, mask=None, dp=None,
                                     seed=0, rates=(0.0, 0.0), training=False,
                                     x2r=None, group=None):
    """:func:`fused_fusion_block_bp_backward` of the bf16 form (bf16 g, x,
    x2r); its ``launches`` count the bf16 backward's launches."""
    return fused_fusion_block_bp_backward(g, x, params, bias, mask, dp, seed,
                                          rates, training, x2r, group)


def fused_cross_fusion_block_bp_backward16(g, x, y, params, bias, mask=None,
                                           dp=None, seed=0, rates=(0.0, 0.0),
                                           training=False, x2r=None,
                                           group=None):
    """:func:`fused_cross_fusion_block_bp_backward` of the bf16 form."""
    return fused_cross_fusion_block_bp_backward(g, x, y, params, bias, mask,
                                                dp, seed, rates, training,
                                                x2r, group)


fused_fusion_block_bp.launches = 0
fused_fusion_block_bp16.launches = 0
fused_cross_fusion_block_bp16.launches = 0
fused_fusion_block_bp_backward16.launches = 0
fused_cross_fusion_block_bp_backward16.launches = 0
fused_cross_fusion_block_bp.launches = 0
fused_fusion_block_bp_backward.launches = 0
fused_cross_fusion_block_bp_backward.launches = 0
