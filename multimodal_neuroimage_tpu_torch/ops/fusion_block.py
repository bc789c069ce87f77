"""K2/K3: the SwinFusion self and cross blocks, forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/fusion_block.py
``fused_fusion_block`` / ``fused_cross_fusion_block``. One CUDA kernel each
way, templated on cross (``csrc/fusion_block.cu``), runs a whole pre-norm
block on several subjects' windows of one window position at a time (the
forward's attention arithmetic: :func:`fusion_block_model`); the autograd
Function around them dispatches on
the device of x: CUDA tensors launch the kernels (or raise), CPU tensors run
``fusion_block_reference`` / ``cross_fusion_block_reference`` and their
autograd (the plain versions).

This module also holds the port's one dropout-mask generator, the JAX
package's coordinate hash (``mix_keep``, ``hash_keep2``, ``hash_keep3``,
``global_keys``): the masks are a pure function of (seed, draw, row, column),
bit for bit those of the JAX kernels in interpret mode, and the same on the
CPU and on the card.

Layout: windows ``(B, nW, N, C)`` with N = ws*ws unpadded (the TPU's
NP = round_up(N, 8) pad is gone, but the dropout coordinates keep it); bias
``(H, N, N)``; mask ``(nW, N, N)`` or None. Params are flat tuples in the JAX
kernels' order, weights in torch ``(out, in)`` layout and vectors 1-D:

  self  (12): g1 b1 wqkv bqkv wp bp g2 b2 w1 b1m w2 b2m
  cross (16): g1 b1 g1y b1y wq bq wkv bkv wp bp g2 b2 w1 b1m w2 b2m

Training adds the DropPath factors ``dp`` (B, 2) of the two residual
branches, an int32 ``seed`` and ``rates`` = (attention, proj/MLP) dropout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.ops import build, flops, library

LN_EPS = 1e-5
# dropout draws of the JAX kernels: 0 proj, 1/2 MLP, 3 attention
DRAW_PROJ, DRAW_MLP1, DRAW_MLP2, DRAW_ATTN = 0, 1, 2, 3
_M32 = 0xFFFFFFFF


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with the exact two-pass variance (the
    JAX package's ``use_fast_variance=False``); nn/common.py's too."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight + bias


# ---- the dropout-mask hash (ops/fusion_block.py:173-203, 290-296) -----------

def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2^32 for int64 u in [0, 2^32), without int64 overflow."""
    return (u * (c & 0xFFFF) + (((u * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix_keep(r: torch.Tensor, c: torch.Tensor, rate: float, seed: int,
             draw: int) -> torch.Tensor:
    """keep/(1-rate) factors (float32) of int64 coordinates r and c
    (broadcast): ``_mix_keep``'s int32 wrapping products and logical shifts,
    computed in int64 masked to 32 bits (torch's >> on int32 is
    arithmetic)."""
    base = ((int(seed) * 0x9E3779B9) ^ ((draw + 1) * 0xCC9E2D51)) & _M32
    u = _mul32(r, 461845907) ^ _mul32(c, 668265261) ^ base
    u = u ^ (u >> 16)
    u = _mul32(u, 0x85EBCA6B)
    u = u ^ (u >> 13)
    u = _mul32(u, 0xC2B2AE35)
    u = u ^ (u >> 16)
    thr = min(int(rate * (2 ** 32)), 2 ** 32 - 1)
    return (u >= thr).to(torch.float32) * float(1.0 / (1.0 - rate))


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def hash_keep2(rows: int, cols: int, rate: float, seed: int, draw: int,
               row0: int = 0, device=None) -> torch.Tensor:
    """(rows, cols) mask over rows row0.. of the global token matrix."""
    return mix_keep(_iota(rows, device)[:, None] + row0,
                    _iota(cols, device)[None, :], rate, seed, draw)


def hash_keep3(windows: int, NP: int, cols: int, rate: float, seed: int,
               draw: int, w0: int = 0, device=None) -> torch.Tensor:
    """(windows, NP, cols) attention mask for global windows w0.. ."""
    w = _iota(windows, device)[:, None, None] + w0
    n = _iota(NP, device)[None, :, None]
    return mix_keep(w * NP + n, _iota(cols, device)[None, None, :], rate,
                    seed, draw)


def global_keys(B: int, nW: int, N: int, NP: int, device=None
                ) -> torch.Tensor:
    """(B, nW, N, 1) global padded row (b * nW + w) * NP + n of every
    window token: the hash coordinates that make the masks the same under
    any chunking, on the TPU grid and on the card."""
    bw = _iota(B * nW, device).reshape(B, nW, 1, 1)
    return bw * NP + _iota(N, device).reshape(1, 1, N, 1)


# ---- plain versions ---------------------------------------------------------

LOGIT_CAP = 80.0   # JAX fusion_block._LOGIT_CAP: the mm16 softmaxes' cap


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even) and widened to float32: the
    operand rounding of the bf16 policy's products (JAX ``mm16``)."""
    return t.to(torch.bfloat16).to(torch.float32)


def gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du of the exact (erf) GELU."""
    return (0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
            + u * torch.exp(-0.5 * u * u) * 0.3989422804014327)


def ln_parts(a: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
             eps: float = LN_EPS):
    """(LN(a), xh, r): two-pass LayerNorm with its normalised rows and
    rsqrt (JAX ``_ln_fwd``)."""
    mu = a.mean(dim=-1, keepdim=True)
    xc = a - mu
    r = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xh = xc * r
    return xh * g + b, xh, r


def ln_bwd(gin: torch.Tensor, xh: torch.Tensor, r: torch.Tensor,
           gamma: torch.Tensor) -> torch.Tensor:
    """dL/d(pre-LN row) from dL/d(LN out) (JAX ``_ln_bwd``)."""
    dxh = gin * gamma
    return r * (dxh - dxh.mean(dim=-1, keepdim=True)
                - xh * (dxh * xh).mean(dim=-1, keepdim=True))


def bias_from_table(table: torch.Tensor, rel_idx: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(H, N, N) relative-position bias gathered from a ((2ws-1)^2, H)
    table (counterpart of ``combined_bias`` / ``packed_bias_from_table``,
    without the TPU's pad columns and head packing)."""
    N = rel_idx.shape[0]
    return table[rel_idx.reshape(-1)].reshape(N, N, heads).permute(
        2, 0, 1).contiguous()


def _attn_reference(q, k, v, bias, mask, heads: int, keep=None):
    B, nW, N, C = q.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, nW, N, heads, hd).transpose(2, 3)

    s = torch.einsum("bwhnd,bwhmd->bwhnm", split(q) * hd ** -0.5,
                     split(k)) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = p * keep
    o = torch.einsum("bwhnm,bwhmd->bwhnd", p, split(v))
    return o.transpose(2, 3).reshape(B, nW, N, C)


LOG2E = 1.4426950408889634
ONLINE_STEP = 4   # keys a step of the kernel's online softmax (FUSION_FWD_KEYS)


def _attn_online(q, k, v, bias, mask, heads: int, keep=None,
                 step: int = ONLINE_STEP):
    """The attention as the CUDA forward computes it in float32 (its plain
    model): scores in base 2 (q times fl(log2(e) / sqrt(hd)), bias + mask
    times log2 e), an online softmax over keys in steps of
    ``step`` (the running max and the sums rescaled once a step, the sum
    taking every probability, the output only the kept ones, each added key
    by key), and the dropout scale applied with 1 / l at the end. ``keep``:
    the dropout factors (0 or 1 / (1 - rate)) of ``_attn_reference``."""
    B, nW, N, C = q.shape
    hd = C // heads

    def split(t):
        return t.reshape(B, nW, N, heads, hd).transpose(2, 3)

    log2e = torch.tensor(LOG2E, dtype=q.dtype)
    qscale = torch.tensor(hd ** -0.5, dtype=q.dtype) * log2e
    bm = bias[None, None] + (0.0 if mask is None else mask[None, :, None])
    s = (torch.einsum("bwhnd,bwhmd->bwhnm", split(q) * qscale, split(k))
         + bm * log2e)
    vh = split(v)
    m = torch.full(s.shape[:-1], torch.finfo(q.dtype).min, dtype=q.dtype)
    l = torch.zeros_like(m)
    o = torch.zeros(s.shape[:-1] + (hd,), dtype=q.dtype)
    for j0 in range(0, N, step):
        mn = torch.maximum(m, s[..., j0:j0 + step].amax(-1))
        corr = torch.exp2(m - mn)
        m, l, o = mn, l * corr, o * corr[..., None]
        for j in range(j0, min(j0 + step, N)):
            p = torch.exp2(s[..., j] - m)
            l = l + p
            if keep is not None:
                p = p * (keep[..., j] != 0)
            o = o + p[..., None] * vh[..., j, None, :]
    # a kept element's factor, 1 / (1 - rate) (0 if every one is dropped)
    scale = 1.0 if keep is None else keep.amax()
    o = o * (scale / l)[..., None]
    return o.transpose(2, 3).reshape(B, nW, N, C)


def std_keys(B: int, nW: int, N: int, NP: int, device=None):
    """Dropout coordinates of the std layout: (rows, column offsets of the
    C-wide, Ch-wide and attention draws). Rows are the global padded rows
    (b * nW + w) * NP + n; no column offset."""
    return global_keys(B, nW, N, NP, device), 0, 0, 0


def _block_reference(x, y, params, bias, mask, dp, seed, rates, training,
                     cross: bool, keys=std_keys, attention=_attn_reference):
    """The whole block as ``_forward_compute`` (:443-519) computes it, on
    (B, nW, N, C) windows; ``keys(B, nW, N, NP, device)`` gives the dropout
    coordinates (:func:`std_keys`; ops/fusion_block_bp.py ``bp_keys``);
    ``attention`` computes the attention (:func:`_attn_online`: the CUDA
    forward's arithmetic)."""
    if cross:
        (g1, b1, g1y, b1y, wq, bq, wkv, bkv,
         wp, bp, g2, b2, w1, b1m, w2, b2m) = params
        q = F.linear(layer_norm(x, g1, b1, LN_EPS), wq, bq)
        k, v = F.linear(layer_norm(y, g1y, b1y, LN_EPS), wkv,
                        bkv).chunk(2, -1)
    else:
        (g1, b1, wqkv, bqkv, wp, bp, g2, b2, w1, b1m, w2, b2m) = params
        q, k, v = F.linear(layer_norm(x, g1, b1, LN_EPS), wqkv,
                           bqkv).chunk(3, dim=-1)
    B, nW, N, C = x.shape
    H = bias.shape[0]
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    NP = round_up(N, 8)
    rows, off_c, off_h, off_a = keys(B, nW, N, NP, x.device)

    def hidden(draw, width, off):
        if drop_rate <= 0.0:
            return 1.0
        return mix_keep(rows, _iota(width, x.device) + off, drop_rate, seed,
                        draw)

    keep = None
    if attn_rate > 0.0:
        cols = _iota(H, x.device)[:, None, None] * NP + _iota(N, x.device)
        off = off_a if isinstance(off_a, int) else off_a[..., None]
        keep = mix_keep(rows[:, :, None], cols + off, attn_rate, seed,
                        DRAW_ATTN)
    o = attention(q, k, v, bias, mask, H, keep)
    dp1, dp2 = ((1.0, 1.0) if dp is None
                else (dp[:, 0].reshape(B, 1, 1, 1), dp[:, 1].reshape(B, 1, 1, 1)))
    x2r = x + dp1 * (F.linear(o, wp, bp) * hidden(DRAW_PROJ, C, off_c))
    u = F.gelu(F.linear(layer_norm(x2r, g2, b2, LN_EPS), w1, b1m))
    z = F.linear(u * hidden(DRAW_MLP1, w1.shape[0], off_h), w2, b2m)
    return x2r + dp2 * (z * hidden(DRAW_MLP2, C, off_c))


def fusion_block_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           dp: Optional[torch.Tensor] = None, seed: int = 0,
                           rates: Tuple[float, float] = (0.0, 0.0),
                           training: bool = False) -> torch.Tensor:
    """Plain PyTorch self block over windows."""
    return _block_reference(x, None, params, bias, mask, dp, seed, rates,
                            training, cross=False)


def cross_fusion_block_reference(x: torch.Tensor, y: torch.Tensor,
                                 params: Sequence[torch.Tensor],
                                 bias: torch.Tensor,
                                 mask: Optional[torch.Tensor] = None,
                                 dp: Optional[torch.Tensor] = None,
                                 seed: int = 0,
                                 rates: Tuple[float, float] = (0.0, 0.0),
                                 training: bool = False) -> torch.Tensor:
    """Plain PyTorch directed cross block: q from LN1(x), k/v from
    LN1_y(y); returns the updated x stream."""
    return _block_reference(x, y, params, bias, mask, dp, seed, rates,
                            training, cross=True)


def fusion_block_model(x: torch.Tensor, y: Optional[torch.Tensor],
                       params: Sequence[torch.Tensor], bias: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       dp: Optional[torch.Tensor] = None, seed: int = 0,
                       rates: Tuple[float, float] = (0.0, 0.0),
                       training: bool = False, cross: bool = False,
                       keys=std_keys) -> torch.Tensor:
    """The block with the CUDA forward's float32 attention arithmetic
    (:func:`_attn_online`), everything else as the plain version: what the
    tests hold against JAX and against float64 where the kernel itself
    cannot run."""
    return _block_reference(x, y, params, bias, mask, dp, seed, rates,
                            training, cross, keys, _attn_online)


def fusion_block_reference_backward(g, x, y, params, bias, mask=None,
                                    dp=None, seed: int = 0,
                                    rates=(0.0, 0.0), training=False,
                                    cross: bool = False):
    """Plain backward: autograd through the plain forward. Returns
    (dx, dy or None, dbias, dparams)."""
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        ys = y.detach().requires_grad_() if cross else None
        bs = bias.detach().requires_grad_()
        ps = [p.detach().requires_grad_() for p in params]
        out = _block_reference(xs, ys, ps, bs, mask, dp, seed, rates,
                               training, cross)
        inputs = [xs] + ([ys] if cross else []) + [bs] + ps
        grads = torch.autograd.grad(out, inputs, g)
    dx, rest = grads[0], list(grads[1:])
    dy = rest.pop(0) if cross else None
    return dx, dy, rest[0], tuple(rest[1:])


# ---- CUDA launches -----------------------------------------------------------

def _check_streams(x, y, bias, mask, dp, cross: bool, B: int,
                   stream=torch.float32) -> None:
    nW, N = x.shape[1], x.shape[2]
    build.check_cuda("x", x, stream, x.shape)
    if cross:
        build.check_cuda("y", y, stream, x.shape)
    build.check_cuda_f32("bias", bias, (bias.shape[0], N, N))
    if mask is not None:
        build.check_cuda_f32("mask", mask, (nW, N, N))
    if dp is not None:
        build.check_cuda_f32("dp", dp, (B, 2))


def _check(x, y, params, bias, mask, dp, cross: bool):
    B, nW, N, C = x.shape
    _check_streams(x, y, bias, mask, dp, cross, B)
    return (B, nW, N, C) + _check_params(params, bias, C, cross)


def _check_params(params, bias, C: int, cross: bool):
    """Validate the 12 (self) or 16 (cross) params at width C; (H, Ch)."""
    H = bias.shape[0]
    Ch = params[-4].shape[0]
    if C % H or C // H > 16:
        raise ValueError(f"fusion block needs C % heads == 0 and head dim "
                         f"<= 16, got C={C}, heads={H}")
    vec, mat = (lambda n: (n,)), (lambda o, i: (o, i))
    qkv = ([vec(C), vec(C), mat(C, C), vec(C), mat(2 * C, C), vec(2 * C)]
           if cross else [mat(3 * C, C), vec(3 * C)])
    shapes = ([vec(C), vec(C)] + qkv
              + [mat(C, C), vec(C), vec(C), vec(C),
                 mat(Ch, C), vec(Ch), mat(C, Ch), vec(C)])
    if len(params) != len(shapes):
        raise ValueError(f"expected {len(shapes)} params, got {len(params)}")
    for i, (p, s) in enumerate(zip(params, shapes)):
        build.check_cuda_f32(f"params[{i}]", p, s)
    return H, Ch


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_forward(x, y, params, bias, mask, dp, seed, rates, training,
                    save: bool, cross: bool):
    B, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross)
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    out = torch.empty_like(x)
    x2r = torch.empty_like(x) if save else None
    build.library().call(
        "fusion_block_forward", int(cross), x, _ptr(y),
        build.pointer_array(params), bias.data_ptr(), _ptr(mask),
        out.data_ptr(), B, nW, N, C, H, Ch, _ptr(dp), int(seed),
        float(attn_rate), float(drop_rate), round_up(N, 8), _ptr(x2r),
        build.stream_of(x))
    (fused_cross_fusion_block if cross else fused_fusion_block).launches += 1
    return out, x2r


def _backward(g, x, y, params, bias, mask, dp, seed, rates, training, x2r,
              cross: bool):
    if x.device.type == "cpu":
        return fusion_block_reference_backward(g, x, y, params, bias, mask,
                                               dp, seed, rates, training,
                                               cross)
    B, nW, N, C, H, Ch = _check(x, y, params, bias, mask, dp, cross)
    return launch_backward("fusion_block_backward", (B, nW), g, x, y, params,
                           bias, mask, dp, seed, rates, training, x2r, cross,
                           N, C, H, Ch)


def launch_backward(entry, dims, g, x, y, params, bias, mask, dp, seed,
                    rates, training, x2r, cross: bool, N, C, H, Ch):
    """Launch fusion-block backward entry point ``entry`` (K2/K3's or K7's,
    shapes already checked); ``dims`` are its stream dimensions. Returns
    (dx, dy or None, dbias, dparams)."""
    build.check_cuda("g", g, x.dtype, x.shape)
    build.check_cuda("x2r", x2r, x.dtype, x.shape)
    attn_rate, drop_rate = rates if training else (0.0, 0.0)
    lib = build.library()
    n_grad = lib.value("fusion_block_grad_floats", int(cross), N, C, H, Ch)
    n_scratch = lib.value(f"{entry}_scratch_floats", int(cross), *dims, N,
                          C, H, Ch)
    if n_scratch < 0:
        raise RuntimeError(f"{entry} kernel cannot be configured on this "
                           f"card (shared memory)")
    dx = torch.empty_like(x)
    dy = torch.empty_like(y) if cross else None
    flat = torch.empty(n_grad, dtype=torch.float32, device=x.device)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    lib.call(entry, int(cross), x, _ptr(y),
             build.pointer_array(params), bias.data_ptr(), _ptr(mask),
             x2r.data_ptr(), g.data_ptr(), dx.data_ptr(), _ptr(dy),
             flat.data_ptr(), scratch.data_ptr(), *dims, N, C, H, Ch,
             _ptr(dp), int(seed), float(attn_rate), float(drop_rate),
             round_up(N, 8), build.stream_of(x))
    dparams, off = [], 0
    for p in params:
        dparams.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    dbias = flat[off:].view(bias.shape)
    return dx, dy, dbias, tuple(dparams)


def forward_occupancy(cross: bool, B: int, nW: int, N: int, C: int, H: int,
                      Ch: int) -> dict:
    """How K2/K3's training forward runs at these shapes on the current
    card: resident blocks an SM, windows in flight a block, subjects a work
    item, shared bytes a block, blocks in the grid."""
    out = (ctypes.c_int * 5)()
    build.library().call("fusion_block_forward_occupancy", int(cross), B, nW,
                         N, C, H, Ch, out)
    return dict(zip(("blocks_per_sm", "windows_per_block", "per_item",
                     "smem_bytes", "grid_blocks"), out))


def backward_occupancy(entry: str, cross: bool, dims, N: int, C: int, H: int,
                       Ch: int) -> dict:
    """How backward entry point ``entry`` runs at these stream dimensions
    (``dims`` as ``launch_backward``'s) on the current card: resident
    blocks an SM, windows in flight a block, shared bytes a block, blocks
    in the grid."""
    out = (ctypes.c_int * 4)()
    build.library().call(f"{entry}_occupancy", int(cross), *dims, N, C, H,
                         Ch, out)
    return dict(zip(("blocks_per_sm", "windows_per_block", "smem_bytes",
                     "grid_blocks"), out))


def fused_fusion_block_backward(g, x, params, bias, mask=None, dp=None,
                                seed=0, rates=(0.0, 0.0), training=False,
                                x2r=None):
    """K2 backward: (dx, dbias, dparams). CUDA tensors launch the kernel
    (x2r from the CUDA forward); CPU tensors take the plain backward."""
    dx, _, dbias, dparams = _backward(g, x, None, params, bias, mask, dp,
                                      seed, rates, training, x2r, False)
    if x.device.type != "cpu":
        fused_fusion_block_backward.launches += 1
    return dx, dbias, dparams


def fused_cross_fusion_block_backward(g, x, y, params, bias, mask=None,
                                      dp=None, seed=0, rates=(0.0, 0.0),
                                      training=False, x2r=None):
    """K3 backward: (dx, dy, dbias, dparams), dispatching as K2's."""
    out = _backward(g, x, y, params, bias, mask, dp, seed, rates, training,
                    x2r, True)
    if x.device.type != "cpu":
        fused_cross_fusion_block_backward.launches += 1
    return out


def _name(cross: bool, direction: str = "") -> str:
    """The kernel's name in ``ops.kernels()``."""
    return ("K3 cross_fusion_block" if cross else "K2 fusion_block") + direction


def _flops(x, params, backward: bool = False) -> int:
    B, nW, N, C = x.shape
    return flops.fusion_block(B, nW, N, C, params[-4].shape[0], backward)


class _FusionBlockFunction(torch.autograd.Function):
    """Forward and backward of one block; CUDA kernels on CUDA tensors, the
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x, y, bias, mask, dp, seed, rates, training, save,
                cross, *params):
        with flops.kernel(_name(cross), _flops(x, params)):
            if x.device.type == "cpu":
                out = _block_reference(x, y, params, bias, mask, dp, seed,
                                       rates, training, cross)
                x2r = None
            else:
                out, x2r = _launch_forward(x, y, params, bias, mask, dp, seed,
                                           rates, training, save, cross)
        ctx.meta = (seed, rates, training, cross)
        ctx.save_for_backward(x, y, bias, mask, dp, x2r, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        seed, rates, training, cross = ctx.meta
        x, y, bias, mask, dp, x2r, *params = ctx.saved_tensors
        g = g.contiguous()
        with flops.kernel(_name(cross, " backward"),
                          _flops(x, params, backward=True)):
            if cross:
                dx, dy, dbias, dparams = fused_cross_fusion_block_backward(
                    g, x, y, params, bias, mask, dp, seed, rates, training,
                    x2r)
            else:
                dx, dbias, dparams = fused_fusion_block_backward(
                    g, x, params, bias, mask, dp, seed, rates, training, x2r)
                dy = None
        return (dx, dy, dbias, None, None, None, None, None, None, None,
                *dparams)


def _apply(x, y, params, bias, mask, dp, seed, rates, training, cross):
    if not training and torch.compiler.is_exporting():
        return library.in_trace("fusion_block", x, y if cross else None,
                                list(params), bias, mask)
    tensors = [x, bias, *params] + ([y] if cross else [])
    save = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    return _FusionBlockFunction.apply(x, y, bias, mask, dp, int(seed),
                                      tuple(rates), bool(training), save,
                                      cross, *params)


def fused_fusion_block(x: torch.Tensor, params: Sequence[torch.Tensor],
                       bias: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       dp: Optional[torch.Tensor] = None, seed: int = 0,
                       rates: Tuple[float, float] = (0.0, 0.0),
                       training: bool = False) -> torch.Tensor:
    """Self block (differentiable): the CUDA kernels on CUDA tensors, the
    plain version on CPU tensors; at inference in a ``torch.export`` trace
    the registered op (ops/library.py)."""
    return _apply(x, None, params, bias, mask, dp, seed, rates, training,
                  False)


def fused_cross_fusion_block(x: torch.Tensor, y: torch.Tensor,
                             params: Sequence[torch.Tensor],
                             bias: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             dp: Optional[torch.Tensor] = None,
                             seed: int = 0,
                             rates: Tuple[float, float] = (0.0, 0.0),
                             training: bool = False) -> torch.Tensor:
    """Directed cross block (q from x, k/v from y; differentiable in both
    streams), dispatching as :func:`fused_fusion_block`."""
    return _apply(x, y, params, bias, mask, dp, seed, rates, training, True)


fused_fusion_block.launches = 0
fused_cross_fusion_block.launches = 0
fused_fusion_block_backward.launches = 0
fused_cross_fusion_block_backward.launches = 0
