"""K1: one HF post-LN BERT layer, forward and backward.

Counterpart of multimodal_neuroimage_tpu/ops/bert_layer.py
``bert_layer_call``. The CUDA kernels are ``csrc/bert_layer.cu``; the
autograd Function around them runs them on CUDA tensors and
``bert_layer_reference`` (and its autograd) on CPU tensors.

x is ``(B, T, H)``; T needs no padding: keys at positions >= ``t_valid`` are
masked out of attention (the TPU kernel's pad keys). Params are the
16-tuple ``wq bq wk bk wv bv wo bo g1 b1 w1 b1m w2 b2m g2 b2`` with weights
in torch ``(out, in)`` layout and vectors 1-D. Training adds an int32
``seed`` and ``rates`` = (attention, hidden) dropout, whose masks are the JAX
kernel's coordinate hash over its padded rows (TP = round_up(T, 8) a
subject).

The float32 layer's kernels run every dense product (QKV, Wo and the FFN's
two) on TF32 tensor cores in 3xTF32 form (``bert_layer_forward``,
``bert_layer_backward``), the attention on the CUDA cores in float32;
:func:`bert_layer_model_tf32` models the forward's decomposition in plain
PyTorch for the tests (3xTF32 products, the FFN's F slices added in
order). ``_GEMM_SIMT`` runs both on float32 FMAs on the CUDA cores
instead: the precision yardstick.

``mm16=True`` is the layer under the bf16 policy (JAX ``_mm(True)``, forced
by nn/bert.py with a float32 stream): every product rounds both operands to
bf16 and accumulates in float32, the softmax is JAX's packed one (logits
capped at 80, no max subtraction, denominators summed from bf16(e), p = e *
bf16(1 / den)), and the backward rounds where JAX's mm16 backward does
(:func:`bert_layer_reference_backward16`, written out: autograd through the
rounded forward would round elsewhere). Its kernels run every product, the
per-head scores and contexts too, on bf16 tensor cores
(``bert_layer_forward16`` / ``bert_layer_backward16``), in a decomposition
that :func:`bert_layer_model16` and :func:`bert_layer_model_backward16`
model in plain PyTorch for the tests (F-sliced FFN partial sums, GELU(U)
and DU stored as bf16, merged q/k/v products).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_neuroimage_tpu_torch.ops import build, flops, library
from multimodal_neuroimage_tpu_torch.ops.fusion_block import (
    LOGIT_CAP, bf16_round, gelu_grad, layer_norm, ln_bwd, ln_parts, mix_keep,
    round_up)

LN_EPS = 1e-12
N_PARAMS = 16
# K1's float32 products (forward and backward) run in 3xTF32 on the tensor
# cores; True runs them on float32 FMAs on the CUDA cores instead (the
# forward's first kernels, the backward's SIMT GEMM): the precision
# yardstick that the card tests and chip_smoke.py hold the tensor-core
# route against.
_GEMM_SIMT = False
TF32_CHUNK = 32   # F columns a chunk of the forward's FFN kernel


def _rows(B: int, T: int, device) -> torch.Tensor:
    """(B, T, 1) padded dropout row b * TP + t of every token."""
    TP = round_up(T, 8)
    return (torch.arange(B, dtype=torch.int64, device=device)[:, None, None]
            * TP + torch.arange(T, dtype=torch.int64, device=device)[None, :,
                                                                      None])


def bert_layer_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                         heads: int, t_valid: int, seed: int = 0,
                         rates: Tuple[float, float] = (0.0, 0.0),
                         training: bool = False,
                         mm16: bool = False) -> torch.Tensor:
    """Plain PyTorch BERT layer over the same params (``_fwd_parts``);
    ``mm16``: the bf16 policy's form."""
    if mm16:
        return _forward16(x, params, heads, t_valid, seed, rates,
                          training)["out"]
    return _forward_parts(x, params, heads, t_valid, seed, rates, training,
                          torch.matmul)["out"]


def _mm16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a W^T on bf16-rounded operands, float32 sums (W in (out, in))."""
    return bf16_round(a) @ bf16_round(w).t()


def _slice_sum(parts):
    """The partial products added in order, as the kernels' row kernels add
    their F slices."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _forward16(x, params, heads: int, t_valid: int, seed: int, rates,
               training: bool, slices=None) -> dict:
    """The mm16 layer's forward (JAX ``_fwd_parts`` with mm16, packed
    attention), keeping what its backward needs; ``slices``: the FFN's
    second product as that many F-sliced partials added in order (the
    kernels' decomposition, :func:`bert_layer_model16`)."""
    (wq, bq, wk, bk, wv, bv, wo, bo, g1, b1,
     w1, b1m, w2, b2m, g2, b2) = [p.float() for p in params]
    B, T, H = x.shape
    hd = H // heads
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    TP = round_up(T, 8)
    rows = _rows(B, T, x.device)

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    q, k, v = _mm16(x, wq) + bq, _mm16(x, wk) + bk, _mm16(x, wv) + bv
    qs = bf16_round(split(q) * hd ** -0.5)
    s = torch.einsum("bhtd,bhsd->bhts", qs, bf16_round(split(k)))
    s = s.masked_fill(torch.arange(T, device=x.device) >= t_valid, -1e9)
    e = torch.exp(torch.clamp(s, max=LOGIT_CAP))
    den = bf16_round(e).sum(dim=-1, keepdim=True)
    p = e * bf16_round(1.0 / torch.clamp(den, min=1e-38))
    keep = None
    if attn_rate > 0.0:
        cols = (torch.arange(heads, device=x.device)[:, None, None] * TP
                + torch.arange(T, device=x.device))
        keep = mix_keep(rows[:, None], cols, attn_rate, seed, 3)
    pd = p * keep if keep is not None else p
    ctx = torch.einsum("bhts,bhsd->bhtd", bf16_round(pd),
                       bf16_round(split(v)))
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    m0 = m1 = None
    if hidden_rate > 0.0:
        cols = torch.arange(H, device=x.device)
        m0 = mix_keep(rows, cols, hidden_rate, seed, 0)
        m1 = mix_keep(rows, cols, hidden_rate, seed, 1)
    a = _mm16(ctx, wo) + bo
    if m0 is not None:
        a = a * m0
    x1, xh1, r1 = ln_parts(a + x, g1, b1, LN_EPS)
    u = _mm16(x1, w1) + b1m
    gu = F.gelu(u)
    if slices is None:
        z = _mm16(gu, w2) + b2m
    else:
        cols = torch.arange(w2.shape[1]).chunk(slices)
        z = _slice_sum([_mm16(gu[..., c], w2[:, c]) for c in cols]) + b2m
    zd = z * m1 if m1 is not None else z
    out, xh2, r2 = ln_parts(zd + x1, g2, b2, LN_EPS)
    return dict(out=out, q=q, qs=qs, k=k, v=v, p=p, pd=pd, keep=keep,
                ctx=ctx, m0=m0, m1=m1, x1=x1, xh1=xh1, r1=r1, u=u, gu=gu,
                z=z, xh2=xh2, r2=r2)


def bert_layer_reference_backward16(g, x, params, heads: int, t_valid: int,
                                    seed: int = 0, rates=(0.0, 0.0),
                                    training: bool = False):
    """The mm16 layer's plain backward, written out as JAX's mm16 backward
    kernels compute it (``_ffn_bwd_body``, ``_attn_bwd_body`` with mm16):
    every product of bf16-rounded operands, seg = bf16(sum bf16(dp p))
    (``_seg_rows``); returns (dx, dparams), float32."""
    r = _backward16(g, x, params, heads, t_valid, seed, rates, training)
    return r["dx"], r["dparams"]


def bert_layer_model16(x, params, heads: int, t_valid: int, seed: int = 0,
                       rates=(0.0, 0.0), training: bool = False,
                       slices: int = 1) -> torch.Tensor:
    """Plain model of the mm16 forward kernels' decomposition (tests only):
    the FFN's second product as ``slices`` F-sliced partials added in
    order, then the bias (``k16_ffn_fwd_kernel``, then
    ``bert_bias_res_ln_kernel``)."""
    return _forward16(x, params, heads, t_valid, seed, rates, training,
                      slices)["out"]


def bert_layer_model_backward16(g, x, params, heads: int, t_valid: int,
                                seed: int = 0, rates=(0.0, 0.0),
                                training: bool = False,
                                slices: int = 1) -> dict:
    """Plain model of the mm16 backward kernels' decomposition (tests
    only), over :func:`bert_layer_model16`'s forward: GELU(U) and DU stored
    as bf16 (``gu16``, ``du16``) and read back by the dW products; db1 from
    the float32 DU; dx1 = dy2 + the ``slices`` F slices' DU W1 partials
    added in order; one merged product dx = dy1 + [dq dk dv] [Wq; Wk; Wv]
    (K = 3H) and one [dWq; dWk; dWv] = [dq dk dv]^T x. Returns dx, dparams,
    dx1, gu16, du16 and dq, dk, dv (B, T, H)."""
    return _backward16(g, x, params, heads, t_valid, seed, rates, training,
                       slices)


def _backward16(g, x, params, heads, t_valid, seed, rates, training,
                slices=None) -> dict:
    """The mm16 backward: JAX's arithmetic (``slices`` None), or the
    kernels' decomposition of it (``slices`` F slices)."""
    (wq, bq, wk, bk, wv, bv, wo, bo, g1, b1,
     w1, b1m, w2, b2m, g2, b2) = [p.float() for p in params]
    f = _forward16(x, params, heads, t_valid, seed, rates, training, slices)
    B, T, H = x.shape
    hd = H // heads
    bf = bf16_round
    rows = lambda t: t.reshape(-1, t.shape[-1])
    colsum = lambda t: rows(t).sum(dim=0)
    tn = lambda a, b: bf(rows(a)).t() @ bf(rows(b))     # sum_rows a^T b

    # FFN side over the saved pre-LN2 sum
    dy2 = ln_bwd(g, f["xh2"], f["r2"], g2)
    dz = dy2 * f["m1"] if f["m1"] is not None else dy2
    du = (bf(dz) @ bf(w2)) * gelu_grad(f["u"])
    gu16, du16 = bf(f["gu"]), bf(du)
    dw2 = tn(dz, gu16)
    dw1 = tn(du16, f["x1"])
    if slices is None:
        dx1 = dy2 + du16 @ bf(w1)
    else:
        cols = torch.arange(w1.shape[0]).chunk(slices)
        dx1 = dy2 + _slice_sum([du16[..., c] @ bf(w1[c]) for c in cols])
    dg2, db2, db2m = colsum(g * f["xh2"]), colsum(g), colsum(dz)
    db1m = colsum(du)

    # attention side
    dy1 = ln_bwd(dx1, f["xh1"], f["r1"], g1)
    da = dy1 * f["m0"] if f["m0"] is not None else dy1
    dg1, db1, dbo = colsum(dx1 * f["xh1"]), colsum(dx1), colsum(da)
    dwo = tn(da, f["ctx"])
    dctx = (bf(da) @ bf(wo)).reshape(B, T, heads, hd).transpose(1, 2)

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    p, keep = f["p"], f["keep"]
    dpd = torch.einsum("bhtd,bhsd->bhts", bf(dctx), bf(split(f["v"])))
    dv = torch.einsum("bhts,bhtd->bhsd", bf(f["pd"]), bf(dctx))
    dp = dpd * keep if keep is not None else dpd
    seg = bf(bf(dp * p).sum(dim=-1, keepdim=True))
    ds = p * (dp - seg)
    dq = torch.einsum("bhts,bhsd->bhtd", bf(ds),
                      bf(split(f["k"]))) * hd ** -0.5
    dk = torch.einsum("bhts,bhtd->bhsd", bf(ds), f["qs"])
    merge = lambda t: t.transpose(1, 2).reshape(B, T, H)
    dq, dk, dv = merge(dq), merge(dk), merge(dv)
    if slices is None:
        dx = dy1 + bf(dq) @ bf(wq) + bf(dk) @ bf(wk) + bf(dv) @ bf(wv)
        dwqkv = (tn(dq, x), tn(dk, x), tn(dv, x))
    else:
        dqkv = torch.cat([dq, dk, dv], dim=-1)
        dx = dy1 + bf(dqkv) @ bf(torch.cat([wq, wk, wv]))
        dwqkv = tn(dqkv, x).split(H)
    dparams = (dwqkv[0], colsum(dq), dwqkv[1], colsum(dk), dwqkv[2],
               colsum(dv), dwo, dbo, dg1, db1, dw1, db1m, dw2, db2m, dg2,
               db2)
    return dict(dx=dx, dparams=dparams, dx1=dx1, gu16=gu16, du16=du16,
                dq=dq, dk=dk, dv=dv)


def bert_layer_reference_backward(g, x, params, heads: int, t_valid: int,
                                  seed: int = 0, rates=(0.0, 0.0),
                                  training: bool = False):
    """Plain backward: autograd through the plain forward; returns
    (dx, dparams)."""
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_()] + [
            p.detach().requires_grad_() for p in params]
        out = bert_layer_reference(inputs[0], inputs[1:], heads, t_valid,
                                   seed, rates, training)
        grads = torch.autograd.grad(out, inputs, g)
    return grads[0], tuple(grads[1:])


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest,
    ties away from zero, 10 mantissa bits (finite values)."""
    bits = a.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(a: torch.Tensor):
    """(big, small): big = tf32(a), small = tf32(a - big), the split of
    every operand of K1 backward's 3xTF32 products."""
    big = tf32_round(a)
    return big, tf32_round(a - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the arithmetic of K1 backward's tensor-core GEMM, in plain
    PyTorch (tests only): (small_a big_b + big_a small_b) + big_a big_b,
    each a float32 product of TF32 values (exact) summed in float32."""
    a_big, a_small = tf32_split(a)
    b_big, b_small = tf32_split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def ffn_slices(F_: int, slices: int):
    """The F columns of each of ``slices`` slices of the forward FFN kernel
    (``t32_ffn_kernel``): slice s takes chunks [s c // slices, (s + 1) c //
    slices) of the c = F / 32 chunks of 32 columns."""
    chunks = F_ // TF32_CHUNK
    return [torch.arange(s * chunks // slices * TF32_CHUNK,
                         (s + 1) * chunks // slices * TF32_CHUNK)
            for s in range(slices)]


def _forward_parts(x, params, heads: int, t_valid: int, seed: int, rates,
                   training: bool, mm, slices=None) -> dict:
    """The float32 layer's forward with every dense product a W^T through
    ``mm`` (the attention in plain products: e = exp(s - max) keep, its sum
    over the keys dividing the context, as the kernels take the softmax)
    and, with ``slices``, the FFN's second product as that many F-sliced
    partials added in order; returns the output and the residuals the
    backward consumes (``bert_layer_resid_floats``): q, k, v, ctx, a1 (pre
    LN1), x1, a2 (pre LN2), lse (B, heads, T)."""
    (wq, bq, wk, bk, wv, bv, wo, bo, g1, b1,
     w1, b1m, w2, b2m, g2, b2) = params
    B, T, H = x.shape
    hd = H // heads
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    TP = round_up(T, 8)
    rows = _rows(B, T, x.device)
    lin = lambda a, w, b: mm(a.reshape(-1, a.shape[-1]), w.t()).reshape(
        *a.shape[:-1], w.shape[0]) + b

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    q, k, v = lin(x, wq, bq), lin(x, wk, bk), lin(x, wv, bv)
    s = split(q) * hd ** -0.5 @ split(k).transpose(-1, -2)
    s = s.masked_fill(torch.arange(T, device=x.device) >= t_valid, -1e9)
    mx = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - mx)
    den = e.sum(dim=-1, keepdim=True)
    lse = (mx + torch.log(den))[..., 0]
    if attn_rate > 0.0:
        cols = (torch.arange(heads, device=x.device)[:, None, None] * TP
                + torch.arange(T, device=x.device))
        e = e * mix_keep(rows[:, None], cols, attn_rate, seed, 3)
    ctx = e @ split(v) / den
    ctx = ctx.transpose(1, 2).reshape(B, T, H)
    a = lin(ctx, wo, bo)
    if hidden_rate > 0.0:
        a = a * mix_keep(rows, torch.arange(H, device=x.device), hidden_rate,
                         seed, 0)
    a1 = a + x
    x1 = layer_norm(a1, g1, b1, LN_EPS)
    gu = F.gelu(lin(x1, w1, b1m))
    if slices is None:
        z = lin(gu, w2, b2m)
    else:
        z = _slice_sum([lin(gu[..., c], w2[:, c], 0.0)
                        for c in ffn_slices(w2.shape[1], slices)]) + b2m
    if hidden_rate > 0.0:
        z = z * mix_keep(rows, torch.arange(H, device=x.device), hidden_rate,
                         seed, 1)
    a2 = z + x1
    return dict(out=layer_norm(a2, g2, b2, LN_EPS), q=q, k=k, v=v, ctx=ctx,
                a1=a1, x1=x1, a2=a2, lse=lse)


def bert_layer_model_tf32(x, params, heads: int, t_valid: int, seed: int = 0,
                          rates=(0.0, 0.0), training: bool = False,
                          slices: int = 1) -> dict:
    """Plain model of the float32 forward kernels' decomposition (tests
    only): the dense products (QKV, Wo and the FFN's two) in 3xTF32
    (:func:`matmul_3xtf32`), the attention, GELU and both LayerNorms in
    float32,
    the FFN's second product as ``slices`` F-sliced partials
    (:func:`ffn_slices`) added in order, then b2 (``t32_ffn_kernel``, then
    ``bert_bias_res_ln_kernel``). Returns the output and the residuals
    (:func:`_forward_parts`)."""
    return _forward_parts(x, params, heads, t_valid, seed, rates, training,
                          matmul_3xtf32, slices)


def bert_layer_reference_parts(x, params, heads: int, t_valid: int,
                               seed: int = 0, rates=(0.0, 0.0),
                               training: bool = False) -> dict:
    """The plain forward with the residuals a training forward saves
    (:func:`_forward_parts`, plain products): the float32 forward kernels'
    plain version, residuals included, and in float64 their truth."""
    return _forward_parts(x, params, heads, t_valid, seed, rates, training,
                          torch.matmul)


def resid_parts(resid: torch.Tensor, B: int, T: int, H: int,
                heads: int) -> dict:
    """The saved residuals of a training forward (``bert_layer_resid_
    floats``) by name, as :func:`_forward_parts` returns them."""
    MH = B * T * H
    names = ("q", "k", "v", "ctx", "a1", "x1", "a2")
    out = {n: resid[i * MH:(i + 1) * MH].view(B, T, H)
           for i, n in enumerate(names)}
    out["lse"] = resid[7 * MH:].view(B, heads, T)
    return out


def _check(x, params, heads, t_valid):
    B, T, H = x.shape
    F_ = params[10].shape[0]
    build.check_cuda_f32("x", x, (B, T, H))
    if len(params) != N_PARAMS:
        raise ValueError(f"expected {N_PARAMS} params, got {len(params)}")
    shapes = ([(H, H), (H,)] * 4 + [(H,), (H,), (F_, H), (F_,),
                                    (H, F_), (H,), (H,), (H,)])
    for i, (p, s) in enumerate(zip(params, shapes)):
        build.check_cuda_f32(f"params[{i}]", p, s)
    if H > 96 or H % heads or F_ % 32 or not 1 <= t_valid <= T:
        raise ValueError(f"BERT kernel needs H <= 96, heads dividing H, "
                         f"F % 32 == 0 and 1 <= t_valid <= T; got H={H}, "
                         f"heads={heads}, F={F_}, t_valid={t_valid}, T={T}")
    return B, T, H, F_


def _launch_forward(x, params, heads, t_valid, seed, rates, training,
                    save: bool, mm16: bool = False):
    B, T, H, F_ = _check(x, params, heads, t_valid)
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    lib = build.library()
    scratch = torch.empty(lib.value("bert_layer_scratch16_floats", B, T, H,
                                    F_, heads) if mm16 else
                          lib.value("bert_layer_scratch_simt_floats"
                                    if _GEMM_SIMT else
                                    "bert_layer_scratch_floats", B, T, H, F_),
                          dtype=torch.float32, device=x.device)
    resid = (torch.empty(lib.value("bert_layer_resid_floats", B, T, H, heads),
                         dtype=torch.float32, device=x.device)
             if save else None)
    out = torch.empty_like(x)
    entry = ("bert_layer_forward16" if mm16 else "bert_layer_forward_simt"
             if _GEMM_SIMT else "bert_layer_forward")
    lib.call(entry,
             x, build.pointer_array(params),
             scratch.data_ptr(), None if resid is None else resid.data_ptr(),
             out.data_ptr(), B, T, H, F_, heads, t_valid, round_up(T, 8),
             int(seed), float(attn_rate), float(hidden_rate),
             build.stream_of(x))
    (bert_layer_call16 if mm16 else bert_layer_call).launches += 1
    return out, resid


def bert_layer_backward(g, x, params, resid, heads: int, t_valid: int,
                        seed: int = 0, rates=(0.0, 0.0),
                        training: bool = False, mm16: bool = False):
    """K1 backward: (dx, dparams). CUDA tensors launch the kernels
    (``resid`` from the CUDA training forward of the same form); CPU
    tensors take the plain backward."""
    if x.device.type == "cpu":
        plain = (bert_layer_reference_backward16 if mm16
                 else bert_layer_reference_backward)
        return plain(g, x, params, heads, t_valid, seed, rates, training)
    B, T, H, F_ = _check(x, params, heads, t_valid)
    build.check_cuda_f32("g", g, x.shape)
    lib = build.library()
    build.check_cuda_f32("resid", resid, (lib.value(
        "bert_layer_resid_floats", B, T, H, heads),))
    attn_rate, hidden_rate = rates if training else (0.0, 0.0)
    scratch = torch.empty(lib.value("bert_layer_backward16_scratch_floats"
                                    if mm16 else
                                    "bert_layer_backward_scratch_floats",
                                    B, T, H, F_, heads),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dparams = tuple(torch.empty_like(p) for p in params)
    args = (x, resid.data_ptr(), g.data_ptr(),
            build.pointer_array(params), build.pointer_array(dparams),
            dx.data_ptr(), scratch.data_ptr(), B, T, H, F_, heads, t_valid,
            round_up(T, 8), int(seed), float(attn_rate), float(hidden_rate))
    if mm16:
        lib.call("bert_layer_backward16", *args, build.stream_of(x))
        bert_layer_backward16.launches += 1
    else:
        lib.call("bert_layer_backward", *args, int(_GEMM_SIMT),
                 build.stream_of(x))
        bert_layer_backward.launches += 1
    return dx, dparams


def _name(mm16: bool, direction: str = "") -> str:
    """The kernel's name in ``ops.kernels()``."""
    return f"K1 bert_layer{direction}" + (" mm16" if mm16 else "")


def _flops(x, params, backward: bool = False) -> int:
    B, T, H = x.shape
    return flops.bert_layer(B, T, H, params[10].shape[0], backward)


class _BertLayerFunction(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, heads, t_valid, seed, rates, training, save, mm16,
                *params):
        with flops.kernel(_name(mm16), _flops(x, params)):
            if x.device.type == "cpu":
                out = bert_layer_reference(x, params, heads, t_valid, seed,
                                           rates, training, mm16)
                resid = None
            else:
                out, resid = _launch_forward(x, params, heads, t_valid, seed,
                                             rates, training, save, mm16)
        ctx.meta = (heads, t_valid, seed, rates, training, mm16)
        ctx.save_for_backward(x, resid, *params)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, t_valid, seed, rates, training, mm16 = ctx.meta
        x, resid, *params = ctx.saved_tensors
        with flops.kernel(_name(mm16, " backward"),
                          _flops(x, params, backward=True)):
            dx, dparams = bert_layer_backward(g.contiguous(), x, params,
                                              resid, heads, t_valid, seed,
                                              rates, training, mm16)
        return (dx, None, None, None, None, None, None, None, *dparams)


def bert_layer_call(x: torch.Tensor, params: Sequence[torch.Tensor],
                    heads: int, t_valid: int, seed: int = 0,
                    rates: Tuple[float, float] = (0.0, 0.0),
                    training: bool = False,
                    mm16: bool = False) -> torch.Tensor:
    """One BERT layer (differentiable): the CUDA kernels on a CUDA tensor,
    the plain version on a CPU tensor. x and the parameters are float32 in
    either form (under the bf16 policy the parameters hold bf16 values).
    At inference in a ``torch.export`` trace: the registered op
    (ops/library.py)."""
    if not training and torch.compiler.is_exporting():
        return library.in_trace("bert_layer", x, list(params), heads,
                                t_valid, mm16)
    save = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params))
    return _BertLayerFunction.apply(x, heads, t_valid, int(seed),
                                    tuple(rates), bool(training), save,
                                    bool(mm16), *params)


def bert_layer_call16(x, params, heads, t_valid, seed=0, rates=(0.0, 0.0),
                      training=False):
    """:func:`bert_layer_call` in the mm16 form; its ``launches`` count the
    mm16 forward kernels' launches."""
    return bert_layer_call(x, params, heads, t_valid, seed, rates, training,
                           True)


def bert_layer_backward16(g, x, params, resid, heads, t_valid, seed=0,
                          rates=(0.0, 0.0), training=False):
    """:func:`bert_layer_backward` in the mm16 form; its ``launches`` count
    the mm16 backward kernels' launches."""
    return bert_layer_backward(g, x, params, resid, heads, t_valid, seed,
                               rates, training, True)


bert_layer_call.launches = 0
bert_layer_backward.launches = 0
bert_layer_call16.launches = 0
bert_layer_backward16.launches = 0
