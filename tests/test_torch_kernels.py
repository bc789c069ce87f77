"""The port's kernel modules (K1-K4) against the JAX package, on the CPU.

Each case feeds the same numpy-seeded inputs to the JAX kernel, run as the
JAX package's own tests run it (``interpret=True``), to its jnp reference,
and to the port's wrapper, which on a CPU tensor runs its plain PyTorch
version. The port keeps windows unpadded (N) and BERT sequences unpadded
(T); the JAX kernels take the TPU's padded layouts (NP, TP), so the test pads
on the JAX side and compares the valid rows.

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.nn.swin2d import (relative_position_index,
                                                 shift_attn_mask)
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu_torch.nn import swin2d as tswin
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl
from multimodal_neuroimage_tpu_torch.ops import fusion_block as tfb

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _torch_params(jax_params):
    """JAX kernel params (Dense (in, out), rows (1, n)) -> port layout
    (torch (out, in) weights, 1-D vectors)."""
    out = []
    for p in jax_params:
        p = np.asarray(p, np.float32)
        out.append(torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                                    else p.T.copy()))
    return tuple(out)


# ---- K4: window attention ------------------------------------------------------

@pytest.mark.parametrize("N,nW,H,shift_res", [(36, 4, 3, 12), (36, 1, 6, 0),
                                              (9, 1, 12, 0)])
def test_window_attention_matches_jax(N, nW, H, shift_res):
    rng = np.random.default_rng(N + nW + H)
    B, D = 2, 4
    ws = int(np.sqrt(N))
    q = rng.normal(size=(B, nW, H, N, D)).astype(np.float32) * 3
    k = rng.normal(size=(B, nW, H, N, D)).astype(np.float32)
    v = rng.normal(size=(B, nW, H, N, D)).astype(np.float32)
    bias = (16 / (1 + np.exp(-rng.normal(size=(H, N, N))))).astype(np.float32)
    mask = (shift_attn_mask(shift_res, shift_res, ws, ws // 2)
            if shift_res else None)
    got = tatt.fused_window_attention(
        *(torch.from_numpy(t) for t in (q, k, v, bias)),
        None if mask is None else torch.from_numpy(mask))
    want = jatt.fused_window_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(bias),
                                       mask, interpret=True)
    _close(got, want)
    s = np.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    p = np.exp(s - s.max(-1, keepdims=True))
    _close(got, np.einsum("bwhnm,bwhmd->bwhnd", p / p.sum(-1, keepdims=True),
                          v))


# ---- K2/K3: fusion blocks ------------------------------------------------------

B, RES, WS, C, HEADS = 2, 12, 6, 12, 6
N = WS * WS
NP = jfb.round_up(N, 8)
NW = (RES // WS) ** 2


def _fusion_inputs(shift, cross, seed=0):
    rng = np.random.default_rng(seed + 10 * shift + cross)
    shapes = jfb.param_shapes(C, 4 * C, cross)
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    for i in ((0, 2, 10) if cross else (0, 6)):     # LN scales positive
        params[i] = np.abs(params[i]) + 0.5
    x = rng.normal(size=(B, NW, N, C)).astype(np.float32)
    y = rng.normal(size=(B, NW, N, C)).astype(np.float32)
    table = (rng.normal(size=((2 * WS - 1) ** 2, HEADS)) * 0.1).astype(
        np.float32)
    mask = shift_attn_mask(RES, RES, WS, shift)
    return params, x, y, table, mask


def _pad(t):
    return jnp.asarray(np.pad(t, ((0, 0), (0, 0), (0, NP - N), (0, 0))))


def _jax_fusion(params, x, y, table, mask, cross):
    rel = relative_position_index(WS, WS)
    bias_pad = jfb.combined_bias(jnp.asarray(table), WS, HEADS, NP, rel)
    packed = jfb.packed_bias_from_table(jnp.asarray(table), WS, HEADS, NP,
                                        rel)
    maskp = (None if mask is None
             else np.pad(mask, ((0, 0), (0, NP - N), (0, NP - N))))
    dp = jnp.ones((B, 2), jnp.float32)
    p = tuple(jnp.asarray(t) for t in params)
    if cross:
        kern = jfb.fused_cross_fusion_block(_pad(x), _pad(y), p, packed,
                                            maskp, dp, 0, (0.0, 0.0), False,
                                            interpret=True)
        ref = jfb.cross_fusion_block_reference(_pad(x), _pad(y), p, bias_pad,
                                               maskp, dp)
    else:
        kern = jfb.fused_fusion_block(_pad(x), p, packed, maskp, dp, 0,
                                      (0.0, 0.0), False, interpret=True)
        ref = jfb.fusion_block_reference(_pad(x), p, bias_pad, maskp, dp)
    return np.asarray(kern)[:, :, :N], np.asarray(ref)[:, :, :N]


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shift", [0, 3])
def test_fusion_block_matches_jax(shift, cross):
    params, x, y, table, mask = _fusion_inputs(shift, cross)
    bias = tfb.bias_from_table(
        torch.from_numpy(table),
        torch.from_numpy(tswin.relative_position_index(WS, WS)), HEADS)
    tmask = None if mask is None else torch.from_numpy(mask)
    tp = _torch_params(params)
    if cross:
        got = tfb.fused_cross_fusion_block(torch.from_numpy(x),
                                           torch.from_numpy(y), tp, bias,
                                           tmask)
    else:
        got = tfb.fused_fusion_block(torch.from_numpy(x), tp, bias, tmask)
    kern, ref = _jax_fusion(params, x, y, table, mask, cross)
    _close(got, kern)
    _close(got, ref)


# ---- K1: BERT layer ------------------------------------------------------------

BT, BH, BHEADS, BF = 37, 28, 4, 64          # hd 7: odd, like the flagship


def _bert_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(BH, BF)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    x = rng.normal(size=(2, BT, BH)).astype(np.float32)
    return params, x


def test_bert_layer_matches_jax():
    params, x = _bert_inputs()
    TP = jbl.round_up(BT, 8)
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, TP - BT), (0, 0))))
    p = tuple(jnp.asarray(t) for t in params)
    kern = jbl.bert_layer_call(xp, p, 0, BHEADS, BT, (0.0, 0.0), False,
                               interpret=True)
    ref = jbl.bert_layer_reference(xp, p, BHEADS, BT)
    got = tbl.bert_layer_call(torch.from_numpy(x), _torch_params(params),
                              BHEADS, BT)
    _close(got, np.asarray(kern)[:, :BT])
    _close(got, np.asarray(ref)[:, :BT])


def test_bert_layer_masks_pad_keys_like_jax():
    """With a padded input and t_valid < T the port masks pad keys as the
    TPU kernel does: valid rows match the JAX kernel on the padded layout."""
    params, x = _bert_inputs(seed=1)
    TP = jbl.round_up(BT, 8)
    xp = np.pad(x, ((0, 0), (0, TP - BT), (0, 0)))
    kern = jbl.bert_layer_call(jnp.asarray(xp),
                               tuple(jnp.asarray(t) for t in params), 0,
                               BHEADS, BT, (0.0, 0.0), False, interpret=True)
    got = tbl.bert_layer_call(torch.from_numpy(xp), _torch_params(params),
                              BHEADS, BT)
    _close(np.asarray(got)[:, :BT], np.asarray(kern)[:, :BT])


# ---- wrapper contract on the CPU ------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    from multimodal_neuroimage_tpu_torch import ops
    ops.reset_launches()
    params, x, y, table, mask = _fusion_inputs(0, False)
    bias = torch.zeros(HEADS, N, N)
    tfb.fused_fusion_block(torch.from_numpy(x), _torch_params(params), bias)
    assert ops.launches() == {k: 0 for k in ops.kernels()}


def test_non_cpu_non_cuda_tensor_raises():
    """A tensor that is not on the CPU never reaches the plain version: it
    goes to the kernel path, whose checks refuse anything but CUDA."""
    q = torch.zeros(1, 1, 1, 4, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tatt.fused_window_attention(q, q, q, torch.zeros(1, 4, 4,
                                                         device="meta"))
