"""The decomposition of K1's float32 forward on tensor cores, and the order
of K4 backward's bias-gradient sum, on the CPU.

``csrc/bert_layer.cu`` ``bert_layer_forward`` runs the float32 BERT layer's
dense products (QKV, Wo, x1 W1^T, GELU(u) W2^T) on TF32 tensor cores in
3xTF32 form, the FFN's second product as F slices whose partials are added
in order, the attention and both LayerNorms in float32.
``ops/bert_layer.py`` ``bert_layer_model_tf32`` models that decomposition
in plain PyTorch (``matmul_3xtf32``, ``ffn_slices``). Held here:

* the model against JAX's ``_fbl_fwd`` (``interpret=True``) at full and
  short ``t_valid``, dropout off and at 0.1 on the hash masks: the output
  and the residuals JAX saves (x1, ctx, a2), and the port's other saved
  residuals (q, k, v, a1, the log-sum-exp) against the plain forward in
  float64; rtol 2e-4 / atol 1e-4;
* the model, at one, two and three F slices (uneven chunk runs), against a
  float64 forward within the card's float32 bound;
* the 3xTF32 arithmetic at the flagship forward's three product shapes
  within that bound of float64, where single-pass TF32 is not.

``csrc/window_attention.cu``'s one-launch backward sums the bias gradient
over windows in float32 in a fixed order (groups of 16 windows, each in
window order, then the groups in order); ``ops/attention.py``
``window_attention_dbias_sum`` models it. The model stays within 1e-5 of
the max of a float64 backward's dbias, relative to it with no absolute
floor, at unit and at 1e-6 gradient scale, and carries a NaN in the
gradient into the rows of dbias that the float64 backward has NaN in.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu_torch.nn.swin2d import shift_attn_mask
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BT, BH, BHEADS, BF = 37, 28, 4, 96      # hd 7 (odd, like the flagship); 3 chunks
SEED = 7654321
RTOL, ATOL = 2e-4, 1e-4
SLICES = 2                                # chunks 0 | 1, 2: an uneven split


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


def _inputs(seed):
    """float32 parameters (JAX layout) and x from seeded numpy."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(BH, BF)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    x = rng.normal(size=(2, BT, BH)).astype(np.float32)
    return params, x


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("rates", [(0.0, 0.0), (0.1, 0.1)])
@pytest.mark.parametrize("t_valid", [BT, 30])
def test_model_matches_jax_forward(t_valid, rates):
    params, x = _inputs(t_valid + int(10 * rates[0]))
    TP = jbl.round_up(BT, 8)
    out, (_, x1, ctx, a2, _, _) = jbl._fbl_fwd(
        jnp.asarray(np.pad(x, ((0, 0), (0, TP - BT), (0, 0)))),
        tuple(jnp.asarray(t) for t in params), SEED, BHEADS, t_valid, rates,
        True, True, False)
    tp = [_to_port(p) for p in params]
    tx = torch.from_numpy(x)
    got = tbl.bert_layer_model_tf32(tx, tp, BHEADS, t_valid, SEED, rates,
                                    True, SLICES)
    for name, want in (("out", out), ("x1", x1), ("ctx", ctx), ("a2", a2)):
        _close(got[name], np.asarray(want)[:, :BT], name)
    ref = tbl.bert_layer_reference_parts(tx.double(), [t.double() for t in tp],
                                         BHEADS, t_valid, SEED, rates, True)
    for name in ("q", "k", "v", "a1", "lse"):
        _close(got[name], ref[name], name)


@pytest.mark.parametrize("slices", [1, 2, 3])
def test_model_within_float32_bound_of_float64(slices):
    """Every output and residual of the model at ``slices`` F slices within
    1e-4 + 2e-4 |ref| of the float64 forward, dropout on."""
    params, x = _inputs(100 + slices)
    tp = [_to_port(p) for p in params]
    tx = torch.from_numpy(x)
    rates = (0.1, 0.1)
    got = tbl.bert_layer_model_tf32(tx, tp, BHEADS, 33, SEED, rates, True,
                                    slices)
    ref = tbl.bert_layer_reference_parts(tx.double(), [t.double() for t in tp],
                                         BHEADS, 33, SEED, rates, True)
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].dtype == torch.float32
        _close(got[name], ref[name], name)
    cols = tbl.ffn_slices(BF, slices)
    assert torch.equal(torch.cat(cols), torch.arange(BF))
    assert all(len(c) % tbl.TF32_CHUNK == 0 for c in cols)


# (rows, inner, columns) of the flagship forward's products at batch 4:
# q/k/v and Wo (x W^T over H), u = x1 W1^T, z = GELU(u) W2^T
M4, H4, F4 = 4 * 369, 84, 3072
SHAPES = {"qkv": (M4, H4, H4), "u": (M4, H4, F4), "z": (M4, F4, H4)}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_forward_products_keep_float32_accuracy(name):
    rows, inner, cols = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name) + 31)
    a = torch.from_numpy(rng.standard_normal((rows, inner),
                                             dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((inner, cols),
                                             dtype=np.float32))
    ref = a.double() @ b.double()

    def excess(got):
        return ((got.double() - ref).abs()
                - (ATOL + RTOL * ref.abs())).max().item()
    assert excess(tbl.matmul_3xtf32(a, b)) <= 0.0
    assert excess(tbl.tf32_round(a) @ tbl.tf32_round(b)) > 0.0


# the SwinV2 head's three stages: N, resolution, heads, shift
STAGES = ((36, 12, 3, 3), (36, 6, 6, 0), (9, 3, 12, 0))


def _window_ds(B, stage, seed, rate, scale=1.0, nan=False):
    """q, k, v, bias, mask, g (times ``scale``, one entry NaN if ``nan``)
    of one stage and the per-window ds (B, nW, H, N, N) of the backward, in
    plain float32."""
    N, res, heads, shift = stage
    ws = int(np.sqrt(N))
    shape = (B, (res // ws) ** 2, heads, N, 4)
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                  for _ in range(4))
    g = g * scale
    if nan:
        g[-1, 0, 0, 2, 1] = float("nan")
    bias = torch.from_numpy(rng.normal(size=(heads, N, N)).astype(np.float32))
    m = shift_attn_mask(res, res, ws, shift)
    mask = None if m is None else torch.from_numpy(m)
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias
    if mask is not None:
        s = s + mask[None, :, None]
    p = torch.softmax(s, dim=-1)
    keep = (tatt.window_attention_keep(*shape[:4], 5, rate) if rate
            else torch.ones_like(p))
    out = torch.einsum("bwhnm,bwhmd->bwhnd", p * keep, v)
    dp = torch.einsum("bwhnd,bwhmd->bwhnm", g, v) * keep
    ds = p * (dp - (g * out).sum(-1, keepdim=True))
    return (q, k, v, bias, mask, g), ds


def _dbias64(q, k, v, bias, mask, g, rate):
    """dbias of autograd through the plain forward in float64."""
    return tatt.attention_reference_backward(
        *(t.double() for t in (g, q, k, v, bias)),
        None if mask is None else mask.double(), 5, rate)[3]


@pytest.mark.parametrize("scale", [1.0, 1e-6])
@pytest.mark.parametrize("B", [1, 4, 16, 64])
@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_window_attention_dbias_sum(stage, B, scale):
    """K4 backward's bias-gradient sum (float32, groups of 16 windows in
    window order, then the groups in order; batch 64 makes up to 16 groups)
    within 1e-5 of max |dbias| of a float64 backward, at unit and at 1e-6
    gradient scale (dropout 0.1): no absolute floor, so the sum's accuracy
    must not depend on the gradient's size."""
    (q, k, v, bias, mask, g), ds = _window_ds(B, STAGES[stage], stage, 0.1,
                                              scale)
    got = tatt.window_attention_dbias_sum(ds)
    want = _dbias64(q, k, v, bias, mask, g, 0.1)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), (err, want.abs().max())


@pytest.mark.parametrize("stage", range(len(STAGES)))
def test_window_attention_dbias_sum_nan(stage):
    """A NaN in the gradient reaches dbias: the sum's NaN entries are the
    float64 backward's, and the rest agree within 1e-5 of its max."""
    (q, k, v, bias, mask, g), ds = _window_ds(4, STAGES[stage], stage, 0.1,
                                              nan=True)
    got = tatt.window_attention_dbias_sum(ds)
    want = _dbias64(q, k, v, bias, mask, g, 0.1)
    assert want.isnan().any()
    assert torch.equal(got.isnan(), want.isnan())
    fin = ~want.isnan()
    err = (got.double()[fin] - want[fin]).abs().max().item()
    assert err <= 1e-5 * want[fin].abs().max().item()
