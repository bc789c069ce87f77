"""The decomposition of K1's mm16 form on tensor cores, on the CPU.

``csrc/bert_layer.cu`` runs the bf16 policy's BERT layer (``mm16``) as
products of bf16 operands on ``mma.sync`` with float32 sums, in another
decomposition than JAX's kernel: the forward's FFN in F slices whose
partial products a row kernel adds in order (GELU(u) never stored); the
backward's FFN row pass storing GELU(U) and DU as bf16 for the dW products,
db1 from the float32 DU, dx1 as F-sliced partials added to dy2 by the LN1
backward; one merged product dx = dy1 + [dq dk dv] [Wq; Wk; Wv] (K = 3H)
and one [dWq; dWk; dWv]. ``ops/bert_layer.py`` ``bert_layer_model16`` and
``bert_layer_model_backward16`` model it in plain PyTorch. Held here:

* the model against JAX's ``bert_layer_call(..., mm16=True,
  interpret=True)`` and its VJP, dropout on, at ``test_torch_bf16.py``'s
  shapes and tolerances (forward 2e-3 + 2e-3 |ref|, gradients 5e-3 of
  their max-abs, the key bias at the key weight's scale);
* dW1, dW2 and dx1 from bf16-stored GELU(U) and DU bit-equal to the plain
  backward's (``bert_layer_reference_backward16``) at its summation order
  (one slice): bf16 storage is the rounding those products apply anyway;
* the F-sliced sums (z, dx1) and the merged products (dx, the q/k/v
  weight gradients) within float32 summation error of the unsplit ones:
  |got - want| <= (n + 2) 2^-24 sum |terms| over the n terms of each sum.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl
from multimodal_neuroimage_tpu_torch.ops.fusion_block import bf16_round

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BT, BH, BHEADS, BF = 37, 28, 4, 64          # hd 7: odd, like the flagship
RATES = (0.25, 0.2)
SEED = 1234567
FWD_RTOL = FWD_ATOL = 2e-3
GRAD_REL = 5e-3
SLICES = 2                                  # BF / 32 chunks, split in two
U32 = 2.0 ** -24                            # float32 unit roundoff


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


def _inputs(seed):
    """bf16-valued parameters (JAX layout), x and g, from seeded numpy."""
    rng = np.random.default_rng(seed)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(BH, BF)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    params = [np.asarray(jnp.asarray(p, jnp.bfloat16).astype(jnp.float32))
              for p in params]
    x = rng.normal(size=(2, BT, BH)).astype(np.float32)
    g = rng.normal(size=(2, BT, BH)).astype(np.float32)
    return params, x, g


def _port(params, x, g):
    return ([_to_port(p) for p in params], torch.from_numpy(x),
            torch.from_numpy(g))


def _close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("t_valid", [BT, 30])
def test_model_matches_jax_vjp(t_valid):
    """The kernels' decomposition (two F slices, bf16-stored GELU(U) and
    DU, merged dx and dWqkv products) against JAX's mm16 kernel in
    interpret mode and its VJP, dropout on at a fixed seed."""
    params, x, g = _inputs(t_valid)
    TP = jbl.round_up(BT, 8)
    pad = ((0, 0), (0, TP - BT), (0, 0))

    def jax_fn(x, p):
        return jbl.bert_layer_call(x, p, SEED, BHEADS, t_valid, RATES, True,
                                   interpret=True, mm16=True)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(np.pad(x, pad)),
                        tuple(jnp.asarray(t) for t in params))
    jdx, jdp = vjp(jnp.asarray(np.pad(g, pad)))

    tp, tx, tg = _port(params, x, g)
    out = tbl.bert_layer_model16(tx, tp, BHEADS, t_valid, SEED, RATES, True,
                                 SLICES)
    got = tbl.bert_layer_model_backward16(tg, tx, tp, BHEADS, t_valid, SEED,
                                          RATES, True, SLICES)
    _close(out, np.asarray(want)[:, :BT], msg="out")
    jdx = np.asarray(jdx)[:, :BT]
    _close(got["dx"], jdx, rtol=0.0,
           atol=GRAD_REL * np.abs(jdx).max() + 1e-6, msg="dx")
    for i, (a, b) in enumerate(zip(got["dparams"], jdp)):
        b = _to_port(b)
        # the key bias's gradient is zero in exact arithmetic: held at the
        # scale of the key weight's gradient (test_torch_bf16.py)
        scale = float(np.abs(np.asarray(jdp[2 if i == 3 else i])).max())
        _close(a, b, rtol=0.0, atol=GRAD_REL * scale + 1e-6,
               msg=f"dparams[{i}]")


@pytest.mark.parametrize("t_valid,training", [(BT, True), (30, False)])
def test_bf16_stored_ffn_is_bit_equal(t_valid, training):
    """GELU(U) and DU stored as bf16 change no result: at the plain
    backward's summation order (one slice) the model's dW1, dW2 and dx1
    are bit-equal to ``bert_layer_reference_backward16``'s, its stored
    tensors are the bf16 roundings of GELU(U) and DU, and db1 sums the
    float32 DU."""
    params, x, g = _inputs(7 + t_valid)
    tp, tx, tg = _port(params, x, g)
    ref = tbl._backward16(tg, tx, tp, BHEADS, t_valid, SEED, RATES, training)
    got = tbl.bert_layer_model_backward16(tg, tx, tp, BHEADS, t_valid, SEED,
                                          RATES, training, slices=1)
    for name, i in (("dW1", 10), ("dW2", 12), ("db1", 11)):
        assert torch.equal(got["dparams"][i], ref["dparams"][i]), name
    assert torch.equal(got["dx1"], ref["dx1"])
    assert torch.equal(got["gu16"], bf16_round(got["gu16"]))
    assert torch.equal(got["du16"], bf16_round(got["du16"]))
    # db1 is not the column sum of the stored bf16 DU
    assert not torch.equal(got["dparams"][11],
                           got["du16"].reshape(-1, BF).sum(dim=0))


@pytest.mark.parametrize("what", ["z", "dx1", "dx", "dwqkv"])
def test_split_and_merged_sums_within_float32_error(what):
    """The kernels' F-sliced sums (forward z, backward dx1) and merged
    products (dx over K = 3H, [dWq; dWk; dWv] in one product) against the
    plain version's unsplit and separate ones on the same inputs: within
    float32 summation error of each sum."""
    params, x, g = _inputs(11)
    tp, tx, tg = _port(params, x, g)
    bf = bf16_round
    if what == "z":
        want = tbl._forward16(tx, tp, BHEADS, BT, SEED, RATES, True)
        got = tbl._forward16(tx, tp, BHEADS, BT, SEED, RATES, True, SLICES)
        terms = bf(want["gu"]).abs() @ bf(tp[12]).abs().t()
        n = BF
        got, want = got["z"], want["z"]
    else:
        ref = tbl._backward16(tg, tx, tp, BHEADS, BT, SEED, RATES, True)
        # dx1 split in F slices; dx and dWqkv merged (one slice, so that
        # both sides multiply the same d{q,k,v})
        got = tbl.bert_layer_model_backward16(
            tg, tx, tp, BHEADS, BT, SEED, RATES, True,
            SLICES if what == "dx1" else 1)
        d = [bf(ref[k]).reshape(-1, BH).abs() for k in ("dq", "dk", "dv")]
        if what == "dx1":
            terms = got["du16"].abs() @ bf(tp[10]).abs()
            n = BF
            got, want = got["dx1"], ref["dx1"]
        elif what == "dx":
            terms = sum(a @ bf(w).abs() for a, w in zip(d, tp[0:6:2]))
            terms = terms.reshape(ref["dx"].shape)
            n = 3 * BH
            got, want = got["dx"], ref["dx"]
        else:
            xa = bf(tx.reshape(-1, BH)).abs()
            terms = torch.cat([a.t() @ xa for a in d])
            n = xa.shape[0]
            got = torch.cat([got["dparams"][i] for i in (0, 2, 4)])
            want = torch.cat([ref["dparams"][i] for i in (0, 2, 4)])
    err = (got - want).abs()
    bound = (n + 2) * U32 * terms
    assert (err <= bound).all(), (what, err.max().item(),
                                  (err / bound).max().item())
