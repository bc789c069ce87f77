"""The arithmetic of K6's float32 form on 3xTF32 tensor cores, on the CPU.

``csrc/mha_attention.cu`` runs the float32 form on ``mma.sync.m16n8k8``
TF32: every float32 operand is split into big = tf32(x) and small = tf32(x -
big), and each product accumulates small_a big_b + big_a small_b apart from
big_a big_b (``ops/bert_layer.py`` ``matmul_3xtf32``). The forward and both
backward kernels compute the scores s = q k^T alike, so the backward's p =
exp(s - lse) is the p the forward normalised. ``ops/attention.py``
``mha_reference_3xtf32`` and ``mha_reference_backward_3xtf32`` model that
arithmetic. At HCP's (1, 2, 1201, 11), a ragged (2, 2, 97, 24) and (1, 1, 65,
64), dropout 0 and 0.1:

* the model against the JAX ``fused_attention`` in interpret mode, forward
  and ``jax.vjp``, at rtol 2e-4 / atol 1e-4. With dropout on, the JAX
  kernel's mask draw (``_seed_prng`` and ``_drop_mask``: the TPU's PRNG,
  which interpret mode on the CPU cannot run) is replaced for the test by
  the port's hash of the same coordinates (``ops/fusion_block.py``
  ``_mix_keep``), so both sides drop the same probabilities;
* the model's float64 error (out, dq, dk, dv; max abs) within 4x that of the
  plain float32 version (``mha_reference`` and autograd through it);
* max over (b, h, d) of |sum_j dk_j|, zero in exact arithmetic (sum_j ds_ij
  = 0 for every query), within 2x the plain float32 version's or within
  1e-5 where that is larger: both are float32 rounding noise, and the
  model takes delta from the output (as the kernels do) where the plain
  backward takes it from p itself. A backward that rebuilds p from scores
  taken another way (single-pass TF32) misses that bound by two orders of
  magnitude.

``tests/test_torch_cuda.py`` holds the kernels on the card to the same
bounds against the CUDA-core form. Inputs are unit normals from seeded numpy
draws, q scaled by 1 / sqrt(D) as the layer scales it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu_torch.ops import attention as att
from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
F64_MULT = 4.0                  # float64 error vs the plain float32 version's
SUM_MULT, SUM_FLOOR = 2.0, 1e-5
SHAPES = [(1, 2, 1201, 11), (2, 2, 97, 24), (1, 1, 65, 64)]
SEED = 77


def _inputs(shape, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32)) for _ in range(4))
    return q / shape[-1] ** 0.5, k, v, g


def _hash_drop_mask(shape, dropout_rate):
    """The port's K6 mask for the JAX kernel's grid cell (b, h): row (b H +
    h) T + i, column j, draw MHA_DRAW, seed SEED."""
    T = shape[0]
    row0 = (pl.program_id(0) * pl.num_programs(1) + pl.program_id(1)) * T
    r = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + row0
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return jfb._mix_keep(r, c, dropout_rate, jnp.int32(SEED),
                         att.MHA_DRAW) > 0


@pytest.fixture
def hash_mask(monkeypatch):
    """The JAX kernel drawing its dropout mask from the port's hash."""
    monkeypatch.setattr(jatt, "_seed_prng", lambda seed_ref: None)
    monkeypatch.setattr(jatt, "_drop_mask", _hash_drop_mask)


def _sum_dk(dk):
    """max over (b, h, d) of |sum_j dk_j|, summed in float64."""
    return dk.double().sum(2).abs().max().item()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_matches_jax_kernel(hash_mask, shape, rate):
    q, k, v, g = _inputs(shape)
    want, vjp = jax.vjp(
        lambda q, k, v: jatt.fused_attention(q, k, v, jnp.int32(SEED), rate,
                                             True),
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    got = [att.mha_reference_3xtf32(q, k, v, SEED, rate)] + list(
        att.mha_reference_backward_3xtf32(g, q, k, v, SEED, rate))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          [want] + list(vjp(jnp.asarray(g.numpy())))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_hash_drop_mask_is_the_port_mask(hash_mask):
    """The replacement draw drops what the port's mask drops: with q = k =
    0 and v the identity, out[b, h, i, j] = keep_ij / (1 - rate) / T."""
    B, H, T = 2, 2, 37
    z = jnp.zeros((B, H, T, T), jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(T, dtype=jnp.float32), (B, H, T, T))
    out = jatt.fused_attention(z, z, eye, jnp.int32(SEED), 0.25, True)
    keep = att.mha_keep(B, H, T, SEED, 0.25)
    np.testing.assert_array_equal(np.asarray(out) > 0, keep.numpy() > 0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_float64_error_within_4x_float32(shape, rate):
    q, k, v, g = _inputs(shape)
    d = [t.double() for t in (g, q, k, v)]
    truth = [att.mha_reference(*d[1:], SEED, rate)] + list(
        att.mha_reference_backward(*d, SEED, rate))
    model = [att.mha_reference_3xtf32(q, k, v, SEED, rate)] + list(
        att.mha_reference_backward_3xtf32(g, q, k, v, SEED, rate))
    plain = [att.mha_reference(q, k, v, SEED, rate)] + list(
        att.mha_reference_backward(g, q, k, v, SEED, rate))
    for name, a, b, t in zip(("out", "dq", "dk", "dv"), model, plain, truth):
        e_model = (a.double() - t).abs().max().item()
        e_plain = (b.double() - t).abs().max().item()
        assert e_model <= F64_MULT * e_plain, (name, e_model, e_plain)


def _backward_1xtf32_scores(g, q, k, v, rate):
    """The model's backward with p rebuilt from single-pass TF32 scores (the
    forward's s taken another way): dk."""
    out, _, lse, keep = att._mha_tf32_parts(q, k, v, SEED, rate)
    s = bl.tf32_round(q) @ bl.tf32_round(k).transpose(-1, -2)
    p = torch.exp(s - lse)
    delta = (g * out).sum(-1, keepdim=True)
    dp = bl.matmul_3xtf32(g, v.transpose(-1, -2))
    ds = p * (dp - delta) if keep is None else p * (keep * dp - delta)
    return bl.matmul_3xtf32(ds.transpose(-1, -2), q)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_model_sum_of_dk_within_float32_noise(shape, rate):
    q, k, v, g = _inputs(shape)
    plain = _sum_dk(att.mha_reference_backward(g, q, k, v, SEED, rate)[1])
    model = _sum_dk(att.mha_reference_backward_3xtf32(g, q, k, v, SEED,
                                                      rate)[1])
    bound = max(SUM_MULT * plain, SUM_FLOOR)
    assert model <= bound, (model, plain)
    # scores computed another way in the backward than in the forward
    assert _sum_dk(_backward_1xtf32_scores(g, q, k, v, rate)) > 10 * bound
