"""The arithmetic of K6's bf16 form on tensor cores, on the CPU.

``csrc/mha_attention.cu`` runs the bf16 form (bf16 q, k, v, dO; float32
arithmetic; bf16 outputs) on bf16 ``mma.sync``. q k^T and dO v^T multiply
bf16 values, so their products are exact in float32. p v, p^T dO, ds^T q and
ds k have a float32 operand (p or ds): the kernels split it into bf16 hi =
bf16(x) and lo = bf16(x - hi) and add both halves' products in float32.
``ops/attention.py`` ``mha_reference16_split`` and
``mha_reference_backward16_split`` model that arithmetic; ``pieces=1``
keeps hi alone, as a FlashAttention that rounds p to bf16 does.

Against a float64 truth on the same bf16 inputs and hash masks (the JAX
kernel's arithmetic without rounding), at HCP's (1, 2, 1201, 11) and a
ragged (2, 2, 97, 24), dropout 0 and 0.1:

* the float32 output within 2^-14 max|truth|, which the one-piece model
  misses: the bound tells the two designs apart before any card run;
* dq, dk, dv rounded to bf16 within 2^-8 |truth| + 2^-12 max|truth|: one
  bf16 rounding (up to 2^-8 |x|) and a float32 error below 2^-12 of the
  gradient's largest.

* each gradient's float64 error (as a share of that bound) within 1.25x
  that of the float32 arithmetic of the CUDA-core form (the plain
  ``mha_reference_backward16``), which the one-piece model misses: the
  yardstick the card tests hold the kernels to beside the CUDA-core form.

``tests/test_torch_cuda.py`` holds the kernels on the card to the same
bounds. The model, rounded to bf16, is also held against the JAX
``fused_attention`` on bf16 inputs in interpret mode, as
``tests/test_torch_hcp_bf16.py`` holds the plain version. Inputs are unit
normals from seeded numpy draws, q scaled by 1 / bf16(sqrt(D)) as the layer
scales it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu_torch.ops import attention as att

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OUT_REL = 2.0 ** -14                    # out32 vs float64, of max|truth|
GRAD_RTOL, GRAD_REL = 2.0 ** -8, 2.0 ** -12
SIMT_GRAD_MULT = 1.25                   # vs the float32 form's share
SHAPES = [(1, 2, 1201, 11), (2, 2, 97, 24)]
SEED = 77


def _inputs(shape, seed=7):
    """bf16 q (scaled), k, v, dO from seeded unit normals."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32)) for _ in range(4))
    scale = float(torch.tensor(shape[-1] ** 0.5).to(torch.bfloat16))
    return [t.to(torch.bfloat16) for t in (q / scale, k, v, g)]


def _truth(g, q, k, v, rate):
    """float64 output and (dq, dk, dv) on the bf16 values."""
    g, q, k, v = (t.double() for t in (g, q, k, v))
    return (att.mha_reference(q, k, v, SEED, rate),
            att.mha_reference_backward(g, q, k, v, SEED, rate))


def test_bf16_split_carries_16_bits():
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-6, 6, 4096))
                         .astype(np.float32))
    hi, lo = att.bf16_split(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -16 * x.double().abs()).all()
    assert (rest > 0).any()              # 24 bits do not fit in 16
    # exact where x has at most 16 significant bits (the low 8 of float32's
    # 24 cleared), and lo = 0 where x is a bf16 value
    x16 = (x.view(torch.int32) & ~0xFF).view(torch.float32)
    hi, lo = att.bf16_split(x16)
    assert torch.equal(hi.float() + lo.float(), x16)
    hi, lo = att.bf16_split(x16.to(torch.bfloat16).float())
    assert torch.equal(hi.float(), x16.to(torch.bfloat16).float())
    assert not lo.float().any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_forward_within_2_14_of_float64(shape, rate):
    q, k, v, g = _inputs(shape)
    truth, _ = _truth(g, q, k, v, rate)
    bound = OUT_REL * truth.abs().max().item()
    errs = {pieces: (att.mha_reference16_split(q, k, v, SEED, rate, pieces)
                     .double() - truth).abs().max().item()
            for pieces in (1, 2)}
    assert errs[2] <= bound, (errs, bound)
    assert errs[1] > bound, (errs, bound)     # bf16 p alone misses it


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_within_bound_of_float64(shape, rate):
    q, k, v, g = _inputs(shape)
    _, truth = _truth(g, q, k, v, rate)
    got = att.mha_reference_backward16_split(g, q, k, v, SEED, rate)
    for name, a, b in zip("qkv", got, truth):
        assert a.dtype == torch.float32
        err = (a.to(torch.bfloat16).double() - b).abs()
        bound = GRAD_RTOL * b.abs() + GRAD_REL * b.abs().max()
        assert (err <= bound).all(), (name, (err / bound).max().item())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_backward_within_multiple_of_float32_form(shape, rate):
    q, k, v, g = _inputs(shape)
    _, truth = _truth(g, q, k, v, rate)

    def shares(grads):
        return [((a.to(torch.bfloat16).double() - b).abs()
                 / (GRAD_RTOL * b.abs() + GRAD_REL * b.abs().max()))
                .max().item() for a, b in zip(grads, truth)]
    f32 = shares(att.mha_reference_backward16(g, q, k, v, SEED, rate))
    two, one = (shares(att.mha_reference_backward16_split(
        g, q, k, v, SEED, rate, pieces)) for pieces in (2, 1))
    assert all(a <= SIMT_GRAD_MULT * b for a, b in zip(two, f32)), (two, f32)
    # bf16 p and ds alone miss it
    assert any(a > SIMT_GRAD_MULT * b for a, b in zip(one, f32)), (one, f32)


def test_split_model_matches_jax_kernel_bf16():
    """The model rounded to bf16 against the JAX kernel on bf16 inputs
    (interpret mode, rate 0: its TPU PRNG is stubbed there): at least 99%
    bit-equal, and every element within one bf16 ulp of JAX's plus 2^-12 of
    the tensor's max-abs (2^-7 |ref| + 2^-12 max|ref|). Both round float32
    values that differ in their last bits, so a value near a rounding
    midpoint lands one ulp (up to 2^-7 |x|) apart; a value that cancels to
    a small one carries both sides' float32 error, which is relative to the
    largest terms, not to it."""
    q, k, v, g = _inputs((2, 2, 97, 11), seed=11)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                      for t in (q, k, v, g))
    want, vjp = jax.vjp(lambda q, k, v: jatt.fused_attention(
        q, k, v, jnp.int32(0), 0.0, True), jq, jk, jv)
    got = [att.mha_reference16_split(q, k, v)] + list(
        att.mha_reference_backward16_split(g, q, k, v))
    for name, a, b in zip(("out", "dq", "dk", "dv"), got,
                          [want] + list(vjp(jg))):
        a = a.to(torch.bfloat16).float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        np.testing.assert_array_less(
            np.abs(a - b), 2.0 ** -7 * np.abs(b)
            + GRAD_REL * np.abs(b).max(), err_msg=name)
        assert float(np.mean(a == b)) >= 0.99, name
