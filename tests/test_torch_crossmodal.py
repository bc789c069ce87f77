"""Phase 2's MulT net, the port against the JAX package on the CPU.

* nn/crossmodal.py: the sinusoidal table (even and odd widths), the pad
  probe of ``positional_embedding`` (float32 and bf16 inputs), the future
  mask; ``MultTransformerEncoder`` in self and crossmodal use, with the
  future mask on and off and with ``tgt != src`` both ways, on inputs whose
  zero-padded steps and single zero first features reach the pad probe:
  the output and the gradients of every parameter and input at rtol 2e-4 /
  atol 1e-4 in float32;
* ``TransformerNetCrossAttention`` in every branch JAX has (feature maps
  ``same`` / ``different`` by ``convolution_ul+l`` / ``convolution_ul`` /
  ``no``, the shared ``proj_l``, the ``deconv`` under ``different`` and
  under ``timeseries_and_frequency``, the mixings ``U2L_and_L2U`` with
  ``concat`` and ``hadamard``, ``U2L`` and ``L2U``): logits, the readout,
  the loss and every parameter gradient at rtol 2e-4 / atol 1e-4 in
  float32, dropout off, and the converter filling exactly the port's keys
  (the net at the bf16 policy: tests/test_torch_phase2_chain.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combiner_cases as cc
from multimodal_neuroimage_tpu.nn import crossmodal as jcm
from multimodal_neuroimage_tpu_torch.nn import crossmodal as tcm
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def _close(got, want, msg, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_tables_and_masks_match_jax():
    """The sinusoidal table (even and odd widths), the future mask (square
    and offset both ways), and the pad probe on float32 and bf16 inputs:
    the zero-padded ends and a step whose first feature alone is 0 get the
    zero vector."""
    for n, d in ((17, 22), (9, 7), (185, 44)):
        np.testing.assert_array_equal(tcm.sinusoid_table(n, d),
                                      jcm.sinusoid_table(n, d))
    for tgt, src in ((16, 16), (16, 8), (8, 16)):
        np.testing.assert_array_equal(tcm.future_mask(tgt, src),
                                      jcm.future_mask(tgt, src))
    x = cc.fmri_batch(2, 16, 22)["fmri_lowfreq_sequence"]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jcm.positional_embedding(jnp.asarray(x, jdt))
        got = tcm.positional_embedding(torch.from_numpy(x).to(tdt))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zero = tcm.positional_embedding(torch.from_numpy(x))
    assert not zero[0, :2].any() and not zero[0, -3:].any()
    assert not zero[1, 5].any() and zero[1, 4].any() and zero[0, 2].any()


ENCODER_CASES = {
    "self_mask": (None, True),
    "self_nomask": (None, False),
    "cross_mask": (16, True),
    "cross_shorter_src": (8, True),
    "cross_longer_src_nomask": (24, False),
}


@pytest.mark.parametrize("case", list(ENCODER_CASES))
def test_mult_encoder_matches_jax(case):
    """A 2-layer encoder at width 22, 2 heads, T = 16 queries: the output
    and the gradients of every parameter and input (a random cotangent) at
    rtol 2e-4 / atol 1e-4; the converter fills exactly the port's keys."""
    src, mask = ENCODER_CASES[case]
    E, heads, layers, T = 22, 2, 2, 16
    x = cc.fmri_batch(2, T, E)["fmri_lowfreq_sequence"]
    ins = [x]
    if src is not None:
        y = cc.fmri_batch(2, src, E, seed=1)["fmri_ultralowfreq_sequence"]
        ins += [y, y[:, ::-1].copy()]
    jmod = jcm.MultTransformerEncoder(E, heads, layers, attn_mask=mask)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, ins))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)
    cot = np.random.default_rng(4).normal(size=(2, T, E)).astype(np.float32)

    def f(p, *a):
        return jnp.sum(jmod.apply({"params": p}, *a) * cot)

    want = jmod.apply({"params": params}, *map(jnp.asarray, ins))
    jgrads = jax.grad(f, argnums=tuple(range(len(ins) + 1)))(
        params, *map(jnp.asarray, ins))

    port = tcm.MultTransformerEncoder(E, heads, layers, attn_mask=mask)
    state = jax_import.mult_encoder_state(params)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    port.eval()
    tins = [torch.from_numpy(a).requires_grad_() for a in ins]
    out = port(*tins)
    _close(out.detach(), want, "output")
    (out * torch.from_numpy(cot)).sum().backward()
    wstate = jax_import.mult_encoder_state(jgrads[0])
    for name, p in port.named_parameters():
        _close(p.grad, wstate[name], name)
    for i, t in enumerate(tins):
        _close(t.grad, jgrads[i + 1], f"input {i}")


MULT_BRANCHES = {
    "defaults": {},
    "same_no_hadamard": dict(feature_map_gen="no", concat_method="hadamard"),
    "different_ul_l_U2L": dict(feature_map_size="different", mixing="U2L"),
    "different_ul_L2U": dict(feature_map_size="different",
                             feature_map_gen="convolution_ul", mixing="L2U",
                             attn_dropout_u=0.0),
    "timeseries_and_frequency_nomask": dict(
        fmri_type="timeseries_and_frequency", feature_map_gen="no",
        attn_mask=False),
}


@pytest.mark.parametrize("branch", list(MULT_BRANCHES))
def test_mult_net_matches_jax(branch):
    """One float32 training forward and backward, dropout off: logits, the
    readout (``embedding_per_ROIs``), the loss and every parameter gradient
    at rtol 2e-4 / atol 1e-4 (under ``same`` + ``convolution_ul+l`` the
    one ``proj_l`` maps both bands, its gradient the sum of both uses)."""
    cfg, jmodel, params, port, batch = cc.setup_fmri(
        **MULT_BRANCHES[branch])
    names = set(params)
    if branch == "defaults":
        assert {"proj_l", "trans_mem", "out_layer1"} <= names
        assert not {"proj_u", "deconv"} & names
    if branch.startswith("different") or branch.startswith("time"):
        assert "deconv" in names
    loss, want_out, want = cc.jax_step(jmodel, params, batch)
    got_loss, out, grads = cc.port_step(cfg, port, batch)
    for key in ("binary_classification", "embedding_per_ROIs"):
        _close(out[key].detach(), want_out[key], key)
    _close(got_loss, loss, "loss")
    assert set(grads) == set(want)
    for name, g in grads.items():
        _close(g, want[name], name)
