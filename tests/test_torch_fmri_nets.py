"""Phase 2's two-channel net, ``TimeProj``, the ``different`` feature map,
the merge loss and the routes, the port against the JAX package on the CPU
(the MulT net: tests/test_torch_crossmodal.py).

* ``TimeProj`` on float32 and bf16 inputs (the bf16 product exactly
  rounded on both sides);
* ``TransformerNetTwoChannels`` at ``concat`` and ``hadamard``, at
  ``feature_map_size='different'`` with ``convolution_ul`` (``TimeProj(128)``
  into an ultralow BERT of 129 positions) and with ``use_merge_loss``
  (``processed_raw``, the merge loss in the objective): logits, the fused
  CLS, the loss and every parameter gradient at rtol 2e-4 / atol 1e-4 in
  float32, dropout off; and at the bf16 policy (JAX's kernels interpreted,
  the batch as device arrays);
* ``FuncStructAdd`` at ``different``: the same at float32;
* ``merge_loss`` with and without a padded tail;
* every ``_lowfreq_variant`` and ``test`` route and every combiner at
  ``different`` builds JAX's class, with JAX's parameter count at the
  defaults (MulT 6,299,177, two channels 17,646,073);
* (the 1 -> 2 -> 4 chain: tests/test_torch_phase2_chain.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combiner_cases as cc
from multimodal_neuroimage_tpu.cli import main as jcli
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.models import fmri_nets as jnets
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.train import losses as jlosses
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models import fmri_nets as tnets
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.train import losses as tlosses
from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_time_proj_matches_jax():
    """(B, T_in, D) -> (B, T_out, D) on float32 and bf16 inputs, the weight
    carried across as the reference's Conv1d ``(T_out, T_in, 1)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 22)).astype(np.float32)
    jmod = jnets.TimeProj(8)
    params = cc.random_params(jmod, x)
    port = tnets.TimeProj(16, 8)
    port.load_state_dict({"weight": jax_import.time_proj_state(
        params, "p")["p.weight"]})
    assert port.weight.shape == (8, 16, 1)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jmod.apply({"params": jax.tree_util.tree_map(
            lambda p: jnp.asarray(p, jdt), params)}, jnp.asarray(x, jdt))
        with torch.no_grad():
            got = port(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        cc.close(got.float(), np.asarray(want.astype(jnp.float32)),
                 f"TimeProj {tdt}", rtol=0 if tdt == torch.bfloat16
                 else cc.RTOL, atol=0 if tdt == torch.bfloat16 else cc.ATOL)


TWO = dict(fmri_multimodality_type="two_channels")
TWO_CHANNEL_BRANCHES = {
    "concat": {},
    "hadamard": dict(concat_method="hadamard"),
    "different_convolution_ul": dict(feature_map_size="different",
                                     feature_map_gen="convolution_ul"),
}


def _merge_step(jmodel, params, batch):
    """JAX's BCE + merge loss under value_and_grad (float32)."""
    def f(p):
        out = jmodel.apply({"params": p},
                           jax.tree_util.tree_map(jnp.asarray, batch))
        return (cc._bce(out["binary_classification"].squeeze(-1),
                        jnp.asarray(batch["target"]))
                + jlosses.merge_loss(out["processed_raw"],
                                     out["embedding_per_ROIs"])), out

    (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return float(loss), out, jax_import.jax_params_to_state_dict(grads)


@pytest.mark.parametrize("branch", list(TWO_CHANNEL_BRANCHES) + ["merge"])
def test_two_channels_matches_jax(branch):
    """One float32 training forward and backward, dropout off: logits, the
    fused CLS, the loss and every parameter gradient at rtol 2e-4 / atol
    1e-4. ``merge``: ``use_merge_loss``, the objective BCE + merge loss on
    both sides (the port's ``active_losses`` and ``compute_losses``)."""
    kw = TWO_CHANNEL_BRANCHES.get(branch, dict(use_merge_loss=True))
    cfg, jmodel, params, port, batch = cc.setup_fmri(**TWO, **kw)
    if branch == "different_convolution_ul":
        assert params["proj_u"]["kernel"].shape == (16, 128)
        assert port.transformer_ultralow.bert.embeddings[
            "position_embeddings"].weight.shape[0] == 129
    if branch == "merge":
        loss, want_out, want = _merge_step(jmodel, params, batch)
        port.train()
        inputs = batch_to_device(batch, "cpu")
        out = port(inputs, torch.Generator().manual_seed(0))
        specs = active_losses(cfg.task, cfg.fine_tune_task,
                              use_merge_loss=True)
        assert set(specs) == {"merge", "binary_classification"}
        total = compute_losses(out, inputs, specs)["total"]
        total.backward()
        got_loss = total.item()
        grads = {n: p.grad for n, p in port.named_parameters()}
        cc.close(out["processed_raw"].detach(), want_out["processed_raw"],
                 "processed_raw")
    else:
        loss, want_out, want = cc.jax_step(jmodel, params, batch)
        got_loss, out, grads = cc.port_step(cfg, port, batch)
    for key in ("binary_classification", "embedding_per_ROIs"):
        cc.close(out[key].detach(), want_out[key], key)
    cc.close(got_loss, loss, "loss")
    assert set(grads) == set(want)
    for name, g in grads.items():
        cc.close(g, want[name], name)


# the two-channel net at the bf16 policy: each gradient within TWO16 of its
# component's largest. Measured on the CPU: transformer_low 0.239,
# transformer_ultralow 0.161, proj_layer 0.045, regression_head 0.023, where
# JAX's own float32 step on the bf16-rounded parameters and batch lands
# 0.286, 0.198, 0.118 and 0.043 from its bf16 step (the BERTs' bf16
# products at random weights, near a logit of 0, where each gradient is
# small)
TWO16 = 0.25


def test_two_channels_bf16_matches_jax():
    """The two-channel net at the bf16 policy (K1's mm16 form on both
    sides, JAX's interpreted, the batch given to JAX as device arrays):
    logits and loss within 3e-2, every gradient within TWO16 of its
    component's largest."""
    cfg, jmodel, params, port, batch = cc.setup_fmri("bfloat16", **TWO)
    loss, want_out, want = cc.jax_step(jmodel, params, batch, bf16=True)
    got_loss, out, grads = cc.port_step(cfg, port, batch, "bfloat16")
    cc.close(out["binary_classification"].detach(),
             want_out["binary_classification"], "logits", cc.LOGIT16,
             cc.LOGIT16)
    cc.close(got_loss, loss, "loss", cc.LOGIT16, cc.LOGIT16)
    assert set(grads) == set(want)
    for name, s in cc.shares(grads, want).items():
        assert s <= TWO16, (name, s)


def test_funcstruct_add_different_matches_jax():
    """``FuncStructAdd`` at ``feature_map_size='different'`` with
    ``convolution_ul`` (TimeProj(128), an ultralow BERT of 129 positions at
    hidden dropout 0.1): logits, the embedding, the loss and every gradient
    at rtol 2e-4 / atol 1e-4 in float32."""
    cc.check_step("add", feature_map_size="different",
                  feature_map_gen="convolution_ul", sequence_length=32)


@pytest.mark.parametrize("valid", [None, [1.0, 1.0, 1.0, 0.0, 0.0]])
def test_merge_loss_matches_jax(valid):
    """All-pairs cosine of the merged and the raw CLS, with and without a
    padded tail (``valid``)."""
    rng = np.random.default_rng(5)
    raw, merged = (rng.normal(size=(5, 22)).astype(np.float32)
                   for _ in range(2))
    v = None if valid is None else np.asarray(valid, np.float32)
    want = jlosses.merge_loss(jnp.asarray(raw), jnp.asarray(merged),
                              valid=None if v is None else jnp.asarray(v))
    got = tlosses.merge_loss(torch.from_numpy(raw), torch.from_numpy(merged),
                             valid=None if v is None else torch.from_numpy(v))
    cc.close(got, want, "merge loss", rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="M10"):
        active_losses("FuncStruct", "binary_classification",
                      use_unet_loss=True)


ROUTES = [
    dict(task="lowfreqBERT"),
    dict(task="lowfreqBERT", **TWO),
    dict(task="lowfreqBERT", dataset_name="hcp", intermediate_vec=22,
         sequence_length=1200, num_heads_2DBert=2, num_heads_mult=2),
    dict(task="test"),
    dict(task="test", dataset_name="hcp", intermediate_vec=22,
         sequence_length=1200, num_heads_2DBert=2, num_heads_mult=2, **TWO),
    dict(task="test", model_weights_path="e/DTI+sMRI_p3/x.ckpt"),
    dict(task="test", fmri_type="timeseries"),
] + [dict(task="FuncStruct", dataset_name=ds, multimodality_type=mt,
          use_unet=unet, use_prs=prs, feature_map_size="different",
          feature_map_gen="convolution_ul", transformer_hidden_layers=1)
     for mt, unet, prs, ds in (
         ("add", False, False, "multimodal"),
         ("add", True, False, "multimodal"),
         ("transfer", False, False, "multimodal"),
         ("cross_attention", False, False, "multimodal"),
         ("cross_attention", True, False, "multimodal"),
         ("cross_attention", True, True, "multimodal_prs"))]


@pytest.mark.parametrize("i", range(len(ROUTES)))
def test_routes_build_jax_classes(i):
    """``create_model`` builds JAX's class on every ``lowfreqBERT`` and
    divided-frequency ``test`` route, and every combiner at
    ``different``."""
    kw = {"fmri_type": "divided_frequency", **ROUTES[i]}
    jcfg = JConfig(**kw).validate()
    assert (type(create_model(Config(**dataclasses.asdict(jcfg)))).__name__
            == type(jcreate(jcfg)).__name__)


def test_phase2_parameter_counts_match_jax():
    """At phase 2's defaults (width 84, 12 heads, 12 levels, T = 368): the
    MulT net has 6,299,177 parameters and the two-channel net 17,646,073
    on both sides (JAX: ``eval_shape`` of its init), every tensor of the
    converted shapes in the port's state dict with its shape."""
    for kw, count in (({}, 6_299_177), (TWO, 17_646_073)):
        jcfg = jcli.config_from_args(["--step", "2", "--fmri_type",
                                      "divided_frequency"])
        jcfg = dataclasses.replace(jcfg, **kw)
        batch = cc.fmri_batch(2, 368, 84)
        shapes = jax.eval_shape(jcreate(jcfg).init, jax.random.PRNGKey(0),
                                batch)["params"]
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)
        state = jax_import.jax_params_to_state_dict(zeros)
        port = create_model(Config(**dataclasses.asdict(jcfg))).state_dict()
        assert {k: v.shape for k, v in state.items()} == {
            k: v.shape for k, v in port.items()}
        assert sum(v.numel() for v in port.values()) == sum(
            int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
                shapes)) == count
