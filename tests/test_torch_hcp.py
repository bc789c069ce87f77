"""The port's HCP phase-1 path (``TransformerNet`` on K6) against the JAX
package on the CPU, and the port's own copies of the JAX package's host
modules against the originals.

* K6 (``ops/attention.py`` ``fused_attention``, plain version on the CPU)
  against the JAX ``fused_attention`` in interpret mode at rate 0, forward
  and ``jax.vjp``. With dropout on the two cannot agree on the CPU (the JAX
  kernel's TPU PRNG is stubbed to zeros in interpret mode), so the port's
  dropout is held against a hand-written backward on the same hash mask.
* The BERT layer's K6 route and the whole ``TransformerNet`` (weights
  carried by ``jax_params_to_state_dict``, dropout off) against the JAX
  modules with ``set_fused_attention(True)``: T = 641 takes K6, T = 65 K1.
* ``hcp_item`` against ``ItemLoader.hcp``; one ``Trainer`` epoch on a tiny
  HCP cohort at the default ``preprocess="device"``, served by
  ``Predictor``.
* ``Config`` and ``preprocess_fmri_host`` of the port against the JAX
  package's.

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance).
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu import config as jconfig
from multimodal_neuroimage_tpu.data import filters as jfilters
from multimodal_neuroimage_tpu.models.fmri_nets import (
    TransformerNet as JTransformerNet)
from multimodal_neuroimage_tpu.nn.bert import BertLayer as JBertLayer
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.train.losses import bce_with_logits as jbce
from multimodal_neuroimage_tpu_torch import config as tconfig
from multimodal_neuroimage_tpu_torch.data import filters as tfilters
from multimodal_neuroimage_tpu_torch.data.loader import hcp_item
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn.bert import BertLayer
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.ops.fusion_block import mix_keep
from multimodal_neuroimage_tpu_torch.train.losses import bce_with_logits
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    bert_layer_state, jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


@contextlib.contextmanager
def _jax_k6_interpreted():
    """The JAX package's fused-kernel routes on the CPU: K1 interprets
    itself off the TPU; K6 is routed through ``interpret=True`` as
    tests/test_pallas_attention.py does."""
    real = jatt.fused_attention
    jatt.set_fused_attention(True)
    jatt.fused_attention = lambda q, k, v, seed, rate: real(
        q, k, v, seed, rate, interpret=True)
    try:
        yield
    finally:
        jatt.fused_attention = real
        jatt.set_fused_attention(None)


def _perturbed_init(module, *args, seed=0, **kw):
    params = jax.jit(lambda key, *a: module.init(key, *a, **kw))(
        jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)


# ---- K6 ----------------------------------------------------------------------

def test_k6_matches_jax_kernel():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(2, 2, 97, 11)).astype(np.float32)
                  for _ in range(4))
    q *= 0.6                             # pre-scaled, as the BERT layer does
    want, vjp = jax.vjp(
        lambda q, k, v: jatt.fused_attention(q, k, v, jnp.int32(0), 0.0,
                                             True),
        *(jnp.asarray(t) for t in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    got = tatt.fused_attention(*ins)
    assert "Mha" in type(got.grad_fn).__name__
    got.backward(torch.from_numpy(g))
    _close(got, want, "out")
    for name, a, b in zip("qkv", ins, jgrads):
        _close(a.grad, b, f"d{name}")


def _hand_backward(g, q, k, v, keep):
    """dq, dk, dv of softmax(q k^T) * keep @ v, written out (the JAX
    kernel's backward body, attention.py:83-96)."""
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    dv = (p * keep).transpose(-1, -2) @ g
    gp = keep * (g @ v.transpose(-1, -2))
    ds = p * (gp - (gp * p).sum(-1, keepdim=True))
    return ds @ k, ds.transpose(-1, -2) @ q, dv


def test_k6_dropout_uses_one_hash_mask_forward_and_backward():
    rng = np.random.default_rng(1)
    B, H, T, D = 2, 2, 97, 11
    q, k, v, g = (torch.from_numpy(rng.normal(size=(B, H, T, D)).astype(
        np.float32)) for _ in range(4))
    rate, seed = 0.1, 1234
    keep = mix_keep(torch.arange(B * H * T).reshape(B, H, T, 1),
                    torch.arange(T), rate, seed, tatt.MHA_DRAW)
    kept = (keep > 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.01, kept
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tatt.fused_attention(*ins, seed=seed, rate=rate)
    p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    _close(out, (p * keep) @ v, "out")
    assert (out - tatt.fused_attention(q, k, v)).abs().max() > 1e-2
    assert (out - tatt.fused_attention(q, k, v, seed + 1, rate)).abs().max() \
        > 1e-2
    out.backward(g)
    for name, a, b in zip("qkv", ins, _hand_backward(g, q, k, v, keep)):
        _close(a.grad, b, f"d{name}")
    with pytest.raises(ValueError, match="rate"):
        tatt.fused_attention(q, k, v, 0, 1.0)


def test_k6_refuses_non_cpu_tensors_it_cannot_launch_on():
    """A tensor that is not on the CPU goes to the kernel path, whose
    checks refuse anything but CUDA: there is no quiet plain fallback."""
    q = torch.zeros(1, 1, 5, 11, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tatt.fused_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.fused_attention_backward(q, q, q, q, q, None)


# ---- the BERT layer's long route and TransformerNet ---------------------------------

def test_bert_layer_k6_route_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 97, 22)).astype(np.float32)
    g = rng.normal(size=(2, 97, 22)).astype(np.float32)
    jmod = JBertLayer(hidden=22, heads=2, intermediate=64)
    params = _perturbed_init(jmod, jnp.asarray(x))
    with _jax_k6_interpreted():
        want, vjp = jax.vjp(lambda x: jmod.apply({"params": params}, x,
                                                 deterministic=True),
                            jnp.asarray(x))
        jdx = vjp(jnp.asarray(g))[0]
    layer = BertLayer(22, 2, 64)
    layer.load_state_dict(bert_layer_state(params))
    tx = torch.from_numpy(x).requires_grad_()
    tatt.fused_attention.launches = 0
    got = layer.eval()(tx, None)
    got.backward(torch.from_numpy(g))
    assert tatt.fused_attention.launches == 0     # CPU: the plain version
    _close(got, want, "out")
    _close(tx.grad, jdx, "dx")


def _tiny_hcp(sequence_length, **change):
    kw = dict(step=1, task="2DBERT", dataset_name="hcp", target="sex",
              compute_dtype="float32", transformer_hidden_layers=2,
              bert_intermediate_size=64, sequence_length=sequence_length,
              batch_size=2)
    kw.update(change)
    return tconfig.Config(**kw).validate()


@pytest.mark.parametrize("sequence_length", [640, 64])
def test_transformer_net_matches_jax(sequence_length):
    """T = sequence_length + 1: 641 takes K6 (round_up(641, 8) > 640), 65
    takes K1. Loss = BCE on the head + a random projection of the whole
    sequence output, so that every token's path gets a gradient."""
    cfg = _tiny_hcp(sequence_length, transformer_dropout_rate=0.0)
    assert (cfg.intermediate_vec, cfg.num_heads_2DBert) == (22, 2)
    rng = np.random.default_rng(sequence_length)
    x = rng.normal(size=(2, sequence_length, 22)).astype(np.float32)
    r = rng.normal(size=(2, sequence_length, 22)).astype(np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    jmod = JTransformerNet(22, 2, 2, sequence_length, 0.0, 64)
    params = _perturbed_init(jmod, {"fmri_sequence": jnp.asarray(x)})

    def jloss(p):
        out = jmod.apply({"params": p}, {"fmri_sequence": jnp.asarray(x)},
                         deterministic=True)
        return (jbce(out["binary_classification"][:, 0], jnp.asarray(y))
                + jnp.mean(out["reconstructed_fmri_sequence"] * r))

    with _jax_k6_interpreted():
        jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = create_model(cfg)
    model.load_state_dict(jax_params_to_state_dict(params))
    out = model.eval()({"fmri_sequence": torch.from_numpy(x)})
    loss = (bce_with_logits(out["binary_classification"][:, 0],
                            torch.from_numpy(y))
            + (out["reconstructed_fmri_sequence"]
               * torch.from_numpy(r)).mean())
    loss.backward()
    _close(loss, jval, "loss")
    want = jax_params_to_state_dict(jgrads)
    named = dict(model.named_parameters())
    assert set(want) == set(named)
    for name, p in named.items():
        _close(p.grad, want[name], name)


# ---- host items and the training loop --------------------------------------------

@pytest.mark.parametrize("T", [1200, 1197, 900])
def test_hcp_item_matches_jax_item_loader(T, tmp_path):
    """z-score over the whole array, symmetric zero pad to 1200 (odd pads:
    the front gets pad // 2), time-major float32."""
    from multimodal_neuroimage_tpu.data.datasets import ItemLoader
    from multimodal_neuroimage_tpu.data.index import SubjectRecord
    y = np.random.default_rng(T).normal(size=(22, T)) * 3.0 + 7.0
    np.save(tmp_path / "fmri.npy", y)
    jcfg = jconfig.Config(dataset_name="hcp", step=1).validate()
    want = ItemLoader(jcfg).hcp(SubjectRecord(0, "s", {
        "fmri": str(tmp_path / "fmri.npy")}, 1.0))["fmri_sequence"]
    got = hcp_item({"subject": "s", "fmri": y},
                   tconfig.Config(dataset_name="hcp", step=1).validate())
    assert got["fmri_sequence"].dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got["fmri_sequence"], want)
    pad = 1200 - T
    assert not got["fmri_sequence"][:pad // 2].any()
    assert not got["fmri_sequence"][1200 - (pad - pad // 2):].any()


@pytest.mark.parametrize("fmri_type", ["timeseries", "divided_frequency"])
def test_abcd_fmri_item_matches_jax_item_loader(fmri_type, tmp_path):
    """The ABCD fMRI-only item (phase 1/2, host gear) through ``item_for``
    against ``ItemLoader.fmri_timeseries`` on the same file (the loader
    drops the first 20 TRs; a request carries the series without them)."""
    from multimodal_neuroimage_tpu.data.datasets import (ABCD_SKIP_TR,
                                                         ItemLoader)
    from multimodal_neuroimage_tpu.data.index import SubjectRecord
    from multimodal_neuroimage_tpu_torch.data.loader import item_for
    y = np.random.default_rng(7).normal(size=(84, 360)) + 30.0
    np.save(tmp_path / "fmri.npy", np.concatenate(
        [np.zeros((ABCD_SKIP_TR, 84)), y.T]))
    kw = dict(dataset_name="fMRI_timeseries", fmri_type=fmri_type,
              preprocess="host")
    want = ItemLoader(jconfig.Config(**kw).validate()).fmri_timeseries(
        SubjectRecord(0, "s", {"fmri": str(tmp_path / "fmri.npy")}, 1.0))
    cfg = tconfig.Config(**kw).validate()
    got = item_for(cfg)({"subject": "s", "fmri": y}, cfg)
    keys = sorted(k for k in got if k != "subject_name")
    assert keys and keys == sorted(k for k in want if k.startswith("fmri"))
    for key in keys:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    dti = tconfig.Config(dataset_name="DTI").validate()
    item = item_for(dti)({"subject": "s", "dti": y[:, :84]}, dti)
    assert set(item) == {"subject_name", "dti"}
    assert item["dti"].dtype == np.float16
    with pytest.raises(NotImplementedError, match="N6"):
        item_for(tconfig.Config(dataset_name="fMRI_image").validate())


def test_trainer_runs_an_hcp_epoch_and_serves_it(tmp_path):
    """The default ``preprocess="device"`` is accepted for HCP (its items
    never take the FIR gear); one epoch at T = 1201 runs the K6 route."""
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny_hcp(1200, transformer_hidden_layers=1,
                    bert_intermediate_size=32, nEpochs=1)
    assert cfg.preprocess == "device" and cfg.sequence_length == 1200
    rng = np.random.default_rng(4)
    records = [{"subject": f"s{i}", "fmri": rng.normal(size=(22, int(
        rng.integers(1100, 1201)))), "target": float(i % 2)}
        for i in range(6)]
    trainer = Trainer(cfg, records[:4], records[4:], device="cpu",
                      experiment_folder=str(tmp_path))
    assert type(trainer.model).__name__ == "TransformerNet"
    metrics = trainer.training()
    assert len(trainer.step_losses) == 2
    assert np.isfinite(trainer.step_losses).all() and "val_AUROC" in metrics
    scores = Predictor(cfg, trainer.best_checkpoint(),
                       [{k: r[k] for k in ("subject", "fmri")}
                        for r in records[4:]], device="cpu").predict()
    assert set(scores) == {"s4", "s5"}
    assert all(0.0 < s["score"] < 1.0 for s in scores.values())


# ---- the port's own host modules ------------------------------------------------------

def _defaults(cls):
    return {f.name: (f.default_factory() if f.default_factory
                     is not dataclasses.MISSING else f.default)
            for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("step", sorted(jconfig.PHASE_TASKS))
def test_config_copy_matches_jax(step):
    assert _defaults(tconfig.Config) == _defaults(jconfig.Config)
    assert tconfig.PHASE_TASKS == jconfig.PHASE_TASKS
    assert tconfig.PHASE_DEFAULTS == jconfig.PHASE_DEFAULTS
    for kw in ({}, {"dataset_name": "hcp"},
               {"dataset_name": "hcp", "intermediate_vec": 48,
                "num_heads_2DBert": 5, "base_path": "/data"},
               {"phase_overrides": {step: {"batch_size": 3}}}):
        want = jconfig.config_for_phase(jconfig.Config(**kw), step,
                                        user_set={"lr_init"})
        got = tconfig.config_for_phase(tconfig.Config(**kw), step,
                                       user_set={"lr_init"})
        assert dataclasses.asdict(got) == dataclasses.asdict(want), kw
    with pytest.raises(AssertionError):
        tconfig.Config(intermediate_vec=48, num_heads_2DBert=5).validate()


@pytest.mark.parametrize("fmri_type", [
    "timeseries", "frequency", "divided_frequency", "time_domain_low",
    "time_domain_ultralow", "frequency_domain_low",
    "frequency_domain_ultralow", "timeseries_and_frequency"])
def test_preprocess_fmri_host_copy_matches_jax(fmri_type):
    y = np.random.default_rng(len(fmri_type)).normal(size=(22, 355)) + 40.0
    for kw in ({}, {"filtering_type": "Boxcar"},
               {"feature_map_gen": "resample", "feature_map_size": "different"}):
        want = jfilters.preprocess_fmri_host(y, fmri_type, 368, **kw)
        got = tfilters.preprocess_fmri_host(y, fmri_type, 368, **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{key} {kw}")
