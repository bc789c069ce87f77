"""HCP phase 1 at its default bf16 policy, and the on-device FIR gear,
against the JAX package on the CPU.

* K6's bf16 form (``ops/attention.py``: bf16 q/k/v, float32 arithmetic,
  bf16 out and dq/dk/dv; plain versions on the CPU) against the JAX
  ``fused_attention`` on bf16 inputs in interpret mode, forward and
  ``jax.vjp``, at rate 0 (the JAX kernel's TPU PRNG is stubbed in interpret
  mode); with dropout on, against the float32 form on the same hash mask.
* The BERT layer's K6 route on a bf16 stream, and a tiny ``TransformerNet``
  (T = 641 takes K6) through the train step's bf16 policy (parameters and
  batch cast to bf16, outputs widened, gradients of the float32 masters),
  against the JAX modules on ``_cast_tree``'d parameters and inputs (eager,
  K6 interpreted).
* ``ops/fir.py`` ``fir_bandsplit_batch`` and ``device_preprocess`` against
  the JAX gear for every ``fmri_type`` it serves and against the port's
  host split; the flagship and HCP at their full ``Config`` defaults (bf16,
  ``preprocess="device"``) through ``Predictor`` and a train step.

Tolerances. K6's bf16 form: every element within one bf16 ulp (2^-8
|ref| + 1e-6) of JAX's and at least 99% bit-equal: both compute in float32
and round once, so only a float32 sum that lands on the other side of a
bf16 rounding boundary differs. The layer and the model forward are held
at ``tests/test_torch_bf16.py``'s 2e-3 + 2^-7 |ref| (a bf16 output, two
ulps). Their gradients differ from JAX's by more than that file's 5e-3 of
a component's largest gradient, for one reason that is JAX's: the VJP of a
broadcast bias add in bf16 (``x @ W + b``, ``LayerNorm(..) * g + b``) is
``lax.reduce_sum`` in bf16, which XLA accumulates in bf16, rounding every
addition, where the port (as ``jnp.sum``) sums in float32 and rounds once.
Over the layer's 194 rows (2 x 97) that moves a bias gradient by up to 2%
of itself; measured, the worst error is 0.7% of the layer's largest
gradient: held at 1.5e-2 (the fMRI embedder of test_torch_bf16.py is held
at 3e-2). Through the whole model those steps compound over the depth, as
in the flagship: JAX's own bf16 gradients are 1.5-8.8% of a component's
largest off its float32 ones, and the port's bf16 gradients 1.7-9.1% off
JAX's bf16 ones (measured). The model test holds them at 0.15 (the
flagship's backbone bound in test_torch_bf16.py) and, as the sharper
check, holds the port's bf16 gradients as close to the float32 ones as
JAX's bf16 gradients are, within a factor 1.5 per component. The FIR gear (float64 inside, ops/fir.py) against JAX's
float32 gear: 1e-5 for the raw and low bands; the ultralow band, z-scored
from a residual of small variance, multiplies JAX's float32 rounding (JAX's
own ultralow is 0.5-2.6e-4 off the host split on these series): 5e-4.
Against the host split (float64 scipy): 5e-5, a quarter of the 2e-4 JAX's
tests/test_filters.py holds its own gear to.
"""

import contextlib
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.data import loader as jloader
from multimodal_neuroimage_tpu.models.fmri_nets import (
    TransformerNet as JTransformerNet)
from multimodal_neuroimage_tpu.nn.bert import BertLayer as JBertLayer
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops.fir import (
    fir_bandsplit_batch as jfir_bandsplit_batch)
from multimodal_neuroimage_tpu.train.losses import bce_with_logits as jbce
from multimodal_neuroimage_tpu.train.state import _cast_tree
from multimodal_neuroimage_tpu import config as jconfig
from multimodal_neuroimage_tpu_torch import config as tconfig
from multimodal_neuroimage_tpu_torch import ops
from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
from multimodal_neuroimage_tpu_torch.data import filters as tfilters
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn.bert import BertLayer
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.ops.fir import fir_bandsplit_batch
from multimodal_neuroimage_tpu_torch.train.losses import bce_with_logits
from multimodal_neuroimage_tpu_torch.train.state import (bf16_weights,
                                                         forward_at)
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    bert_layer_state, jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BF16 = torch.bfloat16
ULP = 2.0 ** -8
FWD_ATOL, FWD_RTOL = 2e-3, 2.0 ** -7
GRAD_SHARE = 1.5e-2
MODEL_GRAD_SHARE = 0.15
FIR_ATOL = {"raw": 1e-5, "low": 1e-5, "ultralow": 5e-4}
HOST_ATOL = 5e-5
BANDS = {"raw": "fmri_sequence", "low": "fmri_lowfreq_sequence",
         "ultralow": "fmri_ultralowfreq_sequence"}


def _np(a):
    """A JAX or torch array as float32 numpy."""
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a):
    """numpy -> (JAX bf16 array, the same values as a torch bf16 tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(_np(j).copy()).to(BF16)


def _within_ulp(got, want, msg=""):
    got, want = _np(got), _np(want)
    np.testing.assert_array_less(np.abs(got - want),
                                 ULP * np.abs(want) + 1e-6 + 1e-30,
                                 err_msg=msg)
    equal = float(np.mean(got == want))
    assert equal >= 0.99, (msg, equal)


@pytest.fixture
def k6_interpreted():
    """The JAX package's K6 route on the CPU, interpreted (as
    tests/test_torch_hcp.py ``_jax_k6_interpreted``)."""
    real = jatt.fused_attention
    jatt.set_fused_attention(True)
    jatt.fused_attention = lambda q, k, v, seed, rate: real(
        q, k, v, seed, rate, interpret=True)
    yield
    jatt.fused_attention = real
    jatt.set_fused_attention(None)


# ---- K6's bf16 form ---------------------------------------------------------------

def test_k6_bf16_matches_jax_kernel():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(2, 2, 97, 11)).astype(np.float32)
                  for _ in range(4))
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_bf16(t) for t in
                                              (q * 0.6, k, v, g))
    want, vjp = jax.vjp(lambda q, k, v: jatt.fused_attention(
        q, k, v, jnp.int32(0), 0.0, True), jq, jk, jv)
    assert want.dtype == jnp.bfloat16
    jgrads = vjp(jg)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tatt.fused_attention16.launches = 0
    got = tatt.fused_attention16(*ins)
    assert got.dtype == BF16 and "Mha" in type(got.grad_fn).__name__
    got.backward(tg)
    assert tatt.fused_attention16.launches == 0        # CPU: the plain version
    _within_ulp(got, want, "out")
    for name, a, b in zip("qkv", ins, jgrads):
        assert a.grad.dtype == BF16
        _within_ulp(a.grad, b, f"d{name}")
    # the plain versions alone, as the card's comparisons call them
    _within_ulp(tatt.mha_reference16(tq, tk, tv), want, "plain out")
    for name, a, b in zip("qkv", tatt.mha_reference_backward16(
            tg, tq, tk, tv), jgrads):
        _within_ulp(a, b, f"plain d{name}")


def test_k6_bf16_dropout_is_the_f32_form_on_widened_inputs_rounded():
    """With dropout on, the bf16 form is the float32 form (same hash mask,
    float32 arithmetic) on the widened inputs, rounded once."""
    rng = np.random.default_rng(1)
    tq, tk, tv, tg = (_bf16(rng.normal(size=(2, 2, 97, 11)))[1]
                      for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tatt.fused_attention(*ins, seed=99, rate=0.1)
    out.backward(tg)
    f32 = [t.float().requires_grad_() for t in (tq, tk, tv)]
    want = tatt.fused_attention(*f32, seed=99, rate=0.1)
    want.backward(tg.float())
    assert torch.equal(out, want.to(BF16))
    assert (out - tatt.fused_attention(tq, tk, tv)).abs().max() > 1e-2
    for a, b in zip(ins, f32):
        assert torch.equal(a.grad, b.grad.to(BF16))
    with pytest.raises(TypeError, match="one dtype"):
        tatt.fused_attention(tq, tk.float(), tv)
    with pytest.raises(TypeError, match="bf16"):
        tatt.fused_attention16(tq.float(), tk.float(), tv.float())


def test_k6_bf16_refuses_non_cpu_tensors_it_cannot_launch_on():
    q = torch.zeros(1, 1, 5, 11, device="meta", dtype=BF16)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.fused_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        tatt.fused_attention_backward16(q, q, q, q.float(), q.float(), None)


# ---- the BERT layer's K6 route and TransformerNet at bf16 ------------------------------

def _perturbed_init(module, *args, seed=0, **kw):
    params = jax.jit(lambda key, *a: module.init(key, *a, **kw))(
        jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)


def _grad_shares(got, want, component):
    """max |got - want| of each component's gradients over that
    component's largest |want|."""
    scale, worst = {}, {}
    for name, w in want.items():
        c = component(name)
        scale[c] = max(scale.get(c, 0.0), float(w.abs().max()))
    for name, w in want.items():
        c = component(name)
        err = float((got[name] - w).abs().max())
        worst[c] = max(worst.get(c, 0.0), err / scale[c])
    return worst


def _rounded_grads(module):
    """The step builders' round_grads, per parameter."""
    return {n: p.grad.to(BF16).float() for n, p in module.named_parameters()}


def test_bert_layer_k6_route_bf16_matches_jax(k6_interpreted):
    """The K6 route on a bf16 stream with bf16-valued parameters: the output
    bit for bit, the input gradient and every parameter gradient against
    ``jax.vjp`` of the JAX layer on ``_cast_tree``'d parameters."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 97, 22)).astype(np.float32)
    g = rng.normal(size=(2, 97, 22)).astype(np.float32)
    jmod = JBertLayer(hidden=22, heads=2, intermediate=64)
    params = _perturbed_init(jmod, jnp.asarray(x))
    (jx, tx), (jg, tg) = _bf16(x), _bf16(g)
    want, vjp = jax.vjp(lambda x, p: jmod.apply(
        {"params": _cast_tree(p, jnp.bfloat16)}, x, deterministic=True),
        jx, params)
    jdx, jdp = vjp(jg)
    layer = BertLayer(22, 2, 64).eval()
    layer.load_state_dict(bert_layer_state(params))
    tx = tx.requires_grad_()
    ops.reset_launches()
    with bf16_weights(layer.parameters()):
        got = layer(tx, None)
        assert got.dtype == BF16
        got.backward(tg)
    assert not any(ops.launches().values())
    np.testing.assert_array_equal(_np(got), _np(want))
    dx, jdx = _np(tx.grad), _np(jdx)
    assert np.abs(dx - jdx).max() <= GRAD_SHARE * np.abs(jdx).max()
    want_p = bert_layer_state(jax.tree_util.tree_map(_np, jdp))
    worst = _grad_shares(_rounded_grads(layer), want_p, lambda n: "layer")
    assert worst["layer"] <= GRAD_SHARE, worst


def _tiny_hcp(sequence_length, **change):
    kw = dict(step=1, task="2DBERT", dataset_name="hcp", target="sex",
              transformer_hidden_layers=2, bert_intermediate_size=64,
              sequence_length=sequence_length, batch_size=2)
    kw.update(change)
    return tconfig.Config(**kw).validate()


def _component(name: str) -> str:
    """Gradient components of TransformerNet: each encoder layer, the
    embeddings, the CLS projection, the pooler, the head."""
    parts = name.split(".")
    if "layer" in parts:
        return ".".join(parts[:parts.index("layer") + 2])
    return ".".join(parts[:3 if parts[0] == "transformer" else 1])


def test_transformer_net_bf16_matches_jax_train_step_policy(k6_interpreted):
    """A tiny TransformerNet at T = 641 (the K6 route) at the bf16 policy,
    dropout off: the port's train-step forward (``bf16_weights``,
    ``forward_at``) and gradients of the float32 masters against the JAX
    train step's ``loss_fn`` (``_cast_tree`` of parameters and batch,
    outputs widened) under ``jax.value_and_grad``. Loss = BCE on the head +
    a random projection of the sequence, so that every token's path has a
    gradient. The weights cross by ``jax_params_to_state_dict`` with
    nothing new: the policy rounds the float32 masters at step time."""
    cfg = _tiny_hcp(640, transformer_dropout_rate=0.0)
    assert cfg.compute_dtype == "bfloat16"
    rng = np.random.default_rng(640)
    x = rng.normal(size=(2, 640, 22)).astype(np.float32)
    r = rng.normal(size=(2, 640, 22)).astype(np.float32)
    y = np.asarray([0.0, 1.0], np.float32)
    jmod = JTransformerNet(22, 2, 2, 640, 0.0, 64)
    params = _perturbed_init(jmod, {"fmri_sequence": jnp.asarray(x)})

    def jloss(p):
        out = jmod.apply({"params": _cast_tree(p, jnp.bfloat16)},
                         {"fmri_sequence": jnp.asarray(x, jnp.bfloat16)},
                         deterministic=True)
        out = _cast_tree(out, jnp.float32)
        return (jbce(out["binary_classification"][:, 0], jnp.asarray(y))
                + jnp.mean(out["reconstructed_fmri_sequence"] * r))

    jval, jgrads = jax.value_and_grad(jloss)(params)

    def port(dtype):
        model = create_model(cfg)
        model.load_state_dict(jax_params_to_state_dict(params))
        model.eval()
        with bf16_weights(model.parameters()) if dtype == "bfloat16" \
                else contextlib.nullcontext():
            out = forward_at(model, {"fmri_sequence": torch.from_numpy(x)},
                             dtype)
            loss = (bce_with_logits(out["binary_classification"][:, 0],
                                    torch.from_numpy(y))
                    + (out["reconstructed_fmri_sequence"]
                       * torch.from_numpy(r)).mean())
            loss.backward()
        if dtype == "float32":
            return loss.item(), {n: p.grad for n, p in
                                 model.named_parameters()}
        return loss.item(), _rounded_grads(model)

    loss, got = port("bfloat16")
    np.testing.assert_allclose(loss, float(jval), rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    want = jax_params_to_state_dict(jgrads)
    assert set(want) == set(got)
    worst = _grad_shares(got, want, _component)
    assert len(worst) == 6 and max(worst.values()) <= MODEL_GRAD_SHARE, worst
    f32 = port("float32")[1]
    port_off = _grad_shares(got, f32, _component)
    jax_off = _grad_shares(want, f32, _component)
    for c in port_off:
        assert port_off[c] <= 1.5 * jax_off[c] + 1e-3, (c, port_off, jax_off)


# ---- the on-device FIR gear -----------------------------------------------------

def _toy_series(rng, T, n_roi=84, tr=0.8):
    """A slow (< lb) and a fast (> lb) sinusoid per ROI
    (tests/test_filters.py)."""
    t = np.arange(T) * tr
    return (rng.normal(size=(n_roi, 1)) * np.sin(2 * np.pi * 0.001 * t)
            + rng.normal(size=(n_roi, 1)) * np.sin(2 * np.pi * 0.05 * t))


def _raw_batch(seed, lengths=(350, 361, 356, 352)):
    rng = np.random.default_rng(seed)
    series = [_toy_series(rng, T) for T in lengths]
    items = [{"subject_name": str(i), **tloader.raw_fmri_item({"fmri": y})}
             for i, y in enumerate(series)]
    return tloader.collate(items)[0], series


@pytest.mark.parametrize("global_zscore_raw", [False, True])
def test_fir_bandsplit_matches_jax(global_zscore_raw):
    """Mixed lengths 350-361. With ``global_zscore_raw`` the raw band is
    held against the host split instead: JAX divides its whole-array
    z-score by T, not R * T (ROADMAP F3), and is off by far more."""
    batch, series = _raw_batch(3)
    want = jfir_bandsplit_batch(batch["fmri_raw"], batch["fmri_length"],
                                global_zscore_raw=global_zscore_raw)
    got = fir_bandsplit_batch(torch.from_numpy(batch["fmri_raw"]),
                              torch.from_numpy(batch["fmri_length"]),
                              global_zscore_raw=global_zscore_raw)
    for band, w in want.items():
        assert got[band].shape == (4, 368, 84) and got[band].dtype == \
            torch.float32
        if band == "raw" and global_zscore_raw:
            assert np.abs(_np(w) - _np(got[band])).max() > 1.0
            for i, y in enumerate(series):
                host = tfilters.preprocess_fmri_host(y, "timeseries")
                np.testing.assert_allclose(_np(got[band][i]),
                                           host["fmri_sequence"],
                                           atol=HOST_ATOL)
        else:
            np.testing.assert_allclose(_np(got[band]), _np(w), rtol=0,
                                       atol=FIR_ATOL[band], err_msg=band)


@pytest.mark.parametrize("fmri_type", ["timeseries", "divided_frequency",
                                       "time_domain_low",
                                       "time_domain_ultralow"])
def test_device_preprocess_matches_jax_and_host(fmri_type):
    """The fMRI-only (phase 1/2) device gear for every fmri_type it serves:
    the keys of JAX's ``device_preprocess``, its values (the raw band of
    "timeseries" aside, F3), and the port's host items."""
    cfg = tconfig.Config(dataset_name="fMRI_timeseries",
                         fmri_type=fmri_type).validate()
    assert tloader.device_fmri(cfg)
    rng = np.random.default_rng(len(fmri_type))
    records = [{"subject": f"s{i}", "fmri": _toy_series(rng, T)}
               for i, T in enumerate((350, 361, 355))]
    batch, names = tloader.collate([tloader.item_for(cfg)(r, cfg)
                                    for r in records])
    assert sorted(batch) == ["fmri_length", "fmri_raw"]
    got = tloader.device_preprocess(batch, cfg, "cpu")
    want = jloader.device_preprocess(
        batch, jconfig.Config(dataset_name="fMRI_timeseries",
                              fmri_type=fmri_type).validate())
    assert sorted(got) == sorted(want)
    for key in got:
        if fmri_type != "timeseries":
            band = next(b for b, k in BANDS.items() if k == key) \
                if fmri_type == "divided_frequency" else fmri_type[12:]
            np.testing.assert_allclose(_np(got[key]), _np(want[key]),
                                       rtol=0, atol=FIR_ATOL[band])
    host = dataclasses.replace(cfg, preprocess="host")
    hbatch, hnames = tloader.collate([tloader.item_for(host)(r, host)
                                      for r in records])
    assert names == hnames and sorted(hbatch) == sorted(got)
    for key in got:
        np.testing.assert_allclose(_np(got[key]), hbatch[key],
                                   atol=HOST_ATOL, err_msg=key)


def test_flagship_device_gear_takes_its_three_bands():
    """A flagship batch in the device gear at the default fmri_type
    ("timeseries"): the three divided-frequency bands, as its host item
    has them, where JAX's function returns only ``fmri_sequence`` (F4)."""
    cfg = tconfig.Config(task="FuncStruct",
                         dataset_name="multimodal").validate()
    assert cfg.fmri_type == "timeseries" and tloader.device_fmri(cfg)
    rng = np.random.default_rng(7)
    records = [{"subject": f"s{i}", "fmri": _toy_series(rng, T),
                "struct": rng.normal(size=(84, 84))}
               for i, T in enumerate((351, 360))]
    batch, _ = tloader.collate([tloader.item_for(cfg)(r, cfg)
                                for r in records])
    got = tloader.device_preprocess(batch, cfg, "cpu")
    jgot = jloader.device_preprocess(batch, jconfig.Config(
        task="FuncStruct", dataset_name="multimodal").validate())
    assert sorted(jgot) == ["fmri_sequence", "struct"]
    host = dataclasses.replace(cfg, preprocess="host")
    hbatch, _ = tloader.collate([tloader.item_for(host)(r, host)
                                 for r in records])
    assert sorted(got) == sorted(hbatch)
    for key in got:
        np.testing.assert_allclose(_np(torch.as_tensor(got[key])),
                                   hbatch[key].astype(np.float32),
                                   atol=HOST_ATOL, err_msg=key)


# ---- the flagship and HCP at their full Config defaults --------------------------------

def _tiny_flagship(**change):
    kw = dict(task="FuncStruct", dataset_name="multimodal",
              multimodality_type="cross_attention", target="sex",
              transformer_hidden_layers=1, bert_intermediate_size=32,
              fusion_ex_depths=(1,), fusion_depths=(1,),
              fusion_re_depths=(1,), fusion_ex_heads=(2,),
              fusion_heads=(2,), fusion_re_heads=(2,),
              size_of_model="small", num_heads_2DBert=4,
              intermediate_vec=48, batch_size=2, nEpochs=1)
    kw.update(change)
    return tconfig.Config(**kw).validate()


def test_flagship_at_full_defaults_trains_and_serves(tmp_path):
    """The tiny flagship with compute_dtype and preprocess left at their
    defaults (bf16, device gear): one Trainer epoch and its serving; the
    served scores match a Predictor on the host gear within the bf16
    policy's card-vs-CPU limit (chip_smoke.py LOGIT16)."""
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny_flagship()
    assert (cfg.compute_dtype, cfg.preprocess) == ("bfloat16", "device")
    rng = np.random.default_rng(8)
    records = [{"subject": f"s{i}", "fmri": rng.normal(size=(48, int(
        rng.integers(350, 362)))) + 50.0, "struct": rng.normal(size=(48, 48)),
        "target": float(i % 2)} for i in range(6)]
    trainer = Trainer(cfg, records[:4], records[4:], device="cpu",
                      experiment_folder=str(tmp_path))
    raw, _ = next(trainer.pipeline.epoch("train", to_device=False))
    assert "fmri_raw" in raw
    trainer.training()
    assert np.isfinite(trainer.step_losses).all()
    requests = [{k: r[k] for k in ("subject", "fmri", "struct")}
                for r in records]
    ckpt = save_checkpoint(str(tmp_path / "last.ckpt"),
                           trainer.model.state_dict(), {})
    dev = Predictor(cfg, ckpt, requests, device="cpu").predict()
    host = Predictor(dataclasses.replace(cfg, preprocess="host"), ckpt,
                     requests, device="cpu").predict()
    assert set(dev) == set(host) == {f"s{i}" for i in range(6)}
    for s in dev:
        assert abs(dev[s]["score"] - host[s]["score"]) < 5e-2, s


def test_hcp_at_full_defaults_trains_and_serves(tmp_path, monkeypatch):
    """HCP phase 1 with compute_dtype and preprocess at their defaults:
    one Trainer epoch at T = 1201 on K6's bf16 form (its plain version on
    the CPU), bf16 streams through every layer, served by Predictor."""
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny_hcp(1200, transformer_hidden_layers=1,
                    bert_intermediate_size=32, nEpochs=1)
    assert (cfg.compute_dtype, cfg.preprocess) == ("bfloat16", "device")
    rng = np.random.default_rng(9)
    records = [{"subject": f"h{i}", "fmri": rng.normal(size=(22, int(
        rng.integers(1100, 1201)))), "target": float(i % 2)}
        for i in range(6)]
    trainer = Trainer(cfg, records[:4], records[4:], device="cpu",
                      experiment_folder=str(tmp_path))
    seen = []
    real = tatt._MhaFunction.apply
    monkeypatch.setattr(tatt._MhaFunction, "apply", staticmethod(
        lambda q, *a: seen.append(q.dtype) or real(q, *a)))
    trainer.training()
    monkeypatch.undo()
    assert seen and set(seen) == {BF16}
    assert np.isfinite(trainer.step_losses).all()
    ckpt = save_checkpoint(str(tmp_path / "last.ckpt"),
                           trainer.model.state_dict(), {})
    scores = Predictor(cfg, ckpt,
                       [{k: r[k] for k in ("subject", "fmri")}
                        for r in records[4:]], device="cpu").predict()
    assert set(scores) == {"h4", "h5"}
    assert all(0.0 < s["score"] < 1.0 for s in scores.values())


def test_query_scale_rounds_the_root_to_bf16():
    """JAX's q / jnp.sqrt(jnp.asarray(hd, q.dtype)) divides a bf16 q by
    bf16(sqrt(11)) = 3.3125, not by sqrt(11) = 3.3166."""
    from multimodal_neuroimage_tpu_torch.nn.bert import _rounded
    assert _rounded(math.sqrt(11), BF16) == 3.3125
    assert float(jnp.sqrt(jnp.asarray(11, jnp.bfloat16))) == 3.3125
