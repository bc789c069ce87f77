"""The port's structural phases against the JAX package on the CPU.

Phase 3 (``VIT``: ``SwinClassifier`` and its VAE and UNet variants on DTI /
sMRI / DTI+sMRI) and phase 6 (``SwinFusion``: ``SwinFusionNet`` on the
sMRI + DTI pair). Each module and each model is initialised in JAX,
perturbed by N(0, 0.05) so that zero-initialised norms hide no block, and
carried into the port by ``jax_params_to_state_dict``; the same numpy
inputs go through both. JAX's K4 and K2/K3 run in interpret mode
(``set_fused_attention(True)``), the port's through their plain versions.

* ``UNet2D`` (base 4 on 84x84, the odd 21x21 skip and the transposed
  convolutions' flip included) forward and input / parameter gradients,
  and one forward of the default base-64 UNet;
* ``MlpVae`` at its full widths (z = mu) forward and gradients;
* ``SwinClassifier`` small and large, forward and gradients, and at
  ``compute_dtype="bfloat16"`` (through ``forward_at``) against JAX's cast
  path; ``SwinFusionNet`` (tiny backbone) at bf16 too, where its fusion
  blocks must see float32 streams on both sides (K2/K3's f32 form);
* whole ``SwinClassifierVAE`` / ``SwinClassifierUNet`` forwards and a tiny
  ``SwinFusionNet`` forward and gradients;
* the converters fill every port parameter at the four models' defaults;
* the structural items and index paths equal JAX's bit for bit, the native
  matrix batches the host items within 2e-3;
* one-epoch ``Trainer`` runs, ``testing()`` and ``run_predict`` of both
  phases from a synthetic cohort on disk.

Tolerance: float32, rtol 2e-4 / atol 1e-4; bf16 as the flagship's
(tests/test_torch_bf16.py): logits 3e-2, gradients 1e-2 of their
component's largest.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.data import datasets as jdatasets
from multimodal_neuroimage_tpu.data import index as jindex
from multimodal_neuroimage_tpu.data import synthetic as jsyn
from multimodal_neuroimage_tpu.models import struct_nets as jsn
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.nn.unet import UNet2D as JUNet
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu.train.state import _cast_tree
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data import datasets as tdatasets
from multimodal_neuroimage_tpu_torch.data import index as tindex
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.models import struct_nets as tsn
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.models.swinfusion_net import (
    SwinFusionNet)
from multimodal_neuroimage_tpu_torch.nn import swin2d as tsw
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.nn.unet import UNet2D
from multimodal_neuroimage_tpu_torch.train.state import (bf16_weights,
                                                         forward_at)
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
# the bf16 policy against JAX's, the batch given to JAX as device arrays
# (``_cast_tree`` leaves a numpy batch float32): logits within LOGIT16, each
# gradient within its component's share of the component's largest
# (measured: logits 7.1e-6 and 3.8e-5, shares swin 0.0016 and 0.0018,
# fusion 0.0023, for SwinClassifier and SwinFusionNet)
LOGIT16 = 1e-3
GRAD16 = {"swin": 5e-3, "fusion": 1e-2}
TINY_FUSION = dict(fusion_ex_depths=(1,), fusion_depths=(1,),
                   fusion_re_depths=(1,), fusion_ex_heads=(2,),
                   fusion_heads=(2,), fusion_re_heads=(2,))
DATASET_KEYS = {"DTI": ("dti",), "sMRI": ("smri",), "DTI+sMRI": ("struct",),
                "struct": ("smri", "dti")}


def _perturbed(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)


def _init(module, *args, seed=0):
    return _perturbed(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                           *args)["params"], seed)


def _matrices(*keys, B=2, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(B, 84, 84)).astype(np.float32) for k in keys}


def _close(got, want, msg="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _interpreted(fn):
    """fn() with JAX's K4 and K2/K3 in interpret mode."""
    jatt.set_fused_attention(True)
    try:
        return fn()
    finally:
        jatt.set_fused_attention(None)


def _grads_close(module, want_state, msg=""):
    got = dict(module.named_parameters())
    assert set(got) == set(want_state)
    for name, p in got.items():
        _close(p.grad, want_state[name], f"{msg} {name}")


# ---- the modules -----------------------------------------------------------------------

def test_unet_matches_jax_with_gradients():
    """Base 4 on 84x84: 84 -> 42 -> 21 -> 10 -> 5 and back, up2 padding its
    20x20 map to the 21x21 skip; the transposed convolutions carried with
    the converter's flip. Forward, input and every parameter gradient."""
    x = _matrices("x")["x"][..., None]
    ct = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jmod = JUNet(base=4)
    params = _init(jmod, jnp.asarray(x))

    def f(p, x):
        return jnp.mean(jmod.apply({"params": p}, x) * ct)

    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    jgp, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    port = UNet2D(base=4)
    port.load_state_dict(jax_import.unet_state(params))
    tx = torch.from_numpy(x[..., 0][:, None]).requires_grad_()
    out = port(tx)
    _close(out.detach()[:, 0], np.asarray(want)[..., 0], "forward")
    (out * torch.from_numpy(ct[..., 0][:, None])).mean().backward()
    _close(tx.grad[:, 0], np.asarray(jgx)[..., 0], "dx")
    _grads_close(port, jax_import.unet_state(jgp), "UNet")


def test_default_unet_forward_matches_jax():
    """The phase-3 UNet at its default width (base 64, ~31 M parameters)."""
    x = _matrices("x")["x"][..., None]
    jmod = JUNet()
    params = _init(jmod, jnp.asarray(x))
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(
        params, jnp.asarray(x))
    port = UNet2D()
    port.load_state_dict(jax_import.unet_state(params))
    assert 30e6 < sum(p.numel() for p in port.parameters()) < 32e6
    with torch.no_grad():
        got = port(torch.from_numpy(x[..., 0][:, None]))
    _close(got[:, 0], np.asarray(want)[..., 0])


def test_mlp_vae_matches_jax_at_full_width():
    """84^2 -> 64^2 -> 32^2 -> 16^2 and back (~67 M parameters), z = mu:
    reconstruction, mu, logvar and every gradient."""
    x = _matrices("x")["x"]
    ct = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    jmod = jsn.MlpVae()
    params = _init(jmod, jnp.asarray(x))

    def f(p):
        r, mu, lv = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(r * ct) + jnp.mean(mu) + jnp.mean(lv * lv)

    want = jmod.apply({"params": params}, jnp.asarray(x))
    jg = jax.jit(jax.grad(f))(params)
    port = tsn.MlpVae().eval()
    port.load_state_dict(jax_import.mlp_vae_state(params))
    assert 66e6 < sum(p.numel() for p in port.parameters()) < 68e6
    r, mu, lv = port(torch.from_numpy(x))
    for name, g, w in zip(("recon", "mu", "logvar"), (r, mu, lv), want):
        _close(g.detach(), w, name)
    ((r * torch.from_numpy(ct)).mean() + mu.mean() + (lv * lv).mean()
     ).backward()
    _grads_close(port, jax_import.mlp_vae_state(jg), "VAE")


def test_vae_training_draws_its_noise_from_the_generator():
    """Training: z = mu + exp(logvar / 2) eps with eps from the step's
    generator, so one generator state gives one reconstruction; eval
    ignores it."""
    vae = tsn.MlpVae()
    x = torch.from_numpy(_matrices("x")["x"])
    runs = [vae.train()(x, torch.Generator().manual_seed(s))[0]
            for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with torch.no_grad():
        r, mu, _ = vae.eval()(x, None)
        assert torch.equal(r, vae(x, torch.Generator().manual_seed(0))[0])


# ---- the phase-3 and phase-6 models ------------------------------------------------------

def _jax_and_port(task, dataset, B=2, **kw):
    """The JAX model with perturbed parameters, the port model carrying
    them, and a batch of the dataset's matrices."""
    cfg = Config(task=task, dataset_name=dataset, compute_dtype="float32",
                 **kw).validate()
    from multimodal_neuroimage_tpu.config import Config as JConfig
    jmodel = jcreate(JConfig(**dataclasses.asdict(cfg)).validate())
    batch = _matrices(*DATASET_KEYS[dataset], B=B)
    params = _init(jmodel, batch)
    port = create_model(cfg)
    port.load_state_dict(jax_import.jax_params_to_state_dict(params))
    return cfg, jmodel, params, port.eval(), batch


def _loss(logits, target):
    return jnp.mean(jnp.maximum(logits, 0) - logits * target
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def _forward_and_grads(jmodel, params, port, batch, key):
    target = np.asarray([0.0, 1.0], np.float32)[:, None]

    def f(p):
        out = jmodel.apply({"params": p}, batch)
        return _loss(out[key], target), out

    (_, want), jg = _interpreted(
        lambda: jax.jit(jax.value_and_grad(f, has_aux=True))(params))
    out = port({k: torch.from_numpy(v) for k, v in batch.items()})
    _close(out[key].detach(), want[key], "logits")
    torch.nn.functional.binary_cross_entropy_with_logits(
        out[key], torch.from_numpy(target)).backward()
    _grads_close(port, jax_import.jax_params_to_state_dict(jg))
    return out, want


@pytest.mark.parametrize("size", ["small", "large"])
def test_swin_classifier_matches_jax(size):
    """SwinClassifier on sMRI: K4 at (B, 4, 3, 36, 4) and, large, (B, 1, 6,
    36, 4) and (B, 1, 12, 9, 4); logits and every gradient."""
    _, jmodel, params, port, batch = _jax_and_port("VIT", "sMRI",
                                                   size_of_model=size)
    assert isinstance(port, tsn.SwinClassifier)
    _forward_and_grads(jmodel, params, port, batch, "binary_classification")


@pytest.mark.parametrize("variant", ["use_vae", "use_unet"])
def test_swin_classifier_variants_match_jax(variant):
    """The whole VAE and UNet variants at their full front widths (small
    SwinV2): every output of the JAX model."""
    dataset = "DTI" if variant == "use_vae" else "DTI+sMRI"
    _, jmodel, params, port, batch = _jax_and_port(
        "VIT", dataset, size_of_model="small", **{variant: True})
    want = _interpreted(lambda: jax.jit(jmodel.apply)({"params": params},
                                                      batch))
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], key)


def test_swinfusion_net_matches_jax():
    """A tiny SwinFusionNet (the backbone at depth 1; the fixed large SwinV2
    head): logits, the fused image and every gradient."""
    _, jmodel, params, port, batch = _jax_and_port("SwinFusion", "struct",
                                                   **TINY_FUSION)
    assert isinstance(port, SwinFusionNet)
    assert port.swin.layers[2].blocks[5].drop_path == pytest.approx(0.1)
    out, want = _forward_and_grads(jmodel, params, port, batch,
                                   "binary_classification")
    _close(out["fused_image"].detach(), want["fused_image"], "fused_image")


def _record_dtypes(monkeypatch, module, names, seen, key):
    """Wrap module.<name> to record the dtype of its first argument."""
    for name in names:
        orig = getattr(module, name)

        def wrapped(x, *args, orig=orig, **kwargs):
            seen.setdefault(key, set()).add(str(x.dtype).split(".")[-1])
            return orig(x, *args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("task,dataset", [("VIT", "sMRI"),
                                          ("SwinFusion", "struct")])
def test_bf16_policy_matches_jax(task, dataset, monkeypatch):
    """compute_dtype="bfloat16": JAX casts the parameters and the batch to
    bf16 (the batch as device arrays: ``_cast_tree`` leaves a numpy batch
    float32) and the models widen the input back to float32, so they
    compute in float32 on bf16-rounded values. The port's forward_at under
    bf16_weights against JAX's _cast_tree path: logits within 3e-2, every
    gradient within its component's share of the component's largest (the
    flagship's bf16 tolerances); K4 and the fusion blocks see float32 on
    both sides (their f32 forms). And the port's bf16 step equals its
    float32 step on the bf16-rounded parameters and inputs."""
    kw = TINY_FUSION if task == "SwinFusion" else {}
    cfg, jmodel, params, port, batch = _jax_and_port(task, dataset, **kw)
    target = np.asarray([0.0, 1.0], np.float32)[:, None]
    seen = {}
    _record_dtypes(monkeypatch, jatt, ["fused_window_attention"], seen,
                   "jax K4")
    _record_dtypes(monkeypatch, tsw, ["fused_window_attention"], seen,
                   "port K4")
    blocks = ["fused_fusion_block", "fused_cross_fusion_block"]
    _record_dtypes(monkeypatch, jfb, blocks, seen, "jax fusion")
    _record_dtypes(monkeypatch, tsf, blocks, seen, "port fusion")

    def f(p):
        out = jmodel.apply({"params": _cast_tree(p, jnp.bfloat16)},
                           _cast_tree(jax.tree_util.tree_map(jnp.asarray,
                                                             batch),
                                      jnp.bfloat16))
        return _loss(_cast_tree(out, jnp.float32)["binary_classification"],
                     target), out["binary_classification"]

    (_, want), jg = _interpreted(
        lambda: jax.jit(jax.value_and_grad(f, has_aux=True))(params))
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()}

    def port_step(compute_dtype, inputs):
        port.zero_grad()
        out = forward_at(port, inputs, compute_dtype)["binary_classification"]
        torch.nn.functional.binary_cross_entropy_with_logits(
            out, torch.from_numpy(target)).backward()
        return out.detach(), {n: p.grad.clone()
                              for n, p in port.named_parameters()}

    with bf16_weights(port.parameters()):
        out, grads = port_step("bfloat16", inputs)
        rounded = {k: v.to(torch.bfloat16).float() for k, v in inputs.items()}
        out32, grads32 = port_step("float32", rounded)
    _close(out, want, "logits", LOGIT16, LOGIT16)
    torch.testing.assert_close(out, out32, rtol=0, atol=0)
    want_g = jax_import.jax_params_to_state_dict(jg)
    scale = {}
    for name, w in want_g.items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), float(w.abs().max()))
    for name, g in grads.items():
        torch.testing.assert_close(g, grads32[name], rtol=0, atol=0)
        part = name.split(".")[0]
        err = float((g.to(torch.bfloat16).float()
                     - want_g[name]).abs().max())
        assert err <= GRAD16[part] * scale[part], (name, err)
    assert seen["jax K4"] == seen["port K4"] == {"float32"}
    if task == "SwinFusion":
        assert seen["jax fusion"] == seen["port fusion"] == {"float32"}


# ---- the converters and the registry -----------------------------------------------------

@pytest.mark.parametrize("task,dataset,kw", [
    ("VIT", "sMRI", {}), ("VIT", "DTI", {"use_vae": True}),
    ("test", "DTI+sMRI", {"use_unet": True}), ("test", "struct", {}),
])
def test_converters_fill_every_port_parameter(task, dataset, kw):
    """At the four models' defaults (shapes from jax.eval_shape): every port
    parameter is filled, with its shape."""
    from multimodal_neuroimage_tpu.config import Config as JConfig
    cfg = Config(task=task, dataset_name=dataset, **kw).validate()
    jmodel = jcreate(JConfig(**dataclasses.asdict(cfg)).validate())
    batch = _matrices(*DATASET_KEYS[dataset], B=1)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            batch)["params"]
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    state = jax_import.jax_params_to_state_dict(zeros)
    port = create_model(cfg)
    want = {("VIT", "sMRI"): tsn.SwinClassifier,
            ("VIT", "DTI"): tsn.SwinClassifierVAE,
            ("test", "DTI+sMRI"): tsn.SwinClassifierUNet,
            ("test", "struct"): SwinFusionNet}[task, dataset]
    assert type(port) is want and type(jmodel).__name__ == want.__name__
    assert set(state) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k


def test_k4_limits_raise_with_the_shape(monkeypatch):
    """A window or patch size past K4's limits (a 14x14 window of head dim
    40) fails K4's own check, naming the shape (the tensor checks, which
    need the card, skipped here): the card raises, never falls back."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import build
    monkeypatch.setattr(build, "check_cuda_f32", lambda *a: None)
    q = torch.zeros(1, 1, 1, 196, 40)
    with pytest.raises(ValueError, match="N=196, D=40"):
        att._check(q, q, q, torch.zeros(1, 196, 196), None)


# ---- data --------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """14 subjects: 9 train, 2 val and 3 test at the default split, both
    classes in val and test."""
    return tsyn.generate_synthetic_cohort(
        str(tmp_path_factory.mktemp("struct_cohort")), n_subjects=14, seed=3)


@pytest.mark.parametrize("dataset", ["DTI", "sMRI", "DTI+sMRI", "struct"])
def test_struct_items_and_paths_match_jax(cohort, dataset):
    """Index paths and items (float16 matrices, subject, target) equal JAX's
    bit for bit; an in-memory request gives the on-disk record's item."""
    jcfg = jsyn.synthetic_config(cohort, dataset_name=dataset,
                                 target="sex").validate()
    tcfg = tsyn.synthetic_config(cohort, dataset_name=dataset,
                                 target="sex").validate()
    jrecs = jindex.build_subject_index(jcfg)
    trecs = tindex.build_subject_index(tcfg)
    assert [(r.idx, r.subject, r.paths) for r in trecs] == [
        (r.idx, r.subject, r.paths) for r in jrecs]
    assert set(trecs[0].paths) == set(DATASET_KEYS[dataset])
    jitems = jdatasets.ItemLoader(jcfg, augment=True)
    titems = tdatasets.ItemLoader(tcfg, augment=True)
    for jr, tr in list(zip(jrecs, trecs))[:3]:
        want, got = jitems(jr), titems(tr)
        assert set(got) == set(want)
        for key in want:
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        request = titems.load(tr)
        assert set(request) == {"subject"} | set(DATASET_KEYS[dataset])
        again = titems({**request, "target": tr.target})
        for key in DATASET_KEYS[dataset]:
            assert again[key].dtype == np.float16
            np.testing.assert_array_equal(again[key], got[key])


@pytest.mark.parametrize("dataset", ["DTI", "sMRI", "DTI+sMRI", "struct"])
def test_native_matrix_batches_match_the_host_items(cohort, dataset):
    """The native gear's matrix batches (JAX's _native_supported accepts the
    structural datasets) against the host items within 2e-3 (float16
    grain), padded tail included."""
    from multimodal_neuroimage_tpu.data.native import native_available
    if not native_available():
        pytest.skip("the JAX package's native library did not build")

    def batches(gear):
        cfg = tsyn.synthetic_config(cohort, dataset_name=dataset,
                                    target="sex", batch_size=4, workers=2,
                                    preprocess=gear).validate()
        pipe = tloader.DataPipeline(cfg, device="cpu")
        assert pipe._native_supported("val") == (gear == "native")
        return list(pipe.epoch("val", to_device=False))

    native, host = batches("native"), batches("host")
    assert len(native) == len(host) > 0
    for (nb, nn), (hb, hn) in zip(native, host):
        assert nn == hn and set(nb) == set(hb)
        for key in DATASET_KEYS[dataset]:
            assert nb[key].dtype == np.float32
            np.testing.assert_allclose(nb[key].astype(np.float16), hb[key],
                                       atol=2e-3, rtol=2e-3, err_msg=key)
        np.testing.assert_array_equal(nb["valid"], hb["valid"])


# ---- the phases, trained, tested and served from disk ---------------------------------

@pytest.mark.parametrize("task,dataset,kw", [
    ("VIT", "sMRI", dict(size_of_model="small", batch_size=4)),
    ("VIT", "DTI+sMRI", dict(size_of_model="small", batch_size=4,
                             use_unet=True)),
    ("SwinFusion", "struct", dict(batch_size=4, **TINY_FUSION)),
])
def test_phase_trains_tests_and_serves_from_disk(cohort, tmp_path, task,
                                                 dataset, kw):
    """``Trainer(cfg).training()`` for one epoch, ``testing()`` from its
    best checkpoint, ``run_predict(cfg)``: every subject once, scores equal
    to an in-memory ``Predictor`` on the same arrays in the same order (the
    same batches: the UNet normalises with its batch's statistics)."""
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        default_checkpoint)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (Predictor,
                                                                 run_predict)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = tsyn.synthetic_config(
        cohort, task=task, dataset_name=dataset, target="sex", nEpochs=1,
        workers=2, experiment_folder=str(tmp_path), experiment_title=task,
        **kw).validate()
    trainer = Trainer(cfg, device="cpu")
    trainer.training()
    assert trainer.steps_per_epoch == 2
    assert np.isfinite(trainer.step_losses).all()
    best = default_checkpoint(cfg)
    assert best is not None
    metrics = Trainer(cfg, sets=["test"], device="cpu").testing()
    assert "test_Balanced_Accuracy" in metrics

    scores = run_predict(cfg, device="cpu")
    records = tindex.build_subject_index(cfg, require_target=False)
    assert list(scores) == [r.subject for r in records] and len(scores) == 14
    with open(tmp_path / "predictions.csv") as f:
        assert len(f.read().strip().splitlines()) == 15
    loader = tdatasets.ItemLoader(cfg)
    memory = Predictor(cfg, best, [loader.load(r) for r in records],
                       device="cpu").predict()
    assert memory == scores
