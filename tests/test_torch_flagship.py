"""The port's flagship slice against the JAX package on the CPU.

The tiny flagship (``__graft_entry__._flagship_cfg(tiny=True)``, float32,
host preprocessing) is initialised once in JAX, perturbed by N(0, 0.05) so
that zero-initialised norms hide no block, and carried into the port by
``jax_params_to_state_dict``. Then:

* the JAX ``FuncStructCross`` forward (fused kernels in interpret mode) and
  the port's forward agree on the same batch;
* the serving path agrees: JAX ``serve.predictor.make_predict_step`` logits,
  sigmoided per window and averaged per subject, against the port
  ``Predictor`` on the same in-memory requests, labels included;
* the port's host item path equals the JAX ``ItemLoader.multimodal`` host
  branch on the same files.

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
    latest_checkpoint, load_checkpoint, save_checkpoint)
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                         multimodal_item)
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def flagship():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2).validate()
    cfg = Config(**dataclasses.asdict(jcfg))       # the port's own Config
    model = jcreate(jcfg)
    batch = _example_batch(2, t=32, r=cfg.intermediate_vec)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    state = jax_params_to_state_dict(params)
    return cfg, model, params, state


def _requests(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    R = cfg.intermediate_vec
    reqs = []
    for i in range(n):
        T = int(rng.integers(350, 369))
        s = rng.normal(size=(R, R))
        reqs.append({"subject": f"sub-{i % 4}",     # sub-0 sends two windows
                     "fmri": rng.normal(size=(R, T)) + 50.0,
                     "struct": s + s.T})
    return reqs


def test_converter_fills_every_port_parameter(flagship):
    cfg, _, _, state = flagship
    port = create_model(cfg)
    assert set(state) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k


def test_tiny_flagship_forward_matches_jax(flagship):
    from multimodal_neuroimage_tpu.ops.attention import set_fused_attention
    cfg, model, params, state = flagship
    batch = _example_batch(2, t=32, r=cfg.intermediate_vec)
    set_fused_attention(True)        # K1-K4 in interpret mode
    try:
        want = model.apply({"params": params}, batch, deterministic=True)
    finally:
        set_fused_attention(None)
    port = create_model(cfg)
    port.load_state_dict(state)
    with torch.no_grad():
        got = port.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("binary_classification", "embedding_per_ROIs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL)


def test_predictor_matches_jax_predict_step(flagship, tmp_path):
    from multimodal_neuroimage_tpu.serve.predictor import make_predict_step
    cfg, model, params, state = flagship
    reqs = _requests(cfg)
    step = make_predict_step(model, "float32")
    sums, counts = {}, {}
    for i in range(0, len(reqs), cfg.batch_size):
        batch, names = collate([multimodal_item(r, cfg)
                                for r in reqs[i:i + cfg.batch_size]])
        logits = np.asarray(step(params, batch)["binary_classification"])
        for name, v in zip(names, 1.0 / (1.0 + np.exp(-logits.reshape(-1)))):
            sums[name] = sums.get(name, 0.0) + float(v)
            counts[name] = counts.get(name, 0) + 1
    want = {n: sums[n] / counts[n] for n in sums}
    ordered = sorted(want.values())
    threshold = (ordered[1] + ordered[2]) / 2       # mixed labels, no ties

    ckpt = save_checkpoint(str(tmp_path / "tiny_BEST_val_AUROC.ckpt"), state,
                           {"val_threshold": threshold})
    pred = Predictor(cfg, ckpt, reqs, device="cpu")
    csv_path = str(tmp_path / "predictions.csv")
    got = pred.predict(write_csv=csv_path)
    assert pred.threshold == threshold
    assert set(got) == set(want) and counts["sub-0"] == 2
    for name, score in want.items():
        np.testing.assert_allclose(got[name]["score"], score, rtol=RTOL,
                                   atol=ATOL)
        assert got[name]["label"] == float(score > threshold)
    with open(csv_path) as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "subject,score,label" and len(rows) == 1 + len(want)


def test_host_item_matches_jax_item_loader(flagship, tmp_path):
    from multimodal_neuroimage_tpu.data.datasets import (ABCD_SKIP_TR,
                                                         ItemLoader)
    from multimodal_neuroimage_tpu.data.index import SubjectRecord
    cfg = flagship[0]
    req = _requests(cfg, n=1, seed=3)[0]
    fmri = np.concatenate([np.zeros((ABCD_SKIP_TR, req["fmri"].shape[0])),
                           req["fmri"].T])
    np.save(tmp_path / "fmri.npy", fmri)
    np.save(tmp_path / "struct.npy", req["struct"])
    rec = SubjectRecord(0, req["subject"],
                        {"fmri": str(tmp_path / "fmri.npy"),
                         "struct": str(tmp_path / "struct.npy")}, 1.0)
    want = ItemLoader(cfg).multimodal(rec)
    got = multimodal_item(req, cfg)
    for key in ("struct", "fmri_raw_sequence", "fmri_lowfreq_sequence",
                "fmri_ultralowfreq_sequence"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_checkpoint_roundtrip_and_latest(tmp_path):
    sd = {"w": torch.arange(6.0).reshape(2, 3)}
    a = save_checkpoint(str(tmp_path / "a.ckpt"), sd, {"val_threshold": 0.3})
    os.utime(a, (1, 1))
    b = save_checkpoint(str(tmp_path / "b.ckpt"), sd)
    ck = load_checkpoint(a)
    assert ck["metadata"] == {"val_threshold": 0.3}
    assert torch.equal(ck["state_dict"]["w"], sd["w"])
    assert latest_checkpoint(str(tmp_path)) == b
    assert latest_checkpoint(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("change,match", [
    ({"preprocess": "native"}, "on disk"),
])
def test_predictor_refuses_what_it_does_not_run(flagship, change, match):
    """The native gear loads batches of a cohort on disk: in-memory
    requests are refused rather than run through another gear."""
    cfg = dataclasses.replace(flagship[0], **change)
    with pytest.raises(ValueError, match=match):
        Predictor(cfg, "unused.ckpt", _requests(cfg), device="cpu")


@pytest.mark.parametrize("case", ["hcp_bf16", "device_gear"])
def test_predictor_runs_what_it_once_refused(flagship, case, tmp_path):
    """HCP at the bf16 policy (K6's bf16 form) and the device FIR gear, once
    refused, build and serve. The device gear's scores match the host
    gear's (its bands are within 5e-5 of the host split,
    tests/test_torch_hcp_bf16.py); HCP's bf16 scores match its float32
    ones within the bf16 policy's card-vs-CPU logit bound (5e-2)."""
    if case == "device_gear":
        cfg, state = flagship[0], flagship[3]
        other = dataclasses.replace(cfg, preprocess="device")
        reqs = _requests(cfg)
    else:
        from multimodal_neuroimage_tpu_torch.models.registry import (
            init_random_weights)
        other = Config(step=1, task="2DBERT", dataset_name="hcp",
                       target="sex", transformer_hidden_layers=1,
                       bert_intermediate_size=32, batch_size=2).validate()
        assert other.compute_dtype == "bfloat16"
        cfg = dataclasses.replace(other, compute_dtype="float32")
        state = init_random_weights(create_model(cfg), torch.Generator()
                                    .manual_seed(0)).state_dict()
        rng = np.random.default_rng(5)
        reqs = [{"subject": f"h{i}", "fmri": rng.normal(size=(22, 1150 + i))}
                for i in range(3)]
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), state,
                           {"val_threshold": 0.5})
    want = Predictor(cfg, ckpt, reqs, device="cpu").predict()
    got = Predictor(other, ckpt, reqs, device="cpu").predict()
    assert set(got) == set(want)
    tol = 1e-4 if case == "device_gear" else 5e-2
    for name, row in want.items():
        assert abs(got[name]["score"] - row["score"]) <= tol, (name, got)


def test_predictor_needs_in_memory_records(flagship, tmp_path):
    """Without in-memory records the Predictor indexes the cohort on disk
    that the config points at: an empty folder has no metadata to read."""
    cfg = dataclasses.replace(flagship[0], base_path=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="ABCD_phenotype_total.csv"):
        Predictor(cfg, "unused.ckpt", None, device="cpu")


@pytest.mark.parametrize("change,item", [
    pytest.param({"task": "lowfreqBERT"}, "TransformerNetCrossAttention",
                 id="change0-M7"),
    ({"task": "VIT"}, "SwinClassifier"),
    ({"task": "SwinFusion"}, "SwinFusionNet"),
    pytest.param({"multimodality_type": "add"}, "FuncStructAdd",
                 id="change3-M9"),
    pytest.param({"use_unet": True}, "FuncStructUNetCross",
                 id="change4-M9"),
])
def test_registry_names_the_roadmap_item(flagship, change, item):
    """A model still to port raises, naming its ROADMAP item; phase 2's
    MulT net (M7), the struct nets (VIT, M8), SwinFusionNet and the
    Func+Struct combiners (M9) are built, as JAX's registry builds them for
    this config."""
    cfg = dataclasses.replace(flagship[0], **change)
    if item.startswith("M"):
        with pytest.raises(NotImplementedError, match=item):
            create_model(cfg)
    else:
        assert type(create_model(cfg)).__name__ == item
        assert type(jcreate(dataclasses.replace(
            _flagship_cfg(tiny=True), **change))).__name__ == item


def test_random_init_is_seeded(flagship):
    cfg = flagship[0]
    a = init_random_weights(create_model(cfg), torch.Generator().manual_seed(5))
    b = init_random_weights(create_model(cfg), torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
