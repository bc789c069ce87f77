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
from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                         multimodal_item)
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

RTOL, ATOL = 2e-4, 1e-4


@pytest.fixture(scope="module")
def flagship():
    cfg = dataclasses.replace(_flagship_cfg(tiny=True),
                              compute_dtype="float32", preprocess="host",
                              batch_size=2).validate()
    model = jcreate(cfg)
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
    ({"compute_dtype": "bfloat16"}, "bf16 policy"),
    ({"preprocess": "device"}, "FIR gear"),
    ({"preprocess": "native"}, "FIR gear"),
])
def test_predictor_refuses_what_it_does_not_run(flagship, change, match):
    cfg = dataclasses.replace(flagship[0], **change)
    with pytest.raises(NotImplementedError, match=match):
        Predictor(cfg, "unused.ckpt", [], device="cpu")


def test_predictor_needs_in_memory_records(flagship):
    with pytest.raises(NotImplementedError, match="on-disk cohort"):
        Predictor(flagship[0], "unused.ckpt", None, device="cpu")


@pytest.mark.parametrize("change,item", [
    ({"task": "2DBERT"}, "M7"), ({"task": "VIT"}, "M8"),
    ({"task": "SwinFusion"}, "M9"),
    ({"multimodality_type": "add"}, "M9"),
    ({"use_unet": True}, "M9"),
])
def test_registry_names_the_roadmap_item(flagship, change, item):
    cfg = dataclasses.replace(flagship[0], **change)
    with pytest.raises(NotImplementedError, match=item):
        create_model(cfg)


def test_random_init_is_seeded(flagship):
    cfg = flagship[0]
    a = init_random_weights(create_model(cfg), torch.Generator().manual_seed(5))
    b = init_random_weights(create_model(cfg), torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
