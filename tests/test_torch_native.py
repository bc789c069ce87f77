"""The port's native host gear (data/native.py over native/fastpipe.cpp)
against the JAX package's on the CPU.

* The native batches of the flagship's and the fMRI-only divided-frequency
  datasets equal JAX's native batches bit for bit (one source, the same
  compiler flags), padded eval tails included, and hold the host gear's
  bands within 1e-4 and its float16 struct matrices within 2e-3 (JAX's own
  bounds, tests/test_native_pipeline.py).
* No quiet fallback: a library that does not build raises with the
  compiler's message, from ``build`` and from a batch asked of the gear;
  in-memory records at ``preprocess="native"`` are refused.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.data import loader as jloader
from multimodal_neuroimage_tpu.data import synthetic as jsyn
from multimodal_neuroimage_tpu.data.native import native_available
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.data import native
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BANDS = ("fmri_lowfreq_sequence", "fmri_ultralowfreq_sequence")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return jsyn.generate_synthetic_cohort(
        str(tmp_path_factory.mktemp("native_cohort")), n_subjects=18, seed=5)


def _batches(cfg_mod, root, preprocess, dataset, split):
    kw = dict(dataset_name=dataset, target="sex", batch_size=4, workers=2,
              fmri_type="divided_frequency", preprocess=preprocess)
    cfg = cfg_mod.synthetic_config(root, **kw).validate()
    if cfg_mod is jsyn:
        pipe = jloader.DataPipeline(cfg, mesh=None)
    else:
        pipe = tloader.DataPipeline(cfg, device="cpu")
    return list(pipe.epoch(split, 0, shuffle=False, to_device=False))


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("dataset", ["multimodal", "fMRI_timeseries"])
def test_native_batches_match_jax_and_the_host_gear(cohort, dataset, split):
    if not native_available():
        pytest.skip("the JAX package's native library did not build")
    want = _batches(jsyn, cohort, "native", dataset, split)
    got = _batches(tsyn, cohort, "native", dataset, split)
    host = _batches(tsyn, cohort, "host", dataset, split)
    raw = "fmri_raw_sequence" if dataset == "multimodal" else "fmri_sequence"
    assert len(got) == len(want) == len(host) > 0
    for (gb, gn), (wb, wn), (hb, hn) in zip(got, want, host):
        assert gn == wn == hn
        assert set(gb) == set(wb) == set(hb)
        for key in wb:
            assert gb[key].dtype == wb[key].dtype, key
            np.testing.assert_array_equal(gb[key], wb[key], err_msg=key)
        for key in (raw,) + BANDS:
            np.testing.assert_allclose(gb[key], hb[key], rtol=0, atol=1e-4,
                                       err_msg=key)
        if dataset == "multimodal":
            np.testing.assert_allclose(gb["struct"].astype(np.float16),
                                       hb["struct"], atol=2e-3, rtol=2e-3)
        np.testing.assert_array_equal(gb["target"], hb["target"])


def test_a_failed_build_raises(tmp_path, monkeypatch, cohort):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.build(bad, tmp_path / "out")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "_LIB", None)
    cfg = tsyn.synthetic_config(cohort, dataset_name="multimodal",
                                target="sex", batch_size=4,
                                preprocess="native").validate()
    pipe = tloader.DataPipeline(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="error"):
        next(pipe.epoch("train", to_device=False))


def test_native_gear_refuses_in_memory_records(cohort):
    cfg = tsyn.synthetic_config(cohort, dataset_name="multimodal",
                                preprocess="native").validate()
    req = {"subject": "s", "fmri": np.zeros((84, 350)),
           "struct": np.eye(84), "target": 1.0}
    with pytest.raises(ValueError, match="on disk"):
        tloader.DataPipeline(cfg, splits={"val": [req]}, device="cpu")
