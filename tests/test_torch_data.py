"""The port's on-disk data layer against the JAX package on the CPU.

* ``data/index.py``: ``build_subject_index`` / ``build_hcp_index`` against
  JAX's (pandas) on metadata with NA tokens, a repeated key, a subject list
  and unlabeled subjects, for classification and z-scored regression
  targets; records equal, targets within 1e-12.
* ``data/synthetic.py``: the port's writer against JAX's, arrays bit for
  bit, CSVs equal as pandas frames.
* ``data/splits.py``: split files byte-equal, and read back.
* ``data/datasets.py`` ``ItemLoader``: items against JAX's for each ported
  dataset and gear, augmentation included; arrays the two copy exactly,
  the rest at rtol 2e-4 / atol 1e-4.
* ``data/loader.py`` ``DataPipeline``: train, val and test batches of
  epochs 0 and 1 against JAX's ``DataPipeline(cfg).epoch(...,
  to_device=False)``: order, names, ``valid`` and values.
* The tiny flagship trained from disk for an epoch, tested and served by
  ``run_predict``: every subject once, scores equal to an in-memory
  ``Predictor``'s; and JAX's ``Predictor`` against the port's
  ``run_predict`` on the same cohort and weights (float32, host gear) at
  rtol 2e-4 / atol 1e-4.
"""

import dataclasses
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.data import datasets as jdatasets
from multimodal_neuroimage_tpu.data import index as jindex
from multimodal_neuroimage_tpu.data import loader as jloader
from multimodal_neuroimage_tpu.data import splits as jsplits
from multimodal_neuroimage_tpu.data import synthetic as jsyn
from multimodal_neuroimage_tpu_torch.data import datasets as tdatasets
from multimodal_neuroimage_tpu_torch.data import index as tindex
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.data import splits as tsplits
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
EXACT = ("subject", "target", "fmri_raw", "fmri_length", "struct", "valid")


def _cfgs(root, **kw):
    """The JAX and the port ``Config`` of one synthetic cohort."""
    return (jsyn.synthetic_config(root, **kw).validate(),
            tsyn.synthetic_config(root, **kw).validate())


def _same_arrays(got, want, key):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, key
    if key in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=key)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=key)


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    """One ABCD (22 subjects) and HCP (11) cohort written by each writer."""
    roots = {}
    for name, mod in (("jax", jsyn), ("port", tsyn)):
        root = str(tmp_path_factory.mktemp(f"cohort_{name}"))
        mod.generate_synthetic_cohort(root, n_subjects=22, seed=21)
        mod.generate_synthetic_hcp(root, n_subjects=11, seed=21)
        roots[name] = root
    return roots


# ---- (a) the subject index ---------------------------------------------------------

_META = """subjectkey,sex,BMI,age
NDAR01,1.0,20.5,120
NDAR02,NA,18.0,121
NDAR03,0.0,,119
NDAR04,1.0,nan,118
NDAR02,0.0,19.0,122
NDAR05,null,N/A,117
NDAR06,0.0,17.25,NaN
NDAR01,0.0,30.0,116
NDAR07,1.0,21.0,115
NDAR08,#N/A,-3.5,114
"""


@pytest.fixture(scope="module")
def meta_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("meta")
    (d / "meta.csv").write_text(_META)
    (d / "subs.txt").write_text("\n".join(
        ["NDAR01", "NDAR02", "NDAR03", "NDAR04", "NDAR05", "NDAR06",
         "NDAR08", "NDAR99"]) + "\n")
    return d


@pytest.mark.parametrize("sub_list", [True, False])
@pytest.mark.parametrize("require_target", [True, False])
@pytest.mark.parametrize("target,task", [
    ("sex", "binary_classification"), ("BMI", "regression"),
    ("foo", "binary_classification"), ("foo", "regression")])
@pytest.mark.parametrize("dataset,rois", [("fMRI_timeseries", 84),
                                          ("multimodal", 48)])
def test_subject_index_matches_jax(meta_dir, dataset, rois, target, task,
                                   require_target, sub_list):
    kw = dict(dataset_name=dataset, intermediate_vec=rois, target=target,
              fine_tune_task=task, metadata_csv=str(meta_dir / "meta.csv"),
              subject_list_path=str(meta_dir / (
                  "subs.txt" if sub_list else "missing.txt")))
    jcfg, tcfg = _cfgs(str(meta_dir), **kw)
    if target == "foo" and require_target:
        for build, cfg in ((jindex.build_subject_index, jcfg),
                           (tindex.build_subject_index, tcfg)):
            with pytest.raises(KeyError, match="foo"):
                build(cfg, require_target=True)
        return
    want = jindex.build_subject_index(jcfg, require_target=require_target)
    got = tindex.build_subject_index(tcfg, require_target=require_target)
    assert [(r.idx, r.subject, r.paths) for r in got] == [
        (r.idx, r.subject, r.paths) for r in want]
    assert len(got) >= 4
    np.testing.assert_allclose([r.target for r in got],
                               [r.target for r in want], rtol=0, atol=1e-12)


@pytest.mark.parametrize("require_target", [True, False])
@pytest.mark.parametrize("target", ["sex", "age"])
def test_hcp_index_matches_jax(tmp_path, target, require_target):
    jsyn.generate_synthetic_hcp(str(tmp_path), n_subjects=7, seed=2)
    meta = tmp_path / "data" / "metadata"
    # a missing value, a subject without a row, a row without a file
    (meta / "HCP_1200_gender.csv").write_text(
        "Subject,Gender\n100000,M\n100001,F\n100002,\n100004,M\n"
        "100005,F\n100006,NA\n100099,M\n")
    (meta / "HCP_1200_precise_age.csv").write_text(
        "subject,age\n100000,27.5\n100001,nan\n100002,31.25\n100003,22\n"
        "100005,29.0\n100006,33.5\n100099,40.125\n")
    jcfg, tcfg = _cfgs(str(tmp_path), dataset_name="hcp", target=target,
                       fine_tune_task=("regression" if target == "age"
                                       else "binary_classification"))
    want = jindex.build_subject_index(jcfg, require_target=require_target)
    got = tindex.build_subject_index(tcfg, require_target=require_target)
    assert [(r.idx, r.subject, r.paths) for r in got] == [
        (r.idx, r.subject, r.paths) for r in want]
    np.testing.assert_allclose([r.target for r in got],
                               [r.target for r in want], rtol=0, atol=1e-12)


def test_index_refuses_unported_datasets(meta_dir):
    """The structural datasets are indexed (M8, M9's SwinFusionNet), and
    ``multimodal_prs`` is (M9's PRS combiner: its index against JAX's is in
    tests/test_torch_combiners.py), and ``fMRI_image`` is (N6: its batches
    against JAX's are in tests/test_torch_nifti.py); no dataset waits any
    more, and a name the JAX package does not know raises."""
    kw = dict(metadata_csv=str(meta_dir / "meta.csv"),
              subject_list_path=str(meta_dir / "subs.txt"))
    for dataset in ("DTI", "sMRI", "struct", "DTI+sMRI", "fMRI_image"):
        jcfg, tcfg = _cfgs(str(meta_dir), dataset_name=dataset, **kw)
        got = tindex.build_subject_index(tcfg)
        assert got and [(r.idx, r.subject, r.paths) for r in got] == [
            (r.idx, r.subject, r.paths)
            for r in jindex.build_subject_index(jcfg)]
    assert "multimodal_prs" in tindex.PORTED
    assert not hasattr(tindex, "WAITING")
    with pytest.raises(ValueError, match="unknown dataset"):
        tindex.check_dataset("fMRI_volume")


# ---- (b) the cohort writer ---------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("cohort", dict(n_subjects=5, seed=3)),
    ("cohort", dict(n_subjects=4, seed=9, n_rois=48, smri_signal=0.8,
                    targets=["sex", "foo", "BMI"], smri_strength_noise=0.3)),
    ("hcp", dict(n_subjects=4, seed=3)),
])
def test_writer_matches_jax(tmp_path, kind, kw):
    name = ("generate_synthetic_cohort" if kind == "cohort"
            else "generate_synthetic_hcp")
    getattr(jsyn, name)(str(tmp_path / "jax"), **kw)
    getattr(tsyn, name)(str(tmp_path / "port"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "port")
        for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".csv"):
            pd.testing.assert_frame_equal(pd.read_csv(b), pd.read_csv(a))
        else:
            assert a.read_bytes() == b.read_bytes(), rel


def test_writer_refuses_fmri_images(tmp_path):
    """The writer no longer refuses ``include_fmri_image`` (N6): it writes
    each subject's 4-D volume as the JAX writer does (the volumes against
    JAX's are in tests/test_torch_nifti.py)."""
    from multimodal_neuroimage_tpu_torch.data.nifti import read_nifti
    root = tsyn.generate_synthetic_cohort(str(tmp_path), n_subjects=2,
                                          include_fmri_image=True)
    img_dir = os.path.join(root, "data", "fmri_image")
    names = sorted(os.listdir(img_dir))
    assert names == [f"masked_image_sub-NDARSYN00000{i}.nii.gz"
                     for i in range(2)]
    for name in names:
        assert read_nifti(os.path.join(img_dir, name)).shape == (
            12, 14, 12, 24)


# ---- (c) splits ----------------------------------------------------------------------

def test_split_files_match_jax_and_read_back(tmp_path):
    subjects = [f"S{i:03d}" for i in range(23)]
    want = jsplits.SplitManager(str(tmp_path / "jax"), "multimodal", 7,
                                0.6, 0.2).split(subjects)
    port = tsplits.SplitManager(str(tmp_path / "port"), "multimodal", 7,
                                0.6, 0.2)
    assert port.split(subjects) == want
    rel = os.path.join("splits", "multimodal", "seed_7.txt")
    assert ((tmp_path / "port" / rel).read_bytes()
            == (tmp_path / "jax" / rel).read_bytes())
    # the persisted file wins over a new draw, filtered to known subjects
    again = tsplits.SplitManager(str(tmp_path / "jax"), "multimodal", 7)
    assert again.exists() and again.load() == want
    assert again.split(subjects[:-3]) == tuple(
        [s for s in part if s in subjects[:-3]] for part in want)


# ---- (d) items -----------------------------------------------------------------------

@pytest.mark.parametrize("dataset,fmri_type,gear,augment", [
    ("hcp", "timeseries", "device", 0.0),
    ("fMRI_timeseries", "timeseries", "host", 0.0),
    ("fMRI_timeseries", "divided_frequency", "host", 0.0),
    ("fMRI_timeseries", "time_domain_low", "device", 0.0),
    ("fMRI_timeseries", "timeseries", "device", 0.5),
    ("multimodal", "divided_frequency", "host", 0.0),
    ("multimodal", "divided_frequency", "device", 0.0),
    ("multimodal", "divided_frequency", "host", 0.5),
])
def test_items_match_jax(cohorts, dataset, fmri_type, gear, augment):
    root = cohorts["jax"]
    jcfg, tcfg = _cfgs(root, dataset_name=dataset, fmri_type=fmri_type,
                       preprocess=gear, augment_prob=augment, target="sex")
    jrecs = jindex.build_subject_index(jcfg)
    trecs = tindex.build_subject_index(tcfg)
    jitems = jdatasets.ItemLoader(jcfg, augment=augment > 0)
    titems = tdatasets.ItemLoader(tcfg, augment=augment > 0)
    for jr, tr in list(zip(jrecs, trecs))[:3]:
        want, got = jitems(jr), titems(tr)
        assert set(got) == set(want)
        assert got.pop("subject_name") == want.pop("subject_name")
        for key in want:
            _same_arrays(got[key], want[key], key)


# ---- (e) batches ---------------------------------------------------------------------

@pytest.mark.parametrize("dataset,fmri_type,gear", [
    ("multimodal", "divided_frequency", "host"),
    ("multimodal", "divided_frequency", "device"),
    ("fMRI_timeseries", "timeseries", "device"),
    ("hcp", "timeseries", "device"),
])
def test_pipeline_batches_match_jax(cohorts, dataset, fmri_type, gear):
    kw = dict(dataset_name=dataset, fmri_type=fmri_type, preprocess=gear,
              target="sex", batch_size=4, workers=2)
    jcfg = jsyn.synthetic_config(cohorts["jax"], **kw).validate()
    tcfg = tsyn.synthetic_config(cohorts["port"], **kw).validate()
    jpipe = jloader.DataPipeline(jcfg, mesh=None)
    tpipe = tloader.DataPipeline(tcfg, device="cpu")
    n = len(tpipe.records)
    assert {k: len(v) for k, v in tpipe.splits.items()} == {
        "train": int(n * 0.7), "val": int(n * 0.15),
        "test": n - int(n * 0.7) - int(n * 0.15)}
    orders = []
    for split in ("train", "val", "test"):
        for epoch in (0, 1):
            want = list(jpipe.epoch(split, epoch, to_device=False))
            got = list(tpipe.epoch(split, epoch, to_device=False))
            assert len(got) == len(want) > 0
            for (gb, gn), (wb, wn) in zip(got, want):
                assert gn == wn
                assert set(gb) == set(wb)
                for key in wb:
                    _same_arrays(gb[key], wb[key], key)
            names = [x for _, ns in got for x in ns]
            if split == "train":
                orders.append(names)
                assert len(names) == 4 * tpipe.steps_per_epoch("train")
            else:
                assert None in names or len(tpipe.splits[split]) % 4 == 0
    assert orders[0] != orders[1]        # each epoch reshuffles


def test_pipeline_sends_batches_to_the_device_gear(cohorts):
    """``epoch(to_device=True)``: the model inputs become float32 tensors,
    the device gear's raw series become its bands, the host keys stay."""
    cfg = tsyn.synthetic_config(cohorts["port"], dataset_name="multimodal",
                                fmri_type="divided_frequency", target="sex",
                                batch_size=4).validate()
    pipe = tloader.DataPipeline(cfg, device="cpu")
    raw, names = next(pipe.epoch("val", to_device=False))
    batch, dev_names = next(pipe.epoch("val"))
    assert dev_names == names and "fmri_raw" in raw and "fmri_raw" not in batch
    flagship = ("fmri_raw_sequence", "fmri_lowfreq_sequence",
                "fmri_ultralowfreq_sequence", "struct")
    assert set(flagship) <= set(tloader.MODEL_INPUTS)
    for key in flagship:
        assert batch[key].dtype == torch.float32, key
    assert isinstance(batch["valid"], np.ndarray)
    np.testing.assert_array_equal(batch["target"], raw["target"])


# ---- (g), (h) the slice ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_cohort(tmp_path_factory):
    """A 14-subject cohort of 48 ROIs, the tiny flagship's width, under the
    48-ROI atlas's file names; at the default seed its val (2) and test (3)
    splits hold both classes."""
    root = str(tmp_path_factory.mktemp("tiny_cohort"))
    tsyn.generate_synthetic_cohort(root, n_subjects=14, seed=3, n_rois=48)
    fdir = os.path.join(root, "data", "fmri_timeseries")
    for sub in os.listdir(fdir):
        key = sub[len("sub-"):]
        os.rename(os.path.join(fdir, sub, f"desikankilliany_sub-{key}.npy"),
                  os.path.join(fdir, sub, f"harvard_oxford_sub-{key}.npy"))
    return root


def _tiny(root, folder, **kw):
    """The tiny flagship (port ``Config``) pointed at ``root``."""
    base = {k: v for k, v in dataclasses.asdict(_flagship_cfg(tiny=True))
            .items() if k != "base_path" and not k.endswith("_path")}
    base.update(dict(batch_size=2, nEpochs=1, workers=2,
                     experiment_title="tiny", experiment_folder=str(folder)),
                **kw)
    return tsyn.synthetic_config(root, **base).validate()


def test_tiny_flagship_trains_tests_and_serves_from_disk(tiny_cohort,
                                                          tmp_path):
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        default_checkpoint, latest_checkpoint)
    from multimodal_neuroimage_tpu_torch.serve.predictor import (Predictor,
                                                                 run_predict)
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny(tiny_cohort, tmp_path)
    assert (cfg.compute_dtype, cfg.preprocess) == ("bfloat16", "device")
    trainer = Trainer(cfg, device="cpu")
    n_train = len(trainer.pipeline.splits["train"])
    assert trainer.steps_per_epoch == n_train // 2
    trainer.training()
    assert np.isfinite(trainer.step_losses).all()
    best = default_checkpoint(cfg)
    assert best is not None and "_BEST_val_" in best
    last = str(tmp_path / "tiny_last_epoch.ckpt")
    assert latest_checkpoint(str(tmp_path)) == last
    resumed = Trainer(cfg, device="cpu")         # auto-resume: nothing left
    assert resumed.epoch0 == 1 and resumed.training() == {}
    tester = Trainer(cfg, sets=["test"], device="cpu")
    assert tester.checkpoint_path == last        # the JAX Trainer's rule
    metrics = tester.testing()
    assert "test_Balanced_Accuracy" in metrics
    assert len(tester.writer.loss_history["total_test_loss_history"]) == 1

    scores = run_predict(cfg, device="cpu")
    records = tindex.build_subject_index(cfg, require_target=False)
    assert list(scores) == [r.subject for r in records] and len(scores) == 14
    rows = pd.read_csv(tmp_path / "predictions.csv", dtype={"subject": str})
    assert sorted(rows["subject"]) == sorted(scores)
    loader = tdatasets.ItemLoader(cfg)
    requests = [loader.load(r) for r in records]
    memory = Predictor(cfg, best, requests,
                       device="cpu").predict()
    assert memory == scores


def test_jax_predictor_matches_run_predict(tiny_cohort, tmp_path):
    from multimodal_neuroimage_tpu.ckpt.checkpoint import (
        save_checkpoint as jsave)
    from multimodal_neuroimage_tpu.models.registry import create_model
    from multimodal_neuroimage_tpu.serve.predictor import (
        Predictor as JPredictor)
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        save_checkpoint)
    from multimodal_neuroimage_tpu_torch.serve.predictor import run_predict
    from multimodal_neuroimage_tpu_torch.utils.jax_import import (
        jax_params_to_state_dict)
    cfg = _tiny(tiny_cohort, tmp_path, compute_dtype="float32",
                preprocess="host", batch_size=4)
    jcfg = jsyn.synthetic_config(tiny_cohort, **{
        k: v for k, v in dataclasses.asdict(cfg).items()
        if k != "base_path"}).validate()
    model = create_model(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), _example_batch(
        2, t=32, r=48))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    meta = {"val_threshold": 0.5}
    jpath = jsave(str(tmp_path / "jax" / "m.ckpt"), params=params,
                  metadata=meta)
    save_checkpoint(str(tmp_path / "tiny_BEST_val_AUROC.ckpt"),
                    jax_params_to_state_dict(params), meta)
    want = JPredictor(jcfg, checkpoint=jpath).predict()
    got = run_predict(cfg, device="cpu")
    assert list(got) == list(want) and len(got) == 14
    np.testing.assert_allclose([got[s]["score"] for s in got],
                               [want[s]["score"] for s in got],
                               rtol=RTOL, atol=ATOL)
