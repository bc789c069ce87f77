"""The port's ``fMRI_image`` cohort (data/nifti.py and the data layer's
NIfTI branches) and utils/reproducibility.py against the JAX package on
the CPU.

* NIfTI round trips (``.nii`` and ``.nii.gz``, 3-D and 4-D) between the
  two packages' readers and writers; a big-endian int16 file with
  ``scl_slope`` / ``scl_inter``; the header peek; the refusals;
* the synthetic writer's volumes against JAX's (data, not gzip bytes);
* ``fMRI_image`` batches of every split equal to JAX's ``DataPipeline`` in
  the ``host`` gear and in the ``native`` gear (skipped without ``g++``),
  and the native batches equal to the host ones;
* phase 1 on ``fMRI_image`` raising ``TypeError`` in both packages (the
  temporal BERT takes no 4-D volume);
* ``host_rng`` streams equal to JAX's; ``root_generator`` on its device;
* ``deterministic_algorithms``: cuDNN's deterministic algorithms for a
  CUDA device and nothing for the CPU, and the Trainer applying it to its
  device.

Tolerance: exact everywhere (the same float32 values).
"""

import dataclasses
import os
import shutil
import struct

import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.data import nifti as jnifti
from multimodal_neuroimage_tpu.data import synthetic as jsyn
from multimodal_neuroimage_tpu.data.loader import DataPipeline as JPipeline
from multimodal_neuroimage_tpu.utils import reproducibility as jrep
from multimodal_neuroimage_tpu_torch.data import index as tindex
from multimodal_neuroimage_tpu_torch.data import nifti as tnifti
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.data.loader import (DataPipeline,
                                                         fmri_image_item)
from multimodal_neuroimage_tpu_torch.utils import reproducibility as trep

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# ---- the reader and the writer ----------------------------------------------------

@pytest.mark.parametrize("name,shape", [("vol.nii", (5, 6, 7)),
                                        ("vol.nii.gz", (4, 5, 3, 9))])
def test_nifti_round_trips_between_packages(tmp_path, name, shape):
    data = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tpath, jpath = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    tnifti.write_nifti(tpath, data)
    jnifti.write_nifti(jpath, data)
    for path in (tpath, jpath):
        assert tnifti.read_nifti_header(path) == jnifti.read_nifti_header(
            path) == shape
        got, want = tnifti.read_nifti(path), jnifti.read_nifti(path)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, data.astype(np.float64))
    if not name.endswith(".gz"):
        assert open(tpath, "rb").read() == open(jpath, "rb").read()


def _big_endian_int16(path, data, slope, inter):
    header = bytearray(352)
    struct.pack_into(">i", header, 0, 348)
    struct.pack_into(">8h", header, 40, data.ndim, *data.shape,
                     *([1] * (7 - data.ndim)))
    struct.pack_into(">h", header, 70, 4)           # int16
    struct.pack_into(">h", header, 72, 16)
    struct.pack_into(">f", header, 108, 352.0)
    struct.pack_into(">f", header, 112, slope)
    struct.pack_into(">f", header, 116, inter)
    header[344:348] = b"ni1\x00"
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(data.astype(">i2").tobytes(order="F"))


def test_nifti_big_endian_scaled_and_refusals(tmp_path):
    data = np.arange(2 * 3 * 4, dtype=np.int16).reshape(2, 3, 4) - 7
    path = str(tmp_path / "be.nii")
    _big_endian_int16(path, data, 0.5, 3.0)
    got = tnifti.read_nifti(path)
    np.testing.assert_array_equal(got, jnifti.read_nifti(path))
    np.testing.assert_array_equal(got, data * 0.5 + 3.0)
    assert tnifti.read_nifti_header(path) == (2, 3, 4)
    short = str(tmp_path / "short.nii")
    with open(short, "wb") as f:
        f.write(b"\0" * 100)
    bad = str(tmp_path / "bad.nii")
    with open(bad, "wb") as f:
        f.write(b"\0" * 400)
    for path, match in ((short, "truncated"), (bad, "not a NIfTI-1")):
        for reader in (tnifti.read_nifti, tnifti.read_nifti_header):
            with pytest.raises(ValueError, match=match):
                reader(path)
            with pytest.raises(ValueError, match=match):
                getattr(jnifti, reader.__name__)(path)


# ---- the cohort -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    base = tmp_path_factory.mktemp("img")
    kw = dict(n_subjects=9, seed=5, include_fmri_image=True)
    troot = tsyn.generate_synthetic_cohort(str(base / "port"), **kw)
    jroot = jsyn.generate_synthetic_cohort(str(base / "jax"), **kw)
    return troot, jroot


def test_writer_volumes_match_jax(cohorts):
    troot, jroot = cohorts
    names = sorted(os.listdir(os.path.join(jroot, "data", "fmri_image")))
    assert len(names) == 9 and names == sorted(
        os.listdir(os.path.join(troot, "data", "fmri_image")))
    for name in names:
        got = tnifti.read_nifti(os.path.join(troot, "data", "fmri_image",
                                             name))
        assert got.shape == (12, 14, 12, 24)
        np.testing.assert_array_equal(got, jnifti.read_nifti(
            os.path.join(jroot, "data", "fmri_image", name)))
    for rel in ("data/dti/dti_count_NDARSYN000003.npy",
                "data/fmri_timeseries/sub-NDARSYN000003/"
                "desikankilliany_sub-NDARSYN000003.npy"):
        assert (open(os.path.join(troot, rel), "rb").read()
                == open(os.path.join(jroot, rel), "rb").read())


def _cfgs(root, **kw):
    args = dict(dataset_name="fMRI_image", target="sex", batch_size=2,
                workers=2, **kw)
    return (jsyn.synthetic_config(root, **args).validate(),
            tsyn.synthetic_config(root, **args).validate())


def _epochs(pipe, **kw):
    return {split: list(pipe.epoch(split, 1, to_device=False, **kw))
            for split in ("train", "val", "test")}


def _same_batches(got, want):
    assert {s: len(b) for s, b in got.items()} == {
        s: len(b) for s, b in want.items()}
    for split in want:
        for (gb, gn), (wb, wn) in zip(got[split], want[split]):
            assert gn == wn, split
            assert sorted(gb) == sorted(wb), split
            for k in wb:
                assert np.asarray(gb[k]).dtype == np.asarray(wb[k]).dtype, k
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_index_and_host_batches_match_jax(cohorts):
    troot, _ = cohorts
    jcfg, tcfg = _cfgs(troot, preprocess="host")
    assert "fMRI_image" in tindex.PORTED
    records = tindex.build_subject_index(tcfg)
    assert all(r.paths["fmri_image"].endswith(f"masked_image_sub-"
                                              f"{r.subject}.nii.gz")
               for r in records)
    want = _epochs(JPipeline(jcfg))
    _same_batches(_epochs(DataPipeline(tcfg, device="cpu")), want)
    batch = want["train"][0][0]
    assert batch["fmri_sequence"].shape == (2, 12, 14, 12, 24)
    vol = tnifti.read_nifti(records[0].paths["fmri_image"])
    item = fmri_image_item({"subject": "s", "fmri_image": vol}, tcfg)
    assert item["fmri_sequence"].dtype == np.float32
    np.testing.assert_array_equal(item["fmri_sequence"], vol.astype(
        np.float32))


def test_native_batches_match_jax(cohorts):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native gear cannot be built")
    troot, _ = cohorts
    jcfg, tcfg = _cfgs(troot, preprocess="native")
    got = _epochs(DataPipeline(tcfg, device="cpu"))
    _same_batches(got, _epochs(JPipeline(jcfg)))
    _, host = _cfgs(troot, preprocess="host")
    _same_batches(got, _epochs(DataPipeline(host, device="cpu")))


def test_phase1_on_volumes_raises_as_jax(cohorts, tmp_path):
    """Phase 1's temporal BERT takes (B, T, H) series: a 4-D volume batch
    raises TypeError in both packages."""
    from multimodal_neuroimage_tpu.models.registry import (
        create_model as jcreate)
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    troot, _ = cohorts
    jcfg, tcfg = _cfgs(troot, preprocess="host", transformer_hidden_layers=1)
    batch, _ = next(DataPipeline(tcfg, device="cpu").epoch(
        "train", to_device=False))
    import jax
    with pytest.raises(TypeError):
        jcreate(jcfg).init(jax.random.PRNGKey(0), batch)
    with pytest.raises(TypeError, match="B, T, H"):
        create_model(tcfg).eval()({"fmri_sequence": torch.from_numpy(
            batch["fmri_sequence"])})


# ---- reproducibility ------------------------------------------------------------------

@pytest.mark.parametrize("seed,stream", [(trep.REFERENCE_SEED, ()),
                                         (3, (1,)), (7, (2, 5))])
def test_host_rng_streams_match_jax(seed, stream):
    assert trep.REFERENCE_SEED == jrep.REFERENCE_SEED
    got = trep.host_rng(seed, *stream)
    want = jrep.host_rng(seed, *stream)
    np.testing.assert_array_equal(got.permutation(50), want.permutation(50))
    np.testing.assert_array_equal(got.normal(size=20), want.normal(size=20))


def test_root_generator_is_seeded_on_its_device():
    gen = trep.root_generator(11, device="cpu")
    assert gen.device == torch.device("cpu")
    np.testing.assert_array_equal(
        torch.rand(5, generator=gen).numpy(),
        torch.rand(5, generator=torch.Generator().manual_seed(11)).numpy())
    assert trep.root_generator().initial_seed() == trep.REFERENCE_SEED


@pytest.fixture
def cudnn_flags():
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.benchmark) = saved


def test_deterministic_algorithms_for_cuda_only(cudnn_flags):
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    assert not trep.deterministic_algorithms("cpu")
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)
    for device in ("cuda", "cuda:1", torch.device("cuda", 0)):
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        assert trep.deterministic_algorithms(device)
        assert (torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark) == (True, False)


def test_trainer_applies_the_setting_to_its_device(cudnn_flags, monkeypatch,
                                                   tmp_path):
    """The Trainer hands its device to ``deterministic_algorithms``, which
    selects cuDNN's deterministic algorithms for a CUDA device: on the CPU
    the call is recorded and the flags stay as they were."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.train import trainer as ttrainer
    seen = []
    real = ttrainer.deterministic_algorithms
    monkeypatch.setattr(ttrainer, "deterministic_algorithms",
                        lambda device: seen.append(device) or real(device))
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    rng = np.random.default_rng(0)
    records = [{"subject": f"s{i}", "target": float(i % 2),
                "fmri": rng.normal(size=(22, 40))} for i in range(4)]
    cfg = Config(step=1, task="2DBERT", dataset_name="hcp", target="sex",
                 batch_size=2, nEpochs=1, transformer_hidden_layers=1,
                 compute_dtype="float32").validate()
    cfg = dataclasses.replace(cfg, sequence_length=40)
    ttrainer.Trainer(cfg, records[:2], records[2:], device="cpu",
                     experiment_folder=str(tmp_path))
    assert seen == ["cpu"]
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == (False, True)
