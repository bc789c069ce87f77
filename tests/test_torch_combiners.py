"""Phase 5's Func+Struct combiners without a UNet, and the PRS cohort, the
port against the JAX package on the CPU (tests/combiner_cases.py builds
them; the UNet combiners are in test_torch_combiners_unet.py and
test_torch_combiners_prs.py).

* ``FuncStructAdd`` and ``FuncStructTransfer``: logits, the embedding, the
  loss and every parameter gradient at float32 within rtol 2e-4 / atol
  1e-4; both also at the bf16 policy (logits and loss within 3e-2, each
  gradient tensor within 0.35 of its own largest |value|, and within
  tests/test_torch_bf16.py's share of its component's largest where the
  component computes as the flagship's does);
* ``FuncStructUNetCross`` at its defaults (no UNet flag): no UNet
  parameters on either side;
* the ``multimodal_prs`` index, items and batches against JAX's on a
  synthetic cohort.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import combiner_cases as cc
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.data import datasets as jdatasets
from multimodal_neuroimage_tpu.data import index as jindex
from multimodal_neuroimage_tpu_torch.data import datasets as tdatasets
from multimodal_neuroimage_tpu_torch.data import index as tindex
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

@pytest.mark.parametrize("case", ["add", "transfer"])
def test_combiner_matches_jax_forward_and_gradients(case):
    """Logits, the embedding, the loss and every parameter gradient at
    float32 within rtol 2e-4 / atol 1e-4."""
    cc.check_step(case)


@pytest.mark.parametrize("case", ["add", "transfer"])
def test_combiner_matches_jax_at_bf16(case):
    """The bf16 policy (JAX's _cast_tree of parameters and batch, outputs
    widened, its kernels interpreted; the port's bf16_weights and
    forward_at, gradients rounded to bf16): logits and loss within 3e-2,
    every gradient tensor within ``cc.OWN16`` of its own largest |value|
    and within its component's share of the component's largest.
    ``FuncStructAdd``'s SwinV2 takes a float32 image (struct + embedding),
    as the flagship's does, and is held to the flagship's share;
    ``FuncStructTransfer``'s takes the bf16 embedding and computes in bf16
    (K4 on its bf16 values in float32), as JAX's does, and is held per
    tensor only: the flagship's SwinV2 share (1e-2) is one of a float32
    stream."""
    grad16 = dict(cc.GRAD16)
    if case == "transfer":
        del grad16["swin"]
    cc.check_step16(case, grad16)


def test_unet_cross_without_unet_flags_has_no_unet():
    """At the defaults (use_unet_function = use_unet_struct = False) the UNet
    is never called: flax gives it no parameters, and the port's module
    holds no ``unet.`` keys, so the weights cross both ways (the forward is
    ``FuncStructCross``'s, held by tests/test_torch_flagship.py)."""
    cfg, jmodel, params, port, batch = cc.setup(
        "unet_cross", use_unet_function=False, use_unet_struct=False)
    assert "unet" not in params and "fusion" in params
    assert not any(k.startswith("unet.") for k in port.state_dict())


# ---- the PRS cohort -------------------------------------------------------------------

def test_prs_index_items_and_batches_match_jax(tmp_path):
    """``multimodal_prs`` on a synthetic cohort: the subjects (the metadata
    and the PRS table's inner join), paths, targets and z-scored scores of
    the index, the items (the flagship's plus ``prs``) and a batch's
    (B, 3) float32 ``prs`` on both gears, against JAX's."""
    root = tsyn.generate_synthetic_cohort(str(tmp_path / "c"), n_subjects=9,
                                          seed=4)
    prs_csv = os.path.join(root, "data", "prs", tindex.PRS_FILE)
    with open(prs_csv) as f:
        lines = f.read().splitlines()
    # a missing score drops its row; a repeated key keeps its last row
    first = lines[1].split(",")
    lines[2] = ",".join(lines[2].split(",")[:2] + ["", "1.0"])
    lines.append(",".join([first[0], "0.5", "0.25", "-1.0"]))
    with open(prs_csv, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = tsyn.synthetic_config(root, dataset_name="multimodal_prs",
                                preprocess="host", batch_size=4).validate()
    jcfg = JConfig(**dataclasses.asdict(cfg)).validate()
    got = tindex.build_subject_index(cfg)
    want = jindex.build_subject_index(jcfg)
    assert [(r.idx, r.subject, r.paths, r.target) for r in got] == [
        (r.idx, r.subject, r.paths, r.target) for r in want]
    assert 0 < len(got) < 9
    np.testing.assert_allclose(np.stack([r.prs for r in got]),
                               np.stack([r.prs for r in want]), rtol=1e-6,
                               atol=1e-6)
    assert got[0].prs.dtype == np.float32
    jitems = jdatasets.ItemLoader(jcfg)
    titems = tdatasets.ItemLoader(cfg)
    for t, j in zip(got[:2], want[:2]):
        a, b = titems(t), jitems(j)
        assert set(a) == set(b) - {"subject_name"} | {"subject_name"}
        for key in b:
            if key != "subject_name":
                np.testing.assert_allclose(a[key], b[key], rtol=1e-6,
                                           atol=1e-6, err_msg=key)
    for gear in ("host", "native"):
        pipe = tloader.DataPipeline(
            dataclasses.replace(cfg, preprocess=gear),
            splits={"train": got}, device="cpu")
        batch, names = next(pipe.epoch("train", shuffle=False))
        assert batch["prs"].dtype == torch.float32
        assert tuple(batch["prs"].shape) == (4, 3)
        np.testing.assert_allclose(batch["prs"].numpy(),
                                   np.stack([r.prs for r in got[:4]]))
