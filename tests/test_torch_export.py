"""The port's exported serving artifact (serve/export.py, ops/library.py)
on the CPU.

A tiny flagship (``__graft_entry__._flagship_cfg(tiny=True)``'s sizes:
2 BERT layers, one block a fusion stack, 48 ROIs) and a tiny structural
model (``SwinClassifier`` on DTI, K4's path) are served from a synthetic
cohort on disk, from the same weights in both packages (JAX's random
parameters carried by ``jax_params_to_state_dict``); a tiny HCP
``TransformerNet`` (one layer at T = 1201: K6's route) from in-memory
requests. Then:

* each artifact, its registered ops (non-portable) or the plain versions
  (``portable=True``), against the port's live ``Predictor`` on the same
  batch: the flagship at float32 and bf16 on the std layout and at
  float32 on ``bp``, the struct model, HCP at float32 and bf16;
* the non-portable graph calls exactly the registered ops of the model's
  kernels, the portable one none; the sidecar's keys; ``predict``'s
  post-processing; a missing input raises ``KeyError``;
* the port's artifacts against JAX's ``export_model(..., portable=True)``
  artifact of the same weights on the same cohort;
* the bf16 artifact is smaller than the float32 one and scores otherwise;
* the artifact runs its program without TF32 whatever its caller set;
* the registered ops against their plain versions, called eagerly.

Tolerances: against the live Predictor rtol / atol 1e-5 (on the CPU both
run the same plain versions: the differences are 0); against JAX the
goldens' rtol 2e-4 / atol 1e-4.
"""

import json
import os

import numpy as np
import pytest
import torch

import combiner_cases as cc
from __graft_entry__ import _example_batch
from multimodal_neuroimage_tpu.ckpt.checkpoint import (
    save_checkpoint as jsave)
from multimodal_neuroimage_tpu.data import synthetic as jsyn
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import save_checkpoint
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.ops import library
from multimodal_neuroimage_tpu_torch.serve.export import (export_model,
                                                          load_exported)
from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)


# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL = ATOL = 1e-5
JAX_RTOL, JAX_ATOL = 2e-4, 1e-4
# __graft_entry__._flagship_cfg(tiny=True)'s sizes
TINY_FLAGSHIP = dict(
    task="FuncStruct", dataset_name="multimodal",
    multimodality_type="cross_attention", transformer_hidden_layers=2,
    bert_intermediate_size=128, fusion_ex_depths=(1,), fusion_depths=(1,),
    fusion_re_depths=(1,), fusion_ex_heads=(2,), fusion_heads=(2,),
    fusion_re_heads=(2,), size_of_model="small", num_heads_2DBert=4,
    intermediate_vec=48, **cc.NO_DROPOUT)
TINY_STRUCT = dict(task="VIT", dataset_name="DTI", size_of_model="small")
OPS = {"flagship": ["bert_layer_forward", "fusion_block_forward",
                    "window_attention_forward"],
       "flagship_bp": ["bert_layer_forward", "fusion_block_bp_forward",
                       "window_attention_forward"],
       "struct": ["window_attention_forward"],
       "hcp": ["mha_forward"]}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A 6-subject cohort at 48 ROIs for the flagship (its series renamed
    to the 48-ROI atlas the index reads) and at 84 for the struct model."""
    base = tmp_path_factory.mktemp("export")
    root48 = tsyn.generate_synthetic_cohort(str(base / "r48"), n_subjects=6,
                                            seed=4, n_rois=48)
    fmri = os.path.join(root48, "data", "fmri_timeseries")
    for sub in os.listdir(fmri):
        key = sub[len("sub-"):]
        os.rename(os.path.join(fmri, sub, f"desikankilliany_sub-{key}.npy"),
                  os.path.join(fmri, sub, f"harvard_oxford_sub-{key}.npy"))
    root84 = tsyn.generate_synthetic_cohort(str(base / "r84"), n_subjects=6,
                                            seed=4)
    return {"flagship": root48, "struct": root84, "dir": base}


def _configs(root, kind, compute_dtype):
    kw = dict(TINY_FLAGSHIP if kind.startswith("flagship") else TINY_STRUCT)
    args = dict(target="sex", batch_size=2, compute_dtype=compute_dtype,
                preprocess="host", workers=1, **kw)
    return (jsyn.synthetic_config(root, **args).validate(),
            tsyn.synthetic_config(root, **args).validate())


@pytest.fixture(scope="module")
def weights(cohort):
    """{kind: (JAX checkpoint, port checkpoint)} of the same random
    parameters, with a frozen threshold."""
    out = {}
    for kind in ("flagship", "struct"):
        jcfg, _ = _configs(cohort[kind], kind, "float32")
        jmodel = jcreate(jcfg)
        batch = ({"dti": np.zeros((2, 84, 84), np.float32)}
                 if kind == "struct" else _example_batch(2, t=32, r=48))
        params = cc.random_params(jmodel, batch)
        meta = {"val_threshold": 0.4}
        d = cohort["dir"]
        out[kind] = (jsave(str(d / f"{kind}_jax.ckpt"), params=params,
                           metadata=meta),
                     save_checkpoint(str(d / f"{kind}_port.ckpt"),
                                     jax_params_to_state_dict(params), meta))
    return out


@pytest.fixture
def layout(request):
    saved = tsf._LAYOUT
    tsf._LAYOUT = "bp" if request.param == "flagship_bp" else "std"
    yield request.param
    tsf._LAYOUT = saved


def _first_batch(pred):
    batch, _ = next(pred.batches())
    return batch


def _check_artifact(pred, path, kind, compute_dtype, portable):
    art = load_exported(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta == art.meta
    assert set(meta) >= {"head", "threshold", "checkpoint", "batch_contract",
                         "ops", "device"}
    assert meta["threshold"] == pred.threshold
    assert meta["checkpoint"] == pred.checkpoint_path
    want_ops = [] if portable else sorted(
        f"{library.NAMESPACE}::{o}" for o in OPS[kind])
    assert meta["ops"] == want_ops
    for batch, _ in pred.batches():
        want = pred.step(batch)[pred.head].reshape(-1).numpy()
        got = art(batch)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        post = art.predict(batch)
        prob = 1.0 / (1.0 + np.exp(-got))
        np.testing.assert_allclose(post["score"], prob, rtol=1e-6)
        np.testing.assert_array_equal(post["label"],
                                      (prob > pred.threshold).astype(
                                          np.float32))
    batch = _first_batch(pred)
    short = {k: v for k, v in batch.items() if k != sorted(meta[
        "batch_contract"])[0]}
    with pytest.raises(KeyError, match="missing exported inputs"):
        art(short)
    return art


@pytest.mark.parametrize("layout,compute_dtype", [
    ("flagship", "float32"), ("flagship", "bfloat16"),
    ("flagship_bp", "float32"), ("struct", "float32")], indirect=["layout"])
def test_artifact_matches_live_predictor(cohort, weights, layout,
                                         compute_dtype, tmp_path):
    kind = layout
    base = "struct" if kind == "struct" else "flagship"
    _, cfg = _configs(cohort[base], kind, compute_dtype)
    pred = Predictor(cfg, weights[base][1], device="cpu")
    for portable in (False, True):
        path = export_model(pred, str(tmp_path / f"{portable}.pt2"),
                            portable=portable)
        _check_artifact(pred, path, kind, compute_dtype, portable)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_hcp_artifact_matches_live_predictor(compute_dtype, tmp_path):
    """K6's route (T = 1201 > K1's 640) through its registered op."""
    cfg = Config(step=1, task="2DBERT", dataset_name="hcp", target="sex",
                 batch_size=2, transformer_hidden_layers=1,
                 compute_dtype=compute_dtype, preprocess="host").validate()
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1))
    ckpt = save_checkpoint(str(tmp_path / "hcp.ckpt"), model.state_dict(),
                           {"val_threshold": 0.5})
    rng = np.random.default_rng(2)
    requests = [{"subject": f"s{i}", "fmri": rng.normal(size=(22, 1100))}
                for i in range(3)]
    pred = Predictor(cfg, ckpt, requests, device="cpu")
    for portable in (False, True):
        path = export_model(pred, str(tmp_path / f"{portable}.pt2"),
                            portable=portable)
        _check_artifact(pred, path, "hcp", compute_dtype, portable)


@pytest.mark.parametrize("kind", ["flagship", "struct"])
def test_artifact_matches_jax_portable_artifact(cohort, weights, kind,
                                                tmp_path):
    from multimodal_neuroimage_tpu.serve.export import (
        export_model as jexport, load_exported as jload)
    from multimodal_neuroimage_tpu.serve.predictor import (
        Predictor as JPredictor)
    jcfg, cfg = _configs(cohort[kind], kind, "float32")
    jpred = JPredictor(jcfg, checkpoint=weights[kind][0])
    jart = jload(jexport(jpred, str(tmp_path / "jax.stablehlo"),
                         portable=True))
    pred = Predictor(cfg, weights[kind][1], device="cpu")
    jpred.pipe.splits["x"] = list(jpred.records)
    jbatches = list(jpred.pipe.epoch("x", shuffle=False))
    for portable in (False, True):
        art = load_exported(export_model(
            pred, str(tmp_path / f"{portable}.pt2"), portable=portable))
        batches = list(pred.batches())
        assert len(batches) == len(jbatches) == 3
        for (batch, names), (jbatch, jnames) in zip(batches, jbatches):
            assert names == jnames
            np.testing.assert_allclose(art(batch), jart(jbatch),
                                       rtol=JAX_RTOL, atol=JAX_ATOL)


def test_bf16_artifact_is_smaller_and_scores_otherwise(cohort, weights,
                                                       tmp_path):
    arts, sizes = {}, {}
    for dtype in ("float32", "bfloat16"):
        _, cfg = _configs(cohort["flagship"], "flagship", dtype)
        pred = Predictor(cfg, weights["flagship"][1], device="cpu")
        path = export_model(pred, str(tmp_path / f"{dtype}.pt2"))
        arts[dtype], sizes[dtype] = load_exported(path), os.path.getsize(path)
        flat = arts[dtype].program.state_dict["weights"]
        assert flat.dtype == getattr(torch, dtype)
    assert sizes["bfloat16"] < sizes["float32"], sizes
    batch = _first_batch(pred)
    assert np.abs(arts["bfloat16"](batch) - arts["float32"](batch)).max() > 0


def test_artifact_runs_without_tf32(cohort, weights, tmp_path):
    """A program does not record TF32's settings: the artifact runs it
    with both off (as the live model runs its forward), whatever its
    caller has set, and gives the caller's settings back."""
    _, cfg = _configs(cohort["struct"], "struct", "float32")
    pred = Predictor(cfg, weights["struct"][1], device="cpu")
    art = load_exported(export_model(pred, str(tmp_path / "a.pt2")))
    assert art.meta["tf32"] is False
    seen, forward = [], art._forward

    def spy(batch):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return forward(batch)

    art._forward = spy
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        art(_first_batch(pred))
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert seen == [(False, False)] and after == (True, True)


def test_registered_ops_against_plain_versions():
    """Each op called eagerly on CPU tensors is its kernel's plain version
    bit for bit, with the output's shape and dtype its fake gives."""
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    from multimodal_neuroimage_tpu_torch.ops import fusion_block_bp as fbp
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return (0.3 * torch.randn(*shape, generator=g)).to(dtype)

    B, T, H, F_ = 2, 10, 16, 32
    p1 = [r(*s) for s in [(H, H), (H,)] * 4 + [(H,), (H,), (F_, H), (F_,),
                                                (H, F_), (H,), (H,), (H,)]]
    x1 = r(B, T, H)
    C, N, nW, heads, Ch = 8, 9, 4, 2, 16
    selfp = [r(C), r(C), r(3 * C, C), r(3 * C), r(C, C), r(C), r(C), r(C),
             r(Ch, C), r(Ch), r(C, Ch), r(C)]
    crossp = [r(C), r(C), r(C), r(C), r(C, C), r(C), r(2 * C, C), r(2 * C),
              r(C, C), r(C), r(C), r(C), r(Ch, C), r(Ch), r(C, Ch), r(C)]
    xw, yw, bias, mask = r(B, nW, N, C), r(B, nW, N, C), r(heads, N, N), \
        r(nW, N, N)
    q, k, v = (r(B, nW, heads, N, 4) for _ in range(3))
    mq, mk, mv = (r(B, 2, 24, 8) for _ in range(3))
    G = 2
    xg, yg = fbp.to_groups(xw, G), fbp.to_groups(yw, G)
    cases = [
        (library.bert_layer_forward(x1, p1, 4, 7, False),
         bl.bert_layer_reference(x1, p1, 4, 7)),
        (library.bert_layer_forward(x1, p1, 4, 7, True),
         bl.bert_layer_reference(x1, p1, 4, 7, mm16=True)),
        (library.fusion_block_forward(xw, None, selfp, bias, mask),
         fb.fusion_block_reference(xw, selfp, bias, mask)),
        (library.fusion_block_forward(xw, yw, crossp, bias, None),
         fb.cross_fusion_block_reference(xw, yw, crossp, bias)),
        (library.window_attention_forward(q, k, v, bias, mask),
         att.attention_reference(q, k, v, bias, mask)),
        (library.mha_forward(mq, mk, mv), att.mha_reference(mq, mk, mv)),
        (library.mha_forward(*(t.bfloat16() for t in (mq, mk, mv))),
         att.mha_reference16(*(t.bfloat16() for t in (mq, mk, mv)))),
        (library.fusion_block_bp_forward(xg, yg, crossp, bias, mask, G),
         fbp.cross_fusion_block_bp_reference(xg, yg, crossp, bias, mask,
                                             group=G)),
        (library.fusion_block_bp_forward(xg.bfloat16(), None, selfp, bias,
                                         mask, G),
         fbp.fusion_block_bp_reference16(xg.bfloat16(), selfp, bias, mask,
                                         group=G)[0]),
    ]
    assert len(cases) == len(library.ops()) + 4
    for i, (got, want) in enumerate(cases):
        assert got.dtype == want.dtype and got.shape == want.shape, i
        assert torch.equal(got, want), i


# the artifact served by a fresh interpreter that imports serve/export.py
# alone: its batch and the live scores come in an .npz
_LOAD_ONLY = """
import sys
import numpy as np
from multimodal_neuroimage_tpu_torch.serve.export import load_exported
art = load_exported(sys.argv[1])
data = np.load(sys.argv[2])
batch = {k[len("in_"):]: data[k] for k in data.files if k.startswith("in_")}
assert np.array_equal(art(batch), data["want"])
print(sorted(m for m in sys.modules
             if m.startswith("multimodal_neuroimage_tpu")
             and not m.startswith("multimodal_neuroimage_tpu_torch.ops")
             and m not in ("multimodal_neuroimage_tpu_torch",
                           "multimodal_neuroimage_tpu_torch.serve",
                           "multimodal_neuroimage_tpu_torch.serve.export")
             or m.split(".")[0] in ("jax", "flax", "transformers")))
"""


def test_artifact_serves_without_model_modules(cohort, weights, tmp_path):
    """A non-portable artifact loads and scores bit-equal to the live
    Predictor in a fresh interpreter that imports serve/export.py alone:
    no model, nn, data, train or config module of the port (nor jax, flax,
    transformers or the JAX package) is loaded; only ops/ (the registered
    ops and the plain versions they run on the CPU)."""
    import subprocess
    import sys
    _, cfg = _configs(cohort["flagship"], "flagship", "bfloat16")
    pred = Predictor(cfg, weights["flagship"][1], device="cpu")
    path = export_model(pred, str(tmp_path / "m.pt2"))
    batch = _first_batch(pred)
    np.savez(tmp_path / "io.npz", want=pred.step(batch)[pred.head]
             .reshape(-1).numpy(),
             **{f"in_{k}": v.numpy() for k, v in batch.items()
                if torch.is_tensor(v)})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _LOAD_ONLY, path,
                           str(tmp_path / "io.npz")], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
