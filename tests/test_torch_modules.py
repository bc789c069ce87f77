"""The port's SwinFusion stacks and SwinV2 head against the JAX package's
modules on the CPU, on parameters carried by the port's converter, plus the
port's import hygiene.

Covers the converter's scan-stacked case (even depths store
``pairs/block_0|block_1`` with a leading depth//2 axis), shifted blocks
(mask on), the cross stage's double residual, and the SwinV2 "large" head
down to its 3x3 stage (window 3, N = 9, 12 heads). JAX runs its plain path;
the kernels' own JAX-interpret parity is tests/test_torch_kernels.py.
Parameters are the JAX init plus N(0, 0.05) noise, so that zero-initialised
norms do not hide a block. Tolerance: float32, rtol 2e-4 / atol 1e-4.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.nn import swin2d as jswin
from multimodal_neuroimage_tpu.nn import swinfusion as jsf
from multimodal_neuroimage_tpu_torch.nn import swin2d as tswin
from multimodal_neuroimage_tpu_torch.nn import swinfusion as tsf
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturbed_init(module, *args, seed=0):
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)


def _load(module, state):
    module.load_state_dict(state, strict=True)
    return module.eval()


@pytest.mark.parametrize("depth", [1, 2])
def test_rstb_matches_jax(depth):
    E, res, heads = 12, (12, 12), 6
    x = np.random.default_rng(1).normal(size=(2, 144, E)).astype(np.float32)
    jmod = jsf.RSTB(E, res, depth, heads, 6, drop_path=(0.0,) * depth)
    params = _perturbed_init(jmod, jnp.asarray(x))
    if depth == 2:
        assert "pairs" in params["residual_group"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _load(tsf.RSTB(E, res, depth, heads, 6),
                 jax_import.rstb_state(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_crstb_even_depth_matches_jax():
    E, res, heads = 12, (12, 12), 6
    rng = np.random.default_rng(2)
    x, y = (rng.normal(size=(2, 144, E)).astype(np.float32) for _ in "xy")
    jmod = jsf.CRSTB(E, res, 2, heads, 6, drop_path=(0.0, 0.0))
    params = _perturbed_init(jmod, jnp.asarray(x), jnp.asarray(y))
    assert "pairs" in params["residual_group"]
    wx, wy = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    tmod = _load(tsf.CRSTB(E, res, 2, heads, 6),
                 jax_import.crstb_state(params))
    with torch.no_grad():
        gx, gy = tmod(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=RTOL,
                               atol=ATOL)


def test_swinv2_large_head_matches_jax():
    """84x84 -> 12x12 (N 36, 3 heads, shifted) -> 6x6 (N 36, 6 heads) ->
    3x3 (window clamps to 3: N 9, 12 heads, no shift)."""
    x = np.random.default_rng(3).normal(size=(2, 84, 84)).astype(np.float32)
    jmod = jswin.SwinTransformerV2(img_size=(84, 84), patch_size=7,
                                   embed_dim=12, depths=(2, 2, 6),
                                   num_heads=(3, 6, 12), window_size=6)
    params = _perturbed_init(jmod, jnp.asarray(x))
    assert "pairs" in params["stage_2"]
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = _load(tswin.SwinTransformerV2((84, 84), 7, 12, (2, 2, 6),
                                         (3, 6, 12), 6),
                 jax_import.swin_state(params))
    assert tmod.layers[2].blocks[0].ws == 3
    assert tmod.layers[2].blocks[1].shift == 0
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_window_helpers_match_jax():
    for args in ((6, 6), (3, 3)):
        np.testing.assert_array_equal(tswin.relative_position_index(*args),
                                      jswin.relative_position_index(*args))
        np.testing.assert_array_equal(tswin.relative_coords_table(*args),
                                      jswin.relative_coords_table(*args))
    np.testing.assert_array_equal(tswin.shift_attn_mask(84, 84, 6, 3),
                                  jswin.shift_attn_mask(84, 84, 6, 3))
    assert tswin.shift_attn_mask(12, 12, 6, 0) is None


_HYGIENE = r"""
import sys
import numpy as np
import torch
from multimodal_neuroimage_tpu_torch import ops
from multimodal_neuroimage_tpu_torch.ckpt import checkpoint
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data import loader
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.ops import attention, bert_layer, build
from multimodal_neuroimage_tpu_torch.ops import fusion_block, fusion_block_bp
from multimodal_neuroimage_tpu_torch.ops import dot_shapes
from multimodal_neuroimage_tpu_torch.bench import dot_shapes as dot_bench
from multimodal_neuroimage_tpu_torch.nn import swinfusion
from multimodal_neuroimage_tpu_torch.serve import predictor
from multimodal_neuroimage_tpu_torch.utils import jax_import

cfg = Config(task="FuncStruct", dataset_name="multimodal",
             transformer_hidden_layers=1, bert_intermediate_size=64,
             num_heads_2DBert=4, intermediate_vec=48, fusion_ex_depths=(1,),
             fusion_depths=(1,), fusion_re_depths=(1,), fusion_ex_heads=(2,),
             fusion_heads=(2,), fusion_re_heads=(2,), size_of_model="small",
             compute_dtype="float32", preprocess="host").validate()
model = init_random_weights(create_model(cfg), torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
batch = {k: torch.from_numpy(rng.normal(size=(2, 16, 48)).astype(np.float32))
         for k in ("fmri_lowfreq_sequence", "fmri_ultralowfreq_sequence")}
batch["struct"] = torch.from_numpy(rng.normal(size=(2, 48, 48)).astype(np.float32))
with torch.no_grad():
    out = model.eval()(batch)["binary_classification"]
assert out.shape == (2, 1) and torch.isfinite(out).all()

# the same model on the bp fusion layout (K7's plain versions)
swinfusion._LAYOUT = "bp"
with torch.no_grad():
    bp_out = model(batch)["binary_classification"]
swinfusion._LAYOUT = "std"
assert torch.allclose(bp_out, out, rtol=1e-4, atol=1e-5)
assert dot_shapes.dot_chain("sm", *dot_shapes.inputs("sm"), 1,
                            cells=1).shape == (1, 28, 320, 96)

# one CPU training step (dropout on) through K5's plain version, and the
# training stack's modules
from multimodal_neuroimage_tpu_torch.evaluation import metrics
from multimodal_neuroimage_tpu_torch.train import trainer
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                         make_train_step)
opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3, 1e-5)
step = make_train_step(model, active_losses("FuncStruct",
                                            "binary_classification"),
                       opt, "float32", "cpu")
host = {k: v.numpy() for k, v in batch.items()}
host["target"] = np.asarray([0.0, 1.0], np.float32)
losses, _ = step(host, torch.Generator().manual_seed(0))
assert torch.isfinite(losses["total"]) and opt.count == 1
assert metrics.auroc([0, 1, 1], [0.2, 0.9, 0.4]) == 1.0

# one CPU training step of the HCP TransformerNet (K6 route, T = 1201)
from multimodal_neuroimage_tpu_torch.data.loader import collate, item_for
hcp = Config(step=1, task="2DBERT", dataset_name="hcp",
             transformer_hidden_layers=1, bert_intermediate_size=32,
             compute_dtype="float32").validate()
net = init_random_weights(create_model(hcp), torch.Generator().manual_seed(0))
opt = create_optimizer("AdamW", net.parameters(), lambda t: 1e-3, 1e-5)
step = make_train_step(net, active_losses("2DBERT", "binary_classification"),
                       opt, "float32", "cpu")
hbatch, _ = collate([item_for(hcp)({"subject": str(i),
                                    "fmri": rng.normal(size=(22, 1150))}, hcp)
                     for i in range(2)])
hbatch["target"] = np.asarray([0.0, 1.0], np.float32)
losses, _ = step(hbatch, torch.Generator().manual_seed(0))
assert torch.isfinite(losses["total"]) and opt.count == 1

# phase 2's nets: one CPU training step of the MulT net (plain torch
# attention) and of the two-channel net (K1's plain version)
for kind in ("cross_attention", "two_channels"):
    p2 = Config(step=2, task="lowfreqBERT", fmri_type="divided_frequency",
                fmri_multimodality_type=kind, intermediate_vec=22,
                sequence_length=16, nlevels=1, num_heads_mult=2,
                transformer_hidden_layers=1, bert_intermediate_size=32,
                num_heads_2DBert=2, compute_dtype="float32").validate()
    net = init_random_weights(create_model(p2),
                              torch.Generator().manual_seed(0))
    opt = create_optimizer("AdamW", net.parameters(), lambda t: 1e-3, 1e-5)
    step = make_train_step(net, active_losses("lowfreqBERT",
                                              "binary_classification"),
                           opt, "float32", "cpu")
    b2 = {k: rng.normal(size=(2, 16, 22)).astype(np.float32)
          for k in ("fmri_sequence", "fmri_lowfreq_sequence",
                    "fmri_ultralowfreq_sequence")}
    b2["target"] = np.asarray([0.0, 1.0], np.float32)
    losses, _ = step(b2, torch.Generator().manual_seed(0))
    assert torch.isfinite(losses["total"]) and opt.count == 1

# an HCP cohort written to disk by the port's writer: one training step
# from disk (subject index, SplitManager, DataPipeline), then served from
# the experiment folder by run_predict
import os
import tempfile
from multimodal_neuroimage_tpu_torch.data import synthetic
from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
with tempfile.TemporaryDirectory() as tmp:
    root = synthetic.generate_synthetic_hcp(tmp, n_subjects=8, seed=1)
    exp = os.path.join(tmp, "exp")
    disk = synthetic.synthetic_config(
        root, step=1, task="2DBERT", dataset_name="hcp",
        transformer_hidden_layers=1, bert_intermediate_size=32,
        compute_dtype="float32", batch_size=4, nEpochs=1, workers=1,
        experiment_folder=exp, experiment_title="hcp").validate()
    tr = Trainer(disk, device="cpu")
    tr.training()
    assert len(tr.step_losses) == 1 and np.isfinite(tr.step_losses).all()
    checkpoint.save_checkpoint(os.path.join(exp, "last.ckpt"),
                               tr.model.state_dict(), {})
    assert len(predictor.run_predict(disk, device="cpu")) == 8

# a structural cohort on disk: one training step of the phase-3
# SwinClassifier (sMRI) and of the phase-6 SwinFusionNet (the sMRI + DTI
# pair), the second served by run_predict
with tempfile.TemporaryDirectory() as tmp:
    root = synthetic.generate_synthetic_cohort(tmp, n_subjects=8, seed=1)
    for task, dataset, extra in (
            ("VIT", "sMRI", dict(size_of_model="small")),
            ("SwinFusion", "struct", dict(
                fusion_ex_depths=(1,), fusion_depths=(1,),
                fusion_re_depths=(1,), fusion_ex_heads=(2,),
                fusion_heads=(2,), fusion_re_heads=(2,)))):
        exp = os.path.join(tmp, task)
        disk = synthetic.synthetic_config(
            root, task=task, dataset_name=dataset, target="sex",
            batch_size=4, nEpochs=1, workers=1, experiment_folder=exp,
            experiment_title=task, **extra).validate()
        tr = Trainer(disk, device="cpu")
        tr.training()
        assert len(tr.step_losses) == 1 and np.isfinite(tr.step_losses).all()
    checkpoint.save_checkpoint(os.path.join(exp, "last.ckpt"),
                               tr.model.state_dict(), {})
    assert len(predictor.run_predict(disk, device="cpu")) == 8
# the phase chain through the port's CLI: step 3 (SwinClassifier on
# DTI+sMRI), step 5 (FuncStructAdd chained from it), step 4 (tested from
# step 3's checkpoint) and step 3's model served by --predict_only
import contextlib
import glob
import io
from multimodal_neuroimage_tpu_torch.cli import main as cli
with tempfile.TemporaryDirectory() as tmp:
    # seed 2: both classes in the validation split, so step 3 writes BEST
    root = synthetic.generate_synthetic_cohort(tmp, n_subjects=16, seed=2)
    common = ["--base_path", root, "--device", "cpu", "--target", "sex",
              "--size_of_model", "small", "--batch_size", "4",
              "--nEpochs", "1", "--workers", "1", "--compute_dtype",
              "float32", "--dti_smri_path",
              os.path.join(root, "data", "dti+smri_cortical_thickness")]
    bert = ["--multimodality_type", "add", "--transformer_hidden_layers",
            "1", "--bert_intermediate_size", "32", "--num_heads_2DBert", "4"]
    cli.main(["--step", "3", "--dataset_name", "DTI+sMRI", "--exp_name",
              "p3"] + common)
    assert glob.glob(os.path.join(root, "experiments", "p3_*", "*BEST*"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--step", "5", "--dataset_name", "multimodal",
                  "--exp_name", "p5"] + bert + common)
        m4 = cli.main(["--step", "4", "--dataset_name", "multimodal",
                       "--exp_name", "p4"] + bert + common)
    assert out.getvalue().count("phase-chained weights from") == 2
    assert "swin.layers.*.blocks.*.attn.qkv.weight" in out.getvalue()
    assert "test_Balanced_Accuracy" in m4
    assert len(cli.main(["--step", "3", "--dataset_name", "DTI+sMRI",
                         "--exp_name", "serve", "--predict_only"]
                        + common)) == 16
print(sorted(m for m in sys.modules
             if m in ("jax", "flax", "pandas", "sklearn")
             or m == "multimodal_neuroimage_tpu"
             or m.startswith("multimodal_neuroimage_tpu.")))
"""


def test_port_imports_no_jax_flax_pandas_sklearn():
    """Serve (std and bp fusion layouts), take one flagship and one HCP
    training step and one of each of phase 2's nets (the MulT and the
    two-channel net), run one dot-shape chain, write an HCP cohort to disk,
    train a step from it and serve it with ``run_predict``, train a step of
    ``SwinClassifier`` and of ``SwinFusionNet`` from a structural cohort on
    disk and serve the second with ``run_predict``, run the phase chain
    3 -> 5 -> 4 and a ``--predict_only`` through the port's CLI, in a fresh
    interpreter (this test process imported jax already,
    tests/conftest.py): none of jax, flax, pandas, sklearn or the JAX
    package ``multimodal_neuroimage_tpu`` (any of its modules) gets
    loaded."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_the_jax_package():
    """Static check of every module of the port and of chip_smoke.py: no
    import names ``multimodal_neuroimage_tpu`` or one of its modules, nor
    jax or flax (the port keeps its own copies of the host modules)."""
    port = os.path.join(REPO, "multimodal_neuroimage_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(port) for f in fs
        if f.endswith(".py")]
    assert len(files) > 20
    for new in ("nn/unet.py", "models/struct_nets.py",
                "models/swinfusion_net.py", "nn/crossmodal.py"):
        assert os.path.join(port, new) in files, new
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("multimodal_neuroimage_tpu", "jax", "flax")]
    assert not bad, bad
