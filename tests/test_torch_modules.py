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
from multimodal_neuroimage_tpu_torch.ops import fusion_block
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
print(sorted(m for m in ("jax", "flax", "pandas", "sklearn") if m in sys.modules))
"""


def test_port_imports_no_jax_flax_pandas_sklearn():
    """Serve and take one training step in a fresh interpreter (this test
    process imported jax already, tests/conftest.py): none of jax, flax,
    pandas or sklearn gets loaded."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]", proc.stdout
