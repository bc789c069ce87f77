"""Phase 2 on the phase chain, and the MulT net at the bf16 policy, the
port against the JAX package on the CPU.

* ``partial_restore`` on the 1 -> 2 link: stats and merged weights equal to
  JAX's (only ``regression_head`` copies into the two-channel net, nothing
  into the MulT net);
* the chain through ``cli.main`` on a tiny cohort on disk: step 1, step 2
  (both nets, the printed stats equal to JAX's ``partial_restore`` on the
  same configurations), step 4 on the MulT net from step 2's checkpoint,
  and ``--predict_only`` on a step-2 checkpoint; at ``fmri_type=
  'timeseries'`` phase 2 fails on the missing band, as JAX's does;
* the MulT net at the bf16 policy: JAX's ``_cast_tree`` of the parameters
  and of the batch as device arrays against the port's ``bf16_weights``
  and ``forward_at``; the time projections compute in bf16 and the
  encoders in float32 on both sides (``scale * x + table`` promotes to
  float32, JAX nn/crossmodal.py:176), and the net's outputs are float32
  before any widening.
"""

import contextlib
import glob
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combiner_cases as cc
from flax.core import unfreeze
from flax.traverse_util import flatten_dict
from multimodal_neuroimage_tpu.ckpt import checkpoint as jckpt
from multimodal_neuroimage_tpu.cli import main as jcli
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.train.state import _cast_tree
from multimodal_neuroimage_tpu_torch.ckpt import checkpoint as tckpt
from multimodal_neuroimage_tpu_torch.cli import main as tcli
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.nn import crossmodal as tcm
from multimodal_neuroimage_tpu_torch.train.state import (batch_to_device,
                                                         bf16_weights)
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _tiny_params(kw, seed):
    jcfg = JConfig(**{**cc.FMRI_TINY, **kw}).validate()
    return cc.random_params(jcreate(jcfg), cc.fmri_batch(2, 16, 22), seed)


@pytest.mark.parametrize("target", ["cross_attention", "two_channels"])
def test_partial_restore_1_to_2_matches_jax(target):
    """Step 1's ``TransformerNet`` merged into each phase-2 net: JAX's and
    the port's ``partial_restore`` give the same stats and the same merged
    weights; only ``regression_head`` copies into the two-channel net, and
    nothing into the MulT net."""
    src = _tiny_params(dict(task="2DBERT", step=1), 1)
    tgt = _tiny_params(dict(fmri_multimodality_type=target), 2)
    merged, jstats = jckpt.partial_restore(tgt, src)
    got, stats, copied = tckpt.partial_restore(
        jax_import.jax_params_to_state_dict(tgt),
        jax_import.jax_params_to_state_dict(src))
    assert stats == jstats
    want = jax_import.jax_params_to_state_dict(merged)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sorted(copied) == ([] if target == "cross_attention" else
                              ["regression_head.bias",
                               "regression_head.weight"])


def _stats(out, source):
    """The stats dict the Trainer printed for its chained weights."""
    line = next(l for l in out.splitlines()
                if l.startswith(f"phase-chained weights from {source}"))
    return eval(line.split(": ", 1)[1].split("; copied")[0])


def _jax_stats(src_argv, tgt_argv):
    """JAX's partial_restore stats between the models of two CLI argument
    lists (the shapes, from ``eval_shape``, decide them)."""
    trees = []
    for argv in (src_argv, tgt_argv):
        jcfg = jcli.config_from_args(argv)
        shapes = jax.eval_shape(
            jcreate(jcfg).init, jax.random.PRNGKey(0),
            cc.fmri_batch(2, jcfg.sequence_length, jcfg.intermediate_vec)
        )["params"]
        trees.append(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
    return jckpt.partial_restore(trees[1], trees[0])[1]


def test_chain_1_2_4_predict_through_the_cli(tmp_path):
    """A 16-subject cohort on disk (series of 350-361 TRs, padded to 368):
    step 1 trains ``TransformerNet``; step 2 trains the MulT net and the
    two-channel net, each chained from step 1 with the stats JAX's
    ``partial_restore`` gives on the same configurations; step 4 tests the
    MulT net from step 2's checkpoint (every leaf copied); ``--predict_only``
    serves the two-channel checkpoint. At ``fmri_type='timeseries'`` the
    step-2 net finds no ``fmri_lowfreq_sequence`` (KeyError, as in JAX)."""
    root = tsyn.generate_synthetic_cohort(str(tmp_path), n_subjects=16,
                                          seed=2)
    common = ["--base_path", root, "--target", "sex",
              "--nEpochs", "1", "--workers", "1", "--batch_size", "4",
              "--compute_dtype", "float32", "--dataset_name",
              "fMRI_timeseries", "--fmri_type", "divided_frequency",
              "--transformer_hidden_layers", "1",
              "--bert_intermediate_size", "32", "--num_heads_2DBert", "4",
              "--nlevels", "1", "--num_heads_mult", "2"]

    def run(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            metrics = tcli.main(common + argv, device="cpu")
        return metrics, out.getvalue()

    def newest(exp_name):
        folder, = glob.glob(os.path.join(root, "experiments",
                                         f"{exp_name}_*"))
        return tckpt.latest_checkpoint(folder)

    run(["--step", "1", "--exp_name", "p1"])
    p1, = glob.glob(os.path.join(root, "experiments", "p1_*",
                                 "*_BEST_val_AUROC.ckpt"))
    for name, extra in (("mult", []),
                        ("two", ["--fmri_multimodality_type",
                                 "two_channels"])):
        argv = ["--step", "2", "--exp_name", name] + extra
        _, out = run(argv)
        assert _stats(out, p1) == _jax_stats(common + ["--step", "1"],
                                             common + argv)
        assert ("copied 2 tensors: regression_head.weight, regression_head"
                ".bias" if name == "two" else "copied 0 tensors") in out
    metrics, out = run(["--step", "4", "--exp_name", "p4",
                        "--model_weights_path", newest("mult")])
    stats = _stats(out, newest("mult"))
    assert stats["missing"] == stats["shape_skipped"] == 0
    assert "test_AUROC" in metrics
    scores, _ = run(["--step", "2", "--exp_name", "serve", "--predict_only",
                     "--fmri_multimodality_type", "two_channels",
                     "--model_weights_path", newest("two")])
    assert len(scores) == 16
    assert all(0.0 < r["score"] < 1.0 for r in scores.values())
    with pytest.raises(KeyError, match="fmri_lowfreq_sequence"):
        run(["--step", "2", "--exp_name", "ts", "--fmri_type",
             "timeseries"])


# the bf16 policy. The MulT net computes in float32 on bf16-rounded
# parameters and inputs (the time projections in bf16, exactly rounded on
# both sides), so the port's step is held to JAX's float32 step on the
# rounded values, its gradients rounded to bf16: each gradient within
# OWN16 of its own largest |value| (measured on the CPU: 0.93%, two bf16
# ulps: the two sides round sums taken in other orders). Against JAX's
# bf16 step itself, which also rounds each use's cotangent of a bf16
# parameter at its cast: logits within LOGIT16 (measured 1.4e-4), each
# gradient within SHARE16 of its component's largest (measured 0.066 on
# trans_u_with_l's fc1, where JAX's own float32 step on the rounded values
# lands 0.066 from its bf16 step too)
LOGIT16 = 1e-3
OWN16 = 2.0 ** -6
SHARE16 = 0.1


def test_mult_net_bf16_matches_jax():
    """The defaults at the bf16 policy, against JAX's float32 step on the
    bf16-rounded parameters and batch (OWN16) and against JAX's bf16 step
    (LOGIT16, SHARE16). The dtypes: ``proj_l``'s output bf16, every encoder
    layer's input and output float32 and the readout float32 on both sides
    (JAX's intermediates, the port's forward hooks, each before the outputs
    are widened)."""
    cfg, jmodel, params, port, batch = cc.setup_fmri("bfloat16")
    loss, want_out, want = cc.jax_step(jmodel, params, batch, bf16=True)
    got_loss, out, grads = cc.port_step(cfg, port, batch, "bfloat16")
    cc.close(out["binary_classification"].detach(),
           want_out["binary_classification"], "logits", LOGIT16, LOGIT16)
    cc.close(got_loss, loss, "loss", LOGIT16, LOGIT16)
    for name, s in cc.shares(grads, want).items():
        assert s <= SHARE16, (name, s)
    rounded = lambda t: np.asarray(jnp.asarray(t, jnp.bfloat16), np.float32)
    _, out32, want32 = cc.jax_step(
        jmodel, jax.tree_util.tree_map(rounded, params),
        {k: rounded(v) for k, v in batch.items()})
    cc.close(out["binary_classification"].detach(),
           out32["binary_classification"], "logits vs float32", LOGIT16,
           LOGIT16)
    for name, g in grads.items():
        w = want32[name].to(torch.bfloat16).float()
        err = float((g - w).abs().max())
        assert err <= OWN16 * float(w.abs().max()), (name, err)

    b16 = _cast_tree(jax.tree_util.tree_map(jnp.asarray, batch),
                     jnp.bfloat16)
    _, inter = jmodel.apply({"params": _cast_tree(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.bfloat16)}, b16,
        capture_intermediates=True, mutable=["intermediates"])
    jdt = {"/".join(k): v[0].dtype for k, v in flatten_dict(
        unfreeze(inter["intermediates"])).items() if hasattr(v[0], "dtype")}
    seen = {}

    def hook(name):
        def f(mod, args, output):
            seen[name] = (args[0].dtype, output.dtype)
        return f

    for name, mod in port.named_modules():
        if isinstance(mod, tcm.MultEncoderLayer) or name == "proj_l":
            mod.register_forward_hook(hook(name))
    inputs = {k: v.to(torch.bfloat16)
              for k, v in batch_to_device(batch, "cpu").items()}
    with torch.no_grad(), bf16_weights(port.parameters()):
        raw = port.eval()(inputs)
    assert seen["proj_l"] == (torch.bfloat16, torch.bfloat16)
    assert jdt["proj_l/__call__"] == jnp.bfloat16
    layers = [n for n in seen if n != "proj_l"]
    assert len(layers) == 2 + 2 + 3
    assert all(seen[n] == (torch.float32, torch.float32) for n in layers)
    jlayers = [k for k in jdt if "/layer_" in k and k.endswith("__call__")
               and k.count("/") == 2]
    assert len(jlayers) == 2 + 2 + 3
    assert all(jdt[k] == jnp.float32 for k in jlayers)
    assert raw["embedding_per_ROIs"].dtype == torch.float32
    assert raw["binary_classification"].dtype == torch.float32
