"""The port across ranks (parallel/mesh.py) against the JAX package on the
CPU. Ranks are real processes under gloo (tests/dist_cases.py ``spawn``:
a port from ``bind(0)``, a timeout of their own), one thread each.

* Two ranks of the tiny flagship (float32, dropout off, batch 2 a rank)
  take two AdamW steps: their parameters are bitwise equal, each step's
  averaged gradient and its losses are JAX's ``make_train_step(...,
  mesh=build_mesh((2,)), spmd="shard_map")`` at the global batch of 4 on
  the same weights (JAX's step under ``optax.sgd(1)`` gives the gradient,
  AdamW is applied in float64), and the parameters after both steps are
  that AdamW's, all at rtol 2e-4 / atol 1e-4.
* The same for phase 2's two-channel net with the merge loss, which couples
  the rows of a batch: the port matches JAX's ``shard_map`` step (the loss
  within each rank's rows) and not its GSPMD step (over the global batch).
* ``DataPipeline`` at (W = 2, r) yields JAX's rows, train order and padded
  eval tails (JAX's with ``jax.process_count`` / ``process_index``
  monkeypatched).
* ``gather_ragged`` of two ranks' arrays of different lengths is their
  concatenation; the subject metrics of two ranks are the one-process
  metrics of all subjects.
* A Trainer on two ranks, on a cohort on disk: rank 0 alone writes the
  checkpoints, ``full_scores.csv``, the per-subject predictions and
  ``predictions.csv``; both ranks report the same metrics and threshold; a
  resume continues bitwise; ``run_predict`` returns every subject on both
  ranks, as one process does.
* At dropout > 0 the ranks' seeds, DropPath factors and masks differ, and
  rank 0 draws what one process draws at the global batch (its forward
  is that process's first rows, to float32 rounding).
* A two-trial study on two ranks: the follower trains the leader's trial
  parameters; a desync raises on every rank, and the leader's failure
  reaches the follower.
* The refusals: ``spmd_mode="gspmd"`` above one rank, a ``mesh_shape``
  other than ``(W,)``, other ``mesh_axes``, ``WORLD_SIZE`` > 1 without
  ``distributed``, and the zero-step error naming the global batch.
* The kernel library's launch-device guard and its build lock.
"""

import dataclasses
import functools
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import combiner_cases as cc
import dist_cases as dc
from __graft_entry__ import _flagship_cfg
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.data import loader as jloader
from multimodal_neuroimage_tpu.models import fmri_nets as jnets
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.nn import bert as jbert
from multimodal_neuroimage_tpu.parallel.mesh import (build_mesh, replicate,
                                                     shard_batch)
from multimodal_neuroimage_tpu.train.losses import active_losses as jactive
from multimodal_neuroimage_tpu.train.state import TrainState
from multimodal_neuroimage_tpu.train.state import (
    make_train_step as jmake_train_step)
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data import loader as tloader
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.evaluation.metrics import (
    SubjectAccumulator)
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn import common as tcommon
from multimodal_neuroimage_tpu_torch.ops import build
from multimodal_neuroimage_tpu_torch.parallel import mesh
from multimodal_neuroimage_tpu_torch.serve.predictor import run_predict
from multimodal_neuroimage_tpu_torch.train import trainer as ttrainer
from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LR, WD = 1e-5, 1e-2
B1, B2, EPS = 0.9, 0.999, 1e-8


# ---- two ranks' steps against JAX's shard_map step -------------------------------


def _global_batches(keys_shapes, targets, n=2):
    """``n`` global batches of 4 rows drawn from numpy."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(10 + i)
        b = {k: rng.normal(size=s).astype(np.float32)
             for k, s in keys_shapes.items()}
        b["target"] = np.asarray(targets, np.float32)
        out.append(b)
    return out


def _adamw(p, g, m, v, t):
    """One AdamW update in float64 (K5's and optax's formula) on pytrees."""
    m = jax.tree_util.tree_map(lambda a, b: B1 * a + (1 - B1) * b, m, g)
    v = jax.tree_util.tree_map(lambda a, b: B2 * a + (1 - B2) * b * b, v, g)
    bc1, bc2 = 1 / (1 - B1 ** t), 1 / (1 - B2 ** t)
    p = jax.tree_util.tree_map(
        lambda x, a, b: x - LR * (a * bc1 / (np.sqrt(b * bc2) + EPS)
                                  + WD * x), p, m, v)
    return p, m, v


def _jax_steps(jmodel, specs, params, batches, spmd):
    """JAX's step on a two-device mesh over ``batches``: each step's losses
    and averaged gradient (the step under ``optax.sgd(1)``, gradient = the
    parameters' change), AdamW applied in float64 between steps; returns
    (losses, gradients as port state) per step and the final parameters as
    port state."""
    jmesh = build_mesh((2,), devices=jax.devices()[:2])
    sgd = optax.sgd(1.0)
    step = jmake_train_step(jmodel, specs, compute_dtype="float32",
                            mesh=jmesh, spmd=spmd, donate=False)
    p = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), params)
    m = jax.tree_util.tree_map(np.zeros_like, p)
    v = jax.tree_util.tree_map(np.zeros_like, p)
    out = []
    for t, batch in enumerate(batches, 1):
        p32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                     p)
        state = TrainState(step=jnp.asarray(t - 1), params=replicate(
            p32, jmesh), opt_state=replicate(sgd.init(p32), jmesh),
            rng=jax.random.PRNGKey(0), tx=sgd)
        new, losses, _ = step(state, shard_batch(batch, jmesh))
        g = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a, np.float64) - np.asarray(b,
                                                                np.float64),
            p32, jax.device_get(new.params))
        out.append(({k: float(v) for k, v in losses.items()},
                    jax_params_to_state_dict(g)))
        p, m, v = _adamw(p, g, m, v, t)
    return out, jax_params_to_state_dict(p)


def _check_ranks_against(ranks, want_steps, want_params):
    r0, r1 = ranks
    for name, t in r0["params"].items():
        assert torch.equal(t, r1["params"][name]), name
    for i, (want_losses, want_grads) in enumerate(want_steps):
        assert r0["losses"][i] == r1["losses"][i]
        for k, v in want_losses.items():
            cc.close(r0["losses"][i][k], v, f"step {i} loss {k}")
        assert set(r0["grads"][i]) == set(want_grads)
        for name, g in r0["grads"][i].items():
            assert torch.equal(g, r1["grads"][i][name]), name
            cc.close(g, want_grads[name], f"step {i} grad {name}")
    for name, t in r0["params"].items():
        cc.close(t, want_params[name], f"param {name}")


def test_two_ranks_of_the_flagship_match_jax_shard_map(tmp_path):
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2, **cc.NO_DROPOUT).validate()
    jmodel = jcreate(jcfg)
    R = jcfg.intermediate_vec
    batches = _global_batches({
        "fmri_raw_sequence": (4, 32, R), "fmri_lowfreq_sequence": (4, 32, R),
        "fmri_ultralowfreq_sequence": (4, 32, R), "struct": (4, R, R)},
        [0.0, 1.0, 1.0, 0.0])
    params = cc.random_params(jmodel, {k: v[:2] for k, v in
                                       batches[0].items()})
    want_steps, want_params = _jax_steps(
        jmodel, jactive(jcfg.task, jcfg.fine_tune_task), params, batches,
        "shard_map")
    cfg = dataclasses.asdict(Config(**dataclasses.asdict(jcfg)))
    ranks = dc.spawn("step", {
        "cfg": {**cfg, "distributed": True},
        "state": jax_params_to_state_dict(params), "batches": batches,
        "lr": LR, "weight_decay": WD}, tmp_path)
    _check_ranks_against(ranks, want_steps, want_params)


def test_merge_loss_couples_each_rank_as_jax_shard_map_not_gspmd(
        tmp_path, monkeypatch):
    """Phase 2's two-channel net with ``use_merge_loss`` (the cosine of
    every pair of the batch's rows): the port's two ranks take JAX's
    shard_map step, and JAX's GSPMD step, whose merge loss spans the global
    batch, is far from it. JAX's two-channel BERTs fix an attention dropout
    of 0.1, zeroed on both sides."""
    monkeypatch.setattr(jnets, "TemporalBert", functools.partial(
        jbert.TemporalBert, attn_dropout=0.0))
    jcfg = JConfig(**cc.FMRI_TINY, fmri_multimodality_type="two_channels",
                   use_merge_loss=True, batch_size=2,
                   compute_dtype="float32").validate()
    jmodel = jcreate(jcfg)
    T, R = jcfg.sequence_length, jcfg.intermediate_vec
    batches = _global_batches({k: (4, T, R) for k in (
        "fmri_sequence", "fmri_lowfreq_sequence",
        "fmri_ultralowfreq_sequence")}, [0.0, 1.0, 1.0, 0.0])
    params = cc.random_params(jmodel, {k: v[:2] for k, v in
                                       batches[0].items()})
    specs = jactive(jcfg.task, jcfg.fine_tune_task, use_merge_loss=True)
    assert set(specs) == {"merge", "binary_classification"}
    want_steps, want_params = _jax_steps(jmodel, specs, params, batches,
                                         "shard_map")
    gspmd_steps, _ = _jax_steps(jmodel, specs, params, batches[:1], "gspmd")
    cfg = dataclasses.asdict(Config(**dataclasses.asdict(jcfg)))
    ranks = dc.spawn("step", {
        "cfg": {**cfg, "distributed": True},
        "state": jax_params_to_state_dict(params), "batches": batches,
        "lr": LR, "weight_decay": WD, "no_bert_dropout": True}, tmp_path)
    _check_ranks_against(ranks, want_steps, want_params)
    assert cc.bound_ratio(ranks[0]["grads"][0], gspmd_steps[0][1]) > 10
    assert abs(ranks[0]["losses"][0]["merge"]
               - gspmd_steps[0][0]["merge"]) > 1e-3


# ---- the loader, the gather ---------------------------------------------------


@pytest.fixture(scope="module")
def smri_cohort(tmp_path_factory):
    """22 subjects: 3 train steps of a global batch of 4 and padded tails
    in val and test."""
    root = str(tmp_path_factory.mktemp("dist") / "cohort")
    return tsyn.generate_synthetic_cohort(root, n_subjects=22, seed=2)


def _smri_cfg(root, **kw):
    base = dict(task="VIT", step=3, dataset_name="sMRI", target="sex",
                size_of_model="small", batch_size=2, nEpochs=1, workers=1,
                compute_dtype="float32", preprocess="host",
                experiment_title="t")
    return tsyn.synthetic_config(root, **{**base, **kw}).validate()


@pytest.mark.parametrize("r", [0, 1])
def test_loader_rows_and_tails_match_jax(smri_cohort, monkeypatch, r):
    cfg = _smri_cfg(smri_cohort)
    monkeypatch.setattr(tloader, "world", lambda: 2)
    monkeypatch.setattr(tloader, "rank", lambda: r)
    monkeypatch.setattr(jloader.jax, "process_count", lambda: 2)
    monkeypatch.setattr(jloader.jax, "process_index", lambda: r)
    port = tloader.DataPipeline(cfg, device="cpu")
    jpipe = jloader.DataPipeline(JConfig(**dataclasses.asdict(cfg)))
    assert port.steps_per_epoch() == jpipe.steps_per_epoch() == \
        len(port.splits["train"]) // 4
    for split, shuffle in (("train", True), ("val", False),
                           ("test", False)):
        got = list(port._batches(split, 1, shuffle))
        want = list(jpipe._batches(split, 1, shuffle))
        assert len(got) == len(want) > 0, split
        for (gb, gn), (wb, wn) in zip(got, want):
            assert gn == wn, split
            for k in ("smri", "target") + (("valid",) if split != "train"
                                           else ()):
                np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    tail = list(port._batches("val", 0, False))[-1][1]
    assert len(tail) == 2


def test_ragged_gather_and_global_metrics(tmp_path):
    rng = np.random.default_rng(4)
    subs = [f"s{i}" for i in range(11)]
    scores = rng.normal(size=11)
    truths = (np.arange(11) % 3 == 0).astype(float)
    halves = [(subs[:4], scores[:4], truths[:4]),
              (subs[4:], scores[4:], truths[4:])]
    parts = [np.arange(3, dtype=np.float64), np.arange(10, 15.0)]
    ranks = dc.spawn("gather", {"parts": parts, "subjects": halves},
                     tmp_path)
    one = SubjectAccumulator()
    one.append(subs, scores, truths, "val")
    want = one.summary(["val"])
    for got in ranks:
        np.testing.assert_array_equal(got["ragged"], np.concatenate(parts))
        np.testing.assert_array_equal(got["stacked"], [[0, 10], [1, 11]])
        assert got["per_subject"][0] == subs
        assert got["summary"]["val_AUROC"] == want["val_AUROC"]
        assert got["summary"] == pytest.approx(want)


# ---- a Trainer, the draws, the study across two ranks --------------------------


def test_trainer_on_two_ranks(smri_cohort, tmp_path):
    cfg = dict(task="VIT", step=3, dataset_name="sMRI", target="sex",
               size_of_model="small", batch_size=2, workers=1,
               compute_dtype="float32", preprocess="host",
               experiment_title="t", drop_path_rate=0.2)
    ranks = dc.spawn("trainer", {"root": smri_cohort, "cfg": cfg,
                                 "out": str(tmp_path)}, tmp_path,
                     timeout=300)
    r0, r1 = ranks
    assert r0["steps"] == 3
    files = ("_BEST_val_AUROC.ckpt", "_last_epoch.ckpt", "full_scores.csv",
             "predictions.csv", "per_subject_predictions")
    for f in files:
        assert any(f in w for w in r0["written"]), f
    assert not any(f in w or w.endswith(".tmp") for w in r1["written"]
                   for f in files), r1["written"]
    assert r0["metrics"] == r1["metrics"] and "val_AUROC" in r0["metrics"]
    assert r0["threshold"] == r1["threshold"] is not None
    assert r0["epoch0"] == r1["epoch0"] == 1
    for rk in ranks:
        for name, t in rk["whole"]["params"].items():
            assert torch.equal(t, r0["whole"]["params"][name]), name
            assert torch.equal(rk["resumed"]["params"][name], t), name
        assert torch.equal(rk["resumed"]["mu"], rk["whole"]["mu"])
        assert torch.equal(rk["resumed"]["generator"],
                           rk["whole"]["generator"])
    assert r0["resumed"]["step_losses"] == r0["whole"]["step_losses"][3:]
    # every subject on both ranks, as one process serves them
    one = run_predict(_smri_cfg(smri_cohort, nEpochs=2, experiment_folder=str(
        tmp_path / "b")), device="cpu")
    assert r0["predictions"] == r1["predictions"]
    assert set(r0["predictions"]) == set(one)
    for s, v in one.items():
        assert r0["predictions"][s]["score"] == pytest.approx(v["score"],
                                                              rel=1e-5)


def test_dropout_draws_fold_the_rank(tmp_path):
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2, fusion_drop_path_rate=0.3)
    cfg = Config(**dataclasses.asdict(jcfg))
    port = create_model(cfg)
    state = {k: v.clone() for k, v in port.state_dict().items()}
    batch = _global_batches({
        "fmri_raw_sequence": (2, 32, 48), "fmri_lowfreq_sequence": (2, 32, 48),
        "fmri_ultralowfreq_sequence": (2, 32, 48), "struct": (2, 48, 48)},
        [0.0, 1.0], n=1)[0]
    r0, r1 = dc.spawn("draws", {"cfg": dataclasses.asdict(cfg),
                                "state": state, "batch": batch}, tmp_path)
    # one process at the global batch of 8
    gen = torch.Generator().manual_seed(7)
    seeds = [tcommon.draw_seed(gen) for _ in range(3)]
    factors = tcommon.drop_path_factors((8, 2), 0.5, gen)
    seed = tcommon.draw_seed(gen)
    mask = tcommon.dropout(torch.ones(4, 3, 16), 0.5, seed)
    assert r0["seeds"] == seeds and r1["seeds"] != seeds
    assert torch.equal(r0["factors"], factors[:4])
    assert torch.equal(r1["factors"], factors[4:])
    assert torch.equal(r0["mask"], mask) and not torch.equal(r1["mask"],
                                                            mask)
    assert torch.equal(r0["state"], gen.get_state())
    assert torch.equal(r1["state"], gen.get_state())
    # both ranks forward the same 2 rows: rank 0's are the first 2 of one
    # process's forward of the global batch (both ranks' rows)
    port.load_state_dict(state)
    with torch.no_grad():
        one = port.train()(batch_to_device(
            {k: np.concatenate([v, v]) for k, v in batch.items()}, "cpu"),
            generator=torch.Generator().manual_seed(3))[
                "binary_classification"]
    cc.close(r0["logits"], one[:2], "rank 0", rtol=1e-6, atol=1e-7)
    assert float((r1["logits"] - r0["logits"]).abs().max()) > 1e-3


def _study_payload(root, tmp_path, **kw):
    cfg = dict(task="VIT", step=3, dataset_name="sMRI", target="sex",
               size_of_model="small", batch_size=2, workers=1,
               compute_dtype="float32", preprocess="host", nEpochs=5,
               num_trials=2, opt_num_epochs=1, experiment_title="hpo",
               exp_name="hpo", seed=5,
               experiment_folder=str(tmp_path / "exp"), **kw)
    return {"root": root, "cfg": cfg}


def test_two_rank_study_follows_the_leader(smri_cohort, tmp_path):
    lead, follow = dc.spawn("study", _study_payload(smri_cohort, tmp_path),
                            tmp_path, timeout=300)
    assert len(lead["trained"]) == 2
    assert follow["trained"] == lead["trained"]
    assert follow["result"] == {} and "best_value" in lead["result"]
    with open(tmp_path / "exp" / "best_params.pkl", "rb") as f:
        best = pickle.load(f)
    assert {k: lead["result"][k] for k in best} == best


def test_study_desync_raises_on_every_rank(tmp_path):
    for got in dc.spawn("desync", {}, tmp_path):
        assert got["raised"] is not None and "desync" in got["raised"]


def test_leader_failure_ends_the_study_on_every_rank(smri_cohort, tmp_path):
    lead, follow = dc.spawn("abort", _study_payload(smri_cohort, tmp_path),
                            tmp_path, timeout=300)
    assert lead["raised"].startswith("OSError: disk full")
    assert follow["raised"].startswith("TrialAborted")
    assert "disk full" in follow["raised"]


@pytest.mark.parametrize("fault", ["oom", "kernel"])
def test_follower_fault_in_a_trial(smri_cohort, tmp_path, fault):
    """The follower runs out of memory in trial 1: both ranks leave that
    trial at the same step, the leader records it as failed, trial 2 runs
    on both, and the ranks end with the same count of messages. The
    launcher's own error there instead ends the study on both ranks."""
    payload = _study_payload(smri_cohort, tmp_path)
    payload["cfg"]["num_trials"] = 3
    payload["fault"] = fault
    lead, follow = dc.spawn("fault", payload, tmp_path, timeout=300)
    if fault == "kernel":
        assert lead["trained"] == follow["trained"] == ["trial_0", "trial_1"]
        assert lead["raised"] == "RuntimeError: the step failed on rank 1"
        assert follow["raised"].startswith("TrialAborted")
        return
    want = ["trial_0", "trial_1", "trial_2"]
    assert lead["trained"] == follow["trained"] == want
    assert lead["raised"] is follow["raised"] is None
    assert lead["seq"] == follow["seq"] > 0
    assert follow["result"] == {} and "best_value" in lead["result"]
    with open(tmp_path / "fault.0.log") as f:
        assert "trial 1 failed: out of memory on rank 1" in f.read()


# ---- refusals, the launch guard, the build lock -------------------------------


@pytest.mark.parametrize("change,world,match", [
    (dict(spmd_mode="gspmd"), 2, "gspmd"),
    (dict(mesh_shape=(4,)), 2, "mesh_shape"),
    (dict(mesh_shape=(2,)), 1, "mesh_shape"),
    (dict(mesh_axes=("data", "model")), 2, "mesh_axes"),
])
def test_parallel_config_refusals(change, world, match):
    cfg = dataclasses.replace(Config(), **change)
    with pytest.raises(ValueError, match=match):
        mesh.check_parallel_config(cfg, world)
    mesh.check_parallel_config(Config(mesh_shape=(world,)), world)
    mesh.check_parallel_config(Config(spmd_mode="shard_map"), world)


def test_world_size_without_distributed_raises(monkeypatch, capsys):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--distributed"):
        mesh.maybe_initialize_distributed(Config(), "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK", raising=False)
    assert mesh.maybe_initialize_distributed(
        Config(distributed=True), "cpu") == "cpu"
    assert "running as one process" in capsys.readouterr().out
    assert not mesh.initialized() and mesh.world() == 1


def test_zero_steps_name_the_global_batch(monkeypatch):
    monkeypatch.setattr(tloader, "world", lambda: 2)
    monkeypatch.setattr(ttrainer, "world", lambda: 2)
    recs = [{"subject": f"s{i}", "smri": np.eye(84), "target": float(i % 2)}
            for i in range(3)]
    cfg = Config(task="VIT", step=3, dataset_name="sMRI", target="sex",
                 size_of_model="small", batch_size=2,
                 preprocess="host").validate()
    with pytest.raises(ValueError, match=r"global batch needs 4 \("
                                         r"batch_size=2 x 2 rank"):
        ttrainer.Trainer(cfg, recs, recs, device="cpu")


def test_kernel_call_passes_tensors_as_pointers():
    """``KernelLibrary.call`` hands a tensor argument over as its data
    pointer (the first one's device made current for the launch on a
    card) and raises on a nonzero return."""
    lib = object.__new__(build.KernelLibrary)
    seen = []

    def launch(*args):
        seen.append(args)
        return 0 if len(seen) == 1 else 2

    lib._fns = {"launch": launch}
    lib._lib = type("L", (), {"kernels_error_string": staticmethod(
        lambda e: b"out of memory")})
    x = torch.ones(3)
    lib.call("launch", 1, x, 2.5, None)
    assert seen[0] == (1, x.data_ptr(), 2.5, None)
    with pytest.raises(RuntimeError, match="launch failed: cudaError 2"):
        lib.call("launch", x)


def test_build_lock_compiles_once(tmp_path, monkeypatch):
    """Two builders of one source hash at once: one compiles, the other
    waits for the lock and loads the same library."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(build, "SOURCE_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    compiled = []
    gate = threading.Event()

    def compile_(cu, out):
        compiled.append(out)
        gate.wait(5)
        out.write_bytes(b"so")
        return out, 1.0, "log"

    monkeypatch.setattr(build, "_compile", compile_)
    results = []
    threads = [threading.Thread(target=lambda: results.append(build.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for _ in range(100):          # the first holds the lock, compiling
        if compiled:
            break
        threading.Event().wait(0.05)
    threading.Event().wait(0.2)   # the second is waiting for the lock
    gate.set()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert len(compiled) == 1 and len(results) == 2
    assert results[0][0] == results[1][0] == compiled[0]
    assert sorted(r[1] for r in results) == [0.0, 1.0]
