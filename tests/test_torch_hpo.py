"""The hyperparameter study, the port against the JAX package on the CPU
(hpo/optuna_harness.py):

* the search space is JAX's, and the fallback's trial parameters for one
  seed equal JAX's draw for draw;
* the MedianPruner cases of tests/test_round3_hpo_cli.py, on the port's
  fallback trial (JAX's giving the same answers);
* a pruned trial is skipped; a trial out of device memory is recorded as
  failed and the study goes on, as JAX's fallback records a trial that
  raises (the same printed line, completed trials, best parameters and
  files on the same seed), its memory released before the next trial;
  any other failure ends the study with its error (the port's one
  difference: no fault of the device or a kernel passes as a failed
  trial); across processes the trial parameters and pruning decisions are
  the leader's, sent over one fixed-size buffer (tests/test_torch_dist.py
  runs a study on two ranks, and one whose follower runs out of memory);
* a 2-trial ``run_study`` on an on-disk cohort writes ``best_params.pkl``
  with JAX's keys, and ``apply_best_params`` reads them back into the
  config (the CLI's ``--use_best_params_from_optuna``).
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_cfg
from multimodal_neuroimage_tpu.hpo import optuna_harness as joh
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as toh

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1234])
def test_fallback_trial_parameters_equal_jax(seed):
    assert toh.SEARCH_SPACE == joh.SEARCH_SPACE
    cfg = _flagship_cfg()
    trng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for n in range(4):
        tt = toh._FallbackTrial(n, trng, {}, True)
        jt = joh._FallbackTrial(n, jrng, {}, True)
        got, want = toh._suggest(tt, cfg), joh._suggest(jt, cfg)
        assert got == want and tt.params == jt.params == want
        assert {type(v) for v in got.values()} == {type(v) for v in
                                                    want.values()}


def _trials(mod, number, history, completed, maximize=True):
    return mod._FallbackTrial(number, np.random.default_rng(0), history,
                              maximize, completed)


def _pruner_case(mod, case):
    """The four MedianPruner cases of tests/test_round3_hpo_cli.py:25-90;
    the trial's ``should_prune()`` at the end."""
    history, completed = {}, set()
    peers = {"strong_early": (5, [(0.5, 0.55, 0.6)], True),
             "startup": (4, [(0.9,)], True),
             "below_median": (5, [(0.8,)], True),
             "below_median_min": (5, [(0.2,)], False),
             "best_governs": (5, [(0.5, 0.5)], True)}[case]
    n_peers, (curve,), maximize = peers
    for n in range(n_peers):
        t = _trials(mod, n, history, completed, maximize)
        for step, v in enumerate(curve):
            t.report(v, step)
        completed.add(n)
    t = _trials(mod, n_peers, history, completed, maximize)
    reports = {"strong_early": [0.9], "startup": [0.01],
               "below_median": [0.1], "below_median_min": [0.9],
               "best_governs": [0.7, 0.3]}[case]
    for step, v in enumerate(reports):
        t.report(v, step)
    return t.should_prune()


@pytest.mark.parametrize("case,pruned", [
    ("strong_early", False), ("startup", False), ("below_median", True),
    ("below_median_min", True), ("best_governs", False)])
def test_median_pruner_semantics(case, pruned):
    assert _pruner_case(toh, case) is pruned
    assert _pruner_case(joh, case) is pruned


def test_pruned_trials_are_skipped_and_failures_end_the_study(tmp_path,
                                                              capsys):
    cfg = dataclasses.replace(_flagship_cfg(), num_trials=3,
                              experiment_folder=str(tmp_path))

    def prune_first(trial):
        if trial.number == 0:
            raise toh._Pruned()
        return 0.5 + 0.1 * trial.number

    out = toh._fallback_random_search(cfg, prune_first)
    assert out["best_value"] == pytest.approx(0.7)
    assert "trial 0 pruned" in capsys.readouterr().out

    def kernel_fault(trial):
        raise RuntimeError("bert_layer_forward failed: cudaError 1")

    with pytest.raises(RuntimeError, match="cudaError"):
        toh._fallback_random_search(cfg, kernel_fault)


@pytest.mark.parametrize("task,objective", [
    ("binary_classification", 0.625), ("regression", 0.75)])
def test_trainer_reports_the_study_objective_and_prunes(task, objective):
    """The Trainer reports each epoch the value the study ranks by
    (``_objective_value``: val_AUROC, else the last val loss) and stops a
    trial the pruner cuts (the harness's ``_Pruned``, or optuna's
    ``TrialPruned`` where optuna imports)."""
    import types
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    reported = []

    class Trial:
        def report(self, value, step):
            reported.append((value, step))

        def should_prune(self):
            return len(reported) > 1

    cfg = dataclasses.replace(_flagship_cfg(), fine_tune_task=task)
    trainer = types.SimpleNamespace(
        cfg=cfg, optuna_trial=Trial(), writer=types.SimpleNamespace(
            loss_history={"total_val_loss_history": [0.9, objective]}))
    metrics = {"val_AUROC": 0.625}
    Trainer._optuna_report(trainer, 0, metrics)
    with pytest.raises(Exception) as pruned:
        Trainer._optuna_report(trainer, 1, metrics)
    assert toh._is_pruned(pruned.value)   # optuna's TrialPruned where it imports
    assert reported == [(objective, 0), (objective, 1)]
    assert toh._objective_value(cfg, metrics, trainer) == objective


def test_more_than_one_process_names_m11(monkeypatch):
    """More than one process (ROADMAP M11, ported): the leader's trial
    parameters and pruning flag reach every rank through one fixed-size
    buffer (here a leader's broadcast on one process, the ranks' message
    counts agreeing); a payload too large for the buffer raises; on one
    process both are the identity."""
    sent = []
    monkeypatch.setattr(toh, "world", lambda: 2)
    monkeypatch.setattr(toh, "gather_objects", lambda n: [n, n])
    monkeypatch.setattr(toh, "broadcast_buffer",
                        lambda buf: sent.append(buf.shape) or buf)
    monkeypatch.setattr(toh, "_CHANNEL", toh._Channel())
    assert toh.broadcast_params({"lr_init": 1e-4}) == {"lr_init": 1e-4}
    assert toh.SyncedTrial(None).should_prune() is False
    assert sent == [(toh._BCAST_BYTES,)] * 2 and toh._CHANNEL.seq == 2
    with pytest.raises(ValueError, match="payload too large"):
        toh.broadcast_params({"x": "y" * toh._BCAST_BYTES})
    monkeypatch.setattr(toh, "gather_objects", lambda n: [n, n + 1])
    with pytest.raises(RuntimeError, match="desync"):
        toh.broadcast_flag(True)
    monkeypatch.undo()
    assert toh.broadcast_params(None) == {} and toh.broadcast_flag(True)


def test_two_trial_study_writes_jax_keys_and_round_trips(tmp_path,
                                                         monkeypatch):
    """The tiny flagship on a 14-subject cohort of 48 ROIs, 1 epoch a
    trial; batch size and depth drawn from one value each (the CPU's time),
    every other parameter from JAX's space."""
    root = str(tmp_path / "cohort")
    tsyn.generate_synthetic_cohort(root, n_subjects=14, seed=3, n_rois=48)
    fdir = os.path.join(root, "data", "fmri_timeseries")
    for sub in os.listdir(fdir):
        key = sub[len("sub-"):]
        os.rename(os.path.join(fdir, sub, f"desikankilliany_sub-{key}.npy"),
                  os.path.join(fdir, sub, f"harvard_oxford_sub-{key}.npy"))
    base = {k: v for k, v in dataclasses.asdict(_flagship_cfg(tiny=True))
            .items() if k != "base_path" and not k.endswith("_path")}
    base.update(batch_size=2, nEpochs=5, workers=1, num_trials=2,
                opt_num_epochs=1, experiment_title="hpo", exp_name="hpo",
                experiment_folder=str(tmp_path / "exp"), seed=5)
    cfg = tsyn.synthetic_config(root, **base).validate()
    monkeypatch.setitem(toh.SEARCH_SPACE, "batch_size",
                        ("cat", [2], None, False))
    monkeypatch.setitem(toh.SEARCH_SPACE, "transformer_hidden_layers",
                        ("cat", [1], None, False))
    out = toh.run_study(cfg, device="cpu")
    with open(tmp_path / "exp" / "best_params.pkl", "rb") as f:
        best = pickle.load(f)
    assert set(best) == set(joh.SEARCH_SPACE)
    assert {k: out[k] for k in best} == best
    assert sorted(os.listdir(tmp_path / "exp")) == [
        "best_params.pkl", "best_params.txt", "trial_0", "trial_1"]
    for n in range(2):
        assert os.path.exists(tmp_path / "exp" / f"trial_{n}" /
                              "full_scores.csv")
    tuned = toh.apply_best_params(dataclasses.replace(
        cfg, use_best_params_from_optuna=True))
    assert {k: getattr(tuned, k) for k in best} == best
    assert tuned.nEpochs == 5


def _objective(mod, cfg, error, completed):
    """A study's train_trial: the trial's draws, then trial 1 raising
    ``error``, every other trial returning a value of its draws."""
    def train_trial(trial):
        params = mod._suggest(trial, cfg)
        if trial.number == 1:
            raise error("CUDA out of memory (trial 1)")
        completed.append(trial.number)
        return params["lr_init"] * 1e3 + params["transformer_dropout_rate"]
    return train_trial


def test_out_of_memory_trial_is_failed_as_jax_records_it(tmp_path, capsys):
    """JAX's fallback (trial 1 raising RuntimeError) and the port's (trial 1
    raising torch.cuda.OutOfMemoryError) on one seed: the same printed
    line, completed trials, best parameters and files."""
    from multimodal_neuroimage_tpu_torch.config import Config
    jcfg = dataclasses.replace(_flagship_cfg(), num_trials=4, seed=7,
                               experiment_folder=str(tmp_path / "jax"))
    tcfg = Config(**{**dataclasses.asdict(jcfg),
                     "experiment_folder": str(tmp_path / "port")})
    os.makedirs(jcfg.experiment_folder)
    os.makedirs(tcfg.experiment_folder)
    jdone, tdone = [], []
    jout = joh._fallback_random_search(jcfg, _objective(joh, jcfg,
                                                        RuntimeError, jdone))
    jtext = capsys.readouterr().out
    tout = toh._fallback_random_search(tcfg, _objective(
        toh, tcfg, torch.cuda.OutOfMemoryError, tdone))
    ttext = capsys.readouterr().out
    assert "trial 1 failed: CUDA out of memory (trial 1)" in ttext
    assert ttext.splitlines() == jtext.splitlines()
    assert tdone == jdone == [0, 2, 3]
    assert tout == jout
    for name in ("best_params.pkl", "best_params.txt"):
        with open(os.path.join(jcfg.experiment_folder, name), "rb") as f:
            want = f.read()
        with open(os.path.join(tcfg.experiment_folder, name), "rb") as f:
            assert f.read() == want, name


@pytest.mark.parametrize("fault,ends", [
    ("oom", False), ("kernel", True)])
def test_run_study_goes_on_after_out_of_memory_only(fault, ends, tmp_path,
                                                    monkeypatch, capsys):
    """``run_study`` over Trainers whose trial 1 runs out of memory (the
    study goes on: trials 0 and 2 complete, the memory is released once) or
    meets the launcher's own error, ``RuntimeError("... cudaError ...")``
    (ops/build.py), which ends the study."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.train import trainer as tmod
    cfg = Config(**{**dataclasses.asdict(_flagship_cfg()), "num_trials": 3,
                    "seed": 3, "experiment_folder": str(tmp_path)})
    trained, released = [], []

    class Trainer:
        def __init__(self, c, device):
            self.number = int(c.experiment_folder.rsplit("_", 1)[1])
            self.writer = None

        def training(self):
            if self.number == 1:
                if fault == "oom":
                    raise torch.cuda.OutOfMemoryError(
                        "CUDA out of memory. Tried to allocate 2.00 GiB")
                raise RuntimeError("bert_layer_forward failed: cudaError 2")
            trained.append(self.number)
            return {"val_AUROC": 0.5 + 0.1 * self.number}

    monkeypatch.setattr(tmod, "Trainer", Trainer)
    monkeypatch.setattr(toh, "_release_device_memory",
                        lambda: released.append(True))
    if ends:
        with pytest.raises(RuntimeError, match="cudaError"):
            toh.run_study(cfg, device="cpu")
        assert trained == [0] and not released
        return
    out = toh.run_study(cfg, device="cpu")
    assert "trial 1 failed: CUDA out of memory" in capsys.readouterr().out
    assert trained == [0, 2] and released == [True]
    assert out["best_value"] == pytest.approx(0.7)
