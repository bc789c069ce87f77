"""Hyperparameter study (counterpart of
multimodal_neuroimage_tpu/hpo/optuna_harness.py).

The reference's Optuna loop (reference main.py:362-498): a TPE sampler and
a median pruner over {lr_init, lr_gamma, weight_decay, dropout, batch
size, layers, heads}, each trial a ``Trainer`` run of ``opt_num_epochs``
epochs that reports its objective every epoch and may be pruned
(trainer.py:319-331), and the best parameters dumped to
``best_params.pkl`` / ``.txt`` (main.py:491-498). Optuna is used when it
imports; otherwise a built-in random search with the MedianPruner's rules
runs the same search space and writes the same files.

One difference from the JAX harness: a trial that fails other than by
pruning ends the study with its error. A study on the card must not count
a kernel's or the device's fault as a failed trial and go on.

One process only: under ``torch.distributed`` with a world size above 1
the trial broadcasts raise, naming ROADMAP M11.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np

SEARCH_SPACE = {
    # (kind, low, high/choices, log) - reference main.py:399-422
    "lr_init": ("float", 1e-5, 1e-3, True),
    "lr_gamma": ("float", 0.90, 0.99, False),   # 'gamma' (main.py:514-517)
    "weight_decay": ("float", 1e-5, 1e-2, True),
    "transformer_dropout_rate": ("float", 0.0, 0.5, False),
    "batch_size": ("cat", [4, 8, 16], None, False),
    "transformer_hidden_layers": ("cat", [4, 8, 16], None, False),
    "num_heads_2DBert": ("cat", [4, 6, 12], None, False),
}


def _world_size() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _single_process(what: str) -> None:
    if _world_size() > 1:
        raise NotImplementedError(
            f"{what}: a study across processes (the leader's trial broadcast "
            f"and the followers' loop) is not ported yet (ROADMAP M11)")


def broadcast_params(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The leader's trial parameters on every process: one process only."""
    _single_process("broadcast_params")
    return overrides or {}


def broadcast_flag(flag: bool) -> bool:
    """The leader's pruning decision on every process: one process only."""
    _single_process("broadcast_flag")
    return flag


class SyncedTrial:
    """An optuna or fallback trial whose pruning decision would be the
    leader's on every process (JAX ``SyncedTrial``); one process here."""

    def __init__(self, inner=None):
        self.inner = inner
        self.number = inner.number if inner is not None else -1
        self.params = getattr(inner, "params", {})

    def report(self, value: float, step: int) -> None:
        if self.inner is not None:
            self.inner.report(value, step)

    def should_prune(self) -> bool:
        local = self.inner.should_prune() if self.inner is not None else False
        return broadcast_flag(local)


def _suggest(trial, cfg) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for name, (kind, lo, hi, log) in SEARCH_SPACE.items():
        if kind == "float":
            overrides[name] = trial.suggest_float(name, lo, hi, log=log)
        else:
            overrides[name] = trial.suggest_categorical(name, lo)
    return overrides


def _objective_value(cfg, metrics, trainer) -> float:
    if cfg.fine_tune_task == "binary_classification":
        return metrics.get("val_AUROC", 0.0)
    hist = trainer.writer.loss_history.get("total_val_loss_history", [])
    return hist[-1] if hist else float("inf")


def _dump_best(cfg, params: Dict[str, Any], value: float) -> None:
    folder = cfg.experiment_folder or "."
    with open(os.path.join(folder, "best_params.pkl"), "wb") as f:
        pickle.dump(params, f)
    with open(os.path.join(folder, "best_params.txt"), "w") as f:
        f.write(f"objective: {value}\n")
        for k, v in params.items():
            f.write(f"{k}: {v}\n")


def _is_pruned(e: BaseException) -> bool:
    return type(e).__name__ in ("TrialPruned", "_Pruned")


def run_study(cfg, device: str = "cuda") -> Dict[str, Any]:
    """Run ``cfg.num_trials`` trials, each a ``Trainer`` on ``device`` in
    ``<experiment_folder>/trial_<n>``; dump and return the best."""
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    _single_process("run_study")

    def train_trial(trial) -> float:
        overrides = broadcast_params(_suggest(trial, cfg))
        trial_cfg = dataclasses.replace(
            cfg, nEpochs=cfg.opt_num_epochs, use_optuna=False,
            experiment_folder=os.path.join(
                cfg.experiment_folder or ".", f"trial_{trial.number}"),
            **overrides)
        trainer = Trainer(trial_cfg, device=device)
        trainer.optuna_trial = SyncedTrial(trial)
        metrics = trainer.training()
        return _objective_value(cfg, metrics, trainer)

    try:
        import optuna
    except ImportError:
        return _fallback_random_search(cfg, train_trial)
    direction = ("maximize" if cfg.fine_tune_task == "binary_classification"
                 else "minimize")
    storage = f"sqlite:///{cfg.experiment_folder or '.'}/optuna.db"
    study = optuna.create_study(
        study_name=cfg.exp_name, direction=direction, storage=storage,
        load_if_exists=True, sampler=optuna.samplers.TPESampler(),
        pruner=optuna.pruners.MedianPruner())
    study.optimize(train_trial, n_trials=cfg.num_trials)
    _dump_best(cfg, study.best_params, study.best_value)
    return {"best_value": study.best_value, **study.best_params}


class _FallbackTrial:
    """optuna.Trial's suggest_* and report / should_prune with the
    MedianPruner's defaults (reference main.py:453): no pruning until
    ``N_STARTUP_TRIALS`` trials completed and past ``N_WARMUP_STEPS``; then
    prune when the trial's best value so far is worse than the median of
    the completed trials' values at its latest step."""

    N_STARTUP_TRIALS = 5   # optuna.pruners.MedianPruner defaults
    N_WARMUP_STEPS = 0

    def __init__(self, number: int, rng: np.random.Generator,
                 history: Dict[int, Dict[int, float]], maximize: bool,
                 completed: Optional[set] = None):
        self.number = number
        self._rng = rng
        self._history = history
        self._completed = completed if completed is not None else set()
        self._maximize = maximize
        self.params: Dict[str, Any] = {}
        self._reports: Dict[int, float] = {}

    def suggest_float(self, name, lo, hi, log=False):
        if log:
            v = float(np.exp(self._rng.uniform(np.log(lo), np.log(hi))))
        else:
            v = float(self._rng.uniform(lo, hi))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        v = choices[int(self._rng.integers(len(choices)))]
        self.params[name] = v
        return v

    def report(self, value: float, step: int) -> None:
        self._reports[step] = value
        self._history.setdefault(self.number, {})[step] = value

    def should_prune(self) -> bool:
        if not self._reports:
            return False
        step = max(self._reports)
        if step < self.N_WARMUP_STEPS:
            return False
        peers = [n for n in self._completed if n != self.number]
        if len(peers) < self.N_STARTUP_TRIALS:
            return False
        at_step = [self._history[n][step] for n in peers
                   if step in self._history.get(n, {})]
        if not at_step:
            return False
        med = float(np.median(at_step))
        best = (max if self._maximize else min)(self._reports.values())
        return best < med if self._maximize else best > med


class _Pruned(Exception):
    pass


def _fallback_random_search(cfg, train_trial) -> Dict[str, Any]:
    """The study without optuna: ``cfg.num_trials`` trials drawn from one
    numpy generator seeded by ``cfg.seed`` (JAX's draws, parameter for
    parameter); a pruned trial is skipped, any other error raises."""
    maximize = cfg.fine_tune_task == "binary_classification"
    rng = np.random.default_rng(cfg.seed)
    history: Dict[int, Dict[int, float]] = {}
    completed: set = set()
    best_value = -np.inf if maximize else np.inf
    best_params: Dict[str, Any] = {}
    for n in range(cfg.num_trials):
        trial = _FallbackTrial(n, rng, history, maximize, completed)
        try:
            value = train_trial(trial)
        except Exception as e:
            if not _is_pruned(e):
                raise
            print(f"trial {n} pruned")
            continue
        completed.add(n)
        better = value > best_value if maximize else value < best_value
        if better:
            best_value, best_params = value, dict(trial.params)
    _dump_best(cfg, best_params, best_value)
    return {"best_value": best_value, **best_params}


# ---------------------------------------------------------------------------
# Best-param reload (reference main.py:501-522)
# ---------------------------------------------------------------------------

def load_best_params(cfg) -> Dict[str, Any]:
    """The newest ``best_params.pkl`` of this experiment: the run's own
    folder first, then ``<base>/experiments/*<exp_name>*/``. The file is
    one that a study of this program wrote."""
    candidates = []
    if cfg.experiment_folder:
        candidates += glob.glob(os.path.join(cfg.experiment_folder,
                                             "best_params.pkl"))
    candidates += glob.glob(os.path.join(cfg.base_path, "experiments",
                                         f"*{cfg.exp_name}*",
                                         "best_params.pkl"))
    if not candidates:
        return {}
    path = max(candidates, key=os.path.getmtime)
    with open(path, "rb") as f:
        params = pickle.load(f)
    print(f"[hpo] loaded best params from {path}: {params}")
    return params


def apply_best_params(cfg):
    """The tuned parameters over the config (reference main.py:501-522;
    its 'gamma' is ``lr_gamma`` here)."""
    params = load_best_params(cfg)
    if not params:
        print("[hpo] use_best_params_from_optuna set but no best_params.pkl "
              "found: training with the configured defaults")
        return cfg
    fields = {f.name for f in dataclasses.fields(type(cfg))}
    params = {k: v for k, v in params.items() if k in fields}
    return dataclasses.replace(cfg, **params).validate()
