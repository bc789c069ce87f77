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

A trial that runs out of device memory (``torch.cuda.OutOfMemoryError``:
a batch size of the space too large for the card) is recorded as failed,
as JAX's harness records a trial that raises (``catch=(RuntimeError,)``
for optuna, ``trial {n} failed: ...`` in the fallback), and the study goes
on; the failed trial's model, optimizer and batches are dropped and the
allocator's cache emptied before the next. Every other error ends the
study, a kernel's build or launch error among them (ops/build.py raises
``RuntimeError("... cudaError ...")``, which is not an out-of-memory
error): unlike JAX's fallback, which passes over any ``Exception``, a study
on the card must not count a kernel's or the device's fault as a failed
trial and go on.

Across ranks (parallel/mesh.py) rank 0 is the leader and owns the study,
as in the JAX harness (reference main.py:440-460): it announces each trial's
parameters, the followers train the same trial, every pruning decision is
the leader's, and the end is a stop message. Every message is one pickled
object in a fixed buffer broadcast over the host (gloo) group, and the
ranks compare their counts of messages before each, so that a desync
raises on every rank; an error on the leader mid-trial is relayed as an
abort, so that every rank raises together and the study ends everywhere.
An error in a training or evaluation step on any rank raises on every
rank at the same step (train/state.py, parallel/mesh.py ``agreed``). An
out-of-memory error then fails the trial: the leader sends the trial's
failure, which every follower awaits, and the study goes on with every
rank's count of messages equal. Any other error ends the study on every
rank, through the leader's abort.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.parallel.mesh import (
    broadcast_buffer, gather_objects, maybe_initialize_distributed, rank,
    world)

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


_BCAST_BYTES = 4096


class TrialAborted(Exception):
    """The leader announced a failure of the running trial: every rank
    raises it."""


class _Channel:
    """The leader's messages to the followers (JAX ``_broadcast_obj``):
    rank 0's pickled object in one fixed ``_BCAST_BYTES`` buffer on every
    rank, so no interleaving of messages can put the ranks into collectives
    of different shapes. Before each message the ranks compare their counts
    of messages taken, and all raise if any differs (JAX's sequence check,
    which raises on the drifted process alone). A payload too large for the
    buffer goes out as an error, which every rank raises together."""

    def __init__(self):
        self.seq = 0

    def send(self, obj: Optional[Any]) -> Any:
        counts = gather_objects(self.seq)
        if len(set(counts)) > 1:
            raise RuntimeError(f"study broadcast desync: the ranks have "
                               f"taken {counts} messages")
        buf = np.zeros(_BCAST_BYTES, np.uint8)
        if rank() == 0:
            raw = pickle.dumps(obj)
            if len(raw) > _BCAST_BYTES - 4:
                raw = pickle.dumps({
                    "error": f"broadcast payload too large ({len(raw)} > "
                             f"{_BCAST_BYTES - 4} bytes)"})
            buf[:4] = np.frombuffer(len(raw).to_bytes(4, "little"), np.uint8)
            buf[4:4 + len(raw)] = np.frombuffer(raw, np.uint8)
        out = broadcast_buffer(buf)
        n = int.from_bytes(out[:4].tobytes(), "little")
        msg = pickle.loads(out[4:4 + n].tobytes())
        self.seq += 1
        if isinstance(msg, dict) and "error" in msg:
            raise ValueError(msg["error"])
        return msg


_CHANNEL = _Channel()


def broadcast_params(overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """The leader's trial parameters on every rank (identity on one)."""
    if world() == 1:
        return overrides or {}
    return _CHANNEL.send(overrides or {})


def broadcast_flag(flag: bool) -> bool:
    """The leader's pruning decision on every rank (identity on one). A
    follower that receives an abort instead raises ``TrialAborted``."""
    if world() == 1:
        return flag
    msg = _CHANNEL.send({"kind": "prune", "flag": bool(flag)})
    if isinstance(msg, dict) and msg.get("kind") == "prune":
        return msg["flag"]
    if isinstance(msg, dict) and msg.get("kind") == "abort":
        raise TrialAborted(msg.get("reason", "the leader's trial failed"))
    raise RuntimeError(f"study broadcast desync: rank {rank()} expected a "
                       f"pruning decision, the leader sent {msg!r}")


class SyncedTrial:
    """An optuna or fallback trial whose pruning decision is the leader's
    on every rank (JAX ``SyncedTrial``): every rank stops a pruned trial
    after the same epoch. A follower holds no trial (``inner`` None)."""

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


def _release_device_memory() -> None:
    """After a trial that ran out of memory: its trainer, model, optimizer
    and batches went with its error; collect what cycles hold and return
    the allocator's cached blocks to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_study(cfg, device: str = "cuda") -> Dict[str, Any]:
    """Run ``cfg.num_trials`` trials, each a ``Trainer`` on ``device`` in
    ``<experiment_folder>/trial_<n>``; dump and return the best. Across
    ranks rank 0 runs the study and returns it; the followers train each
    announced trial until the stop message and return {} (module
    docstring)."""
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    device = maybe_initialize_distributed(cfg, device)
    multi = world() > 1

    def run_trial(overrides, number, trial) -> float:
        trial_cfg = dataclasses.replace(
            cfg, nEpochs=cfg.opt_num_epochs, use_optuna=False,
            experiment_folder=os.path.join(
                cfg.experiment_folder or ".", f"trial_{number}"),
            **overrides)
        trainer = Trainer(trial_cfg, device=device)
        trainer.optuna_trial = SyncedTrial(trial)
        metrics = trainer.training()
        return _objective_value(cfg, metrics, trainer)

    aborted = []

    def train_trial(trial) -> float:
        overrides = _suggest(trial, cfg)
        if multi:
            overrides = _CHANNEL.send({"kind": "trial", "params": overrides,
                                       "number": trial.number})["params"]
        try:
            return run_trial(overrides, trial.number, trial)
        except torch.cuda.OutOfMemoryError as e:
            failure = str(e)
        except Exception as e:
            # a pruned trial stopped every rank at the same epoch already;
            # any other error of the leader's reaches the followers at
            # their next pruning decision and ends the study everywhere
            if multi and not _is_pruned(e):
                aborted.append(e)
                _CHANNEL.send({"kind": "abort", "reason": repr(e)})
            raise
        # out of memory, on every rank at the same step: the error (and the
        # trial's tensors with it) is gone; the study records it as failed
        _release_device_memory()
        if multi:
            _CHANNEL.send({"kind": "failed", "number": trial.number})
        raise torch.cuda.OutOfMemoryError(failure)

    if multi and rank() != 0:
        while True:
            msg = _CHANNEL.send(None)
            if msg.get("kind") == "stop":
                return {}
            if msg.get("kind") == "abort":
                raise TrialAborted(msg.get("reason"))
            if msg.get("kind") != "trial":
                raise RuntimeError(f"study broadcast desync: rank {rank()} "
                                   f"expected a trial, got {msg!r}")
            try:
                run_trial(msg["params"], msg["number"], None)
                continue
            except TrialAborted:
                raise
            except torch.cuda.OutOfMemoryError:
                pass
            except Exception as e:
                if _is_pruned(e):
                    continue
                # the same error on the leader is relayed as an abort;
                # wait for it, so that no rank is left in a collective
                reply = _CHANNEL.send(None)
                if reply.get("kind") == "abort":
                    raise TrialAborted(reply.get("reason")) from e
                raise
            # out of memory on every rank: the leader records the failure
            _release_device_memory()
            reply = _CHANNEL.send(None)
            if reply.get("kind") == "abort":
                raise TrialAborted(reply.get("reason"))
            if reply.get("kind") != "failed":
                raise RuntimeError(f"study broadcast desync: rank {rank()} "
                                   f"expected the trial's failure, got "
                                   f"{reply!r}")

    try:
        try:
            import optuna
        except ImportError:
            return _fallback_random_search(cfg, train_trial)
        direction = ("maximize"
                     if cfg.fine_tune_task == "binary_classification"
                     else "minimize")
        storage = f"sqlite:///{cfg.experiment_folder or '.'}/optuna.db"
        study = optuna.create_study(
            study_name=cfg.exp_name, direction=direction, storage=storage,
            load_if_exists=True, sampler=optuna.samplers.TPESampler(),
            pruner=optuna.pruners.MedianPruner())
        study.optimize(train_trial, n_trials=cfg.num_trials,
                       catch=(torch.cuda.OutOfMemoryError,))
        _dump_best(cfg, study.best_params, study.best_value)
        return {"best_value": study.best_value, **study.best_params}
    finally:
        if multi and not aborted:
            _CHANNEL.send({"kind": "stop"})


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
    parameter); a pruned trial is skipped, one out of memory recorded as
    failed, any other error raises."""
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
        except torch.cuda.OutOfMemoryError as e:
            print(f"trial {n} failed: {e}")
            continue
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
