"""Loss histories, CSV dumps and the wandb sink (counterpart of
multimodal_neuroimage_tpu/obs/writer.py).

The reference's Writer (reference loss_writer.py:19-160): each loss's
window of (value, weight) pairs, the train windows truncated to
``running_mean_size`` (loss_writer.py:147-155); ``loss_summary`` (running
means to histories, loss_writer.py:58-73); ``full_scores.csv`` by
``zip_longest`` of every history (loss_writer.py:48-55); the per-subject
predictions of each evaluation, ``per_subject_predictions/iter_N.txt``
(loss_writer.py:91-93); wandb once an epoch (loss_writer.py:130-145).
wandb is imported only when asked for, and left out when its package is
missing, as in the JAX package. JAX's TensorBoard sink has no counterpart:
importing TensorBoard loads TensorFlow, and with it JAX where that is
installed, and the port runs without JAX.

Across ranks (parallel/mesh.py) the losses a step hands over are averaged
already and the metrics are global, so rank 0 alone writes
``full_scores.csv`` and ``per_subject_predictions/`` (every rank's
subjects) and alone feeds wandb. This differs from the JAX Writer, which
writes on every host into its own folder: the ranks of one node share the
experiment folder.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from itertools import zip_longest
from typing import Dict, List, Optional

import torch

from multimodal_neuroimage_tpu_torch.parallel.mesh import rank


class Writer:
    def __init__(self, log_dir: str, sets: List[str],
                 running_mean_size: int = 5000,
                 use_wandb: bool = False,
                 wandb_kwargs: Optional[Dict] = None):
        self.log_dir = log_dir
        self.sets = sets
        self.running_mean_size = running_mean_size
        self.loss_values: Dict[str, List] = defaultdict(list)  # (value, weight)
        self.loss_history: Dict[str, List[float]] = defaultdict(list)
        self.metric_history: Dict[str, List[float]] = defaultdict(list)
        self.current_metrics: Dict[str, float] = {}
        self.eval_iter = 0
        self.total_train_steps = 0
        os.makedirs(log_dir, exist_ok=True)
        self.per_subject_dir = os.path.join(log_dir, "per_subject_predictions")
        os.makedirs(self.per_subject_dir, exist_ok=True)

        self.wandb = None
        if use_wandb and rank() == 0:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(dir=log_dir, **(wandb_kwargs or {}))
                self.wandb = wandb

    # -- losses ---------------------------------------------------------------
    def write_losses(self, loss_dict: Dict[str, torch.Tensor], set_name: str,
                     weight: float = 1.0) -> None:
        """Append a step's losses (loss_writer.py:147-155), kept as device
        scalars until ``loss_summary``. ``weight`` (an eval batch's share
        of real rows) keeps the pad rows of a padded tail out of the
        averages."""
        for name, value in loss_dict.items():
            key = f"{name}_{set_name}"
            vals = self.loss_values[key]
            vals.append((value, weight))
            if set_name == "train":
                del vals[:-self.running_mean_size]
        if set_name == "train":
            self.total_train_steps += 1

    def fetch(self) -> None:
        """Every recorded device scalar to a Python float, in one transfer
        (a stack on the device, then one copy); the windows keyed in sorted
        order, as JAX's ``device_get`` of them leaves them (and so orders
        the histories and full_scores.csv's columns)."""
        self.loss_values = defaultdict(list, sorted(self.loss_values.items()))
        tensors = [v for vals in self.loss_values.values() for v, _ in vals
                   if torch.is_tensor(v)]
        if not tensors:
            return
        host = iter(torch.stack([t.detach().float().reshape(())
                                 for t in tensors]).cpu().tolist())
        for vals in self.loss_values.values():
            vals[:] = [(next(host) if torch.is_tensor(v) else v, w)
                       for v, w in vals]

    def loss_summary(self, lr: float = 0.0) -> Dict[str, float]:
        """Running means -> histories (loss_writer.py:58-73);
        the eval windows start afresh, the train window runs on."""
        out: Dict[str, float] = {}
        self.metric_history["lr"].append(lr)
        self.fetch()
        for key, vals in self.loss_values.items():
            if not vals:
                continue
            wsum = sum(w for _, w in vals)
            mean = float(sum(float(v) * w for v, w in vals)
                         / max(wsum, 1e-12))
            self.loss_history[f"{key}_loss_history"].append(mean)
            out[key] = mean
        for key in list(self.loss_values):
            if not key.endswith("_train"):
                self.loss_values[key] = []
        return out

    def write_norms(self, norms: Dict[str, torch.Tensor], step: int) -> None:
        """Per-module parameter and gradient norms (the reference's
        ``wandb.watch``, trainer.py:94-97) into wandb and the
        full_scores.csv history; one transfer for the step's norms."""
        names = list(norms)
        values = torch.stack([torch.as_tensor(norms[n]).float().reshape(())
                              for n in names]).cpu().tolist()
        payload = {}
        for name, v in zip(names, values):
            payload[f"norm/{name}"] = v
            self.metric_history[f"norm/{name}"].append(v)
        if self.wandb is not None:
            self.wandb.log({"step": step, **payload})

    # -- metrics ----------------------------------------------------------------
    def record_metrics(self, metrics: Dict[str, float]) -> None:
        self.current_metrics = dict(metrics)
        for name, value in metrics.items():
            self.metric_history[name].append(value)
            print(f"{name}: {value}")
        self.eval_iter += 1

    def write_subject_predictions(self, accumulator) -> None:
        """Per-subject prediction dump (loss_writer.py:91-93): every rank
        gathers the rows, rank 0 writes them."""
        rows = {mode: accumulator.per_subject(mode) for mode in self.sets}
        if rank() != 0:
            return
        path = os.path.join(self.per_subject_dir,
                            f"iter_{self.eval_iter}.txt")
        with open(path, "a+") as f:
            for mode in self.sets:
                subs, means, stds, truths = rows[mode]
                for s, m, sd, t in zip(subs, means, stds, truths):
                    f.write(f"subject:{s} ({mode})\n"
                            f"outputs: {m:.4f}±{sd:.4f}  -  truth: {t}\n")

    def save_history_to_csv(self) -> str:
        """full_scores.csv via zip_longest (loss_writer.py:48-55), written
        by rank 0; returns its path on every rank."""
        rows = {**self.loss_history, **self.metric_history}
        path = os.path.join(self.log_dir, "full_scores.csv")
        if rank() != 0:
            return path
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            keys = list(rows)
            w.writerow(keys)
            for tup in zip_longest(*[rows[k] for k in keys], fillvalue=""):
                w.writerow(tup)
        return path

    def register_wandb(self, epoch: int, lr: float) -> None:
        if self.wandb is None:
            return
        payload = {"epoch": epoch, "lr": lr}
        for key, hist in self.loss_history.items():
            if hist:
                payload[key] = hist[-1]
        payload.update(self.current_metrics)
        self.wandb.log(payload)
