"""Training runtime (counterpart of multimodal_neuroimage_tpu/train/trainer.py).

``Trainer(cfg)`` indexes the cohort on disk that ``cfg`` points at
(data/index.py) and splits it by subject (data/splits.py ``SplitManager``);
``Trainer(cfg, train_records, val_records)`` takes in-memory records
shaped as the ``Predictor``'s requests plus a target (the flagship's
``{subject, fmri (84, T), struct (84, 84), target}``, HCP's ``{subject,
fmri (22, T), target}``, the structural datasets' ``{subject, dti | smri |
struct | smri and dti, target}``). Either way the batches come from one
``DataPipeline`` (data/loader.py: shuffled drop-last train batches, eval
batches padded to ``batch_size`` with ``valid``; in the device gear the
raw series band-split on the device a batch), and the loop is the JAX
Trainer's (``train_epoch``, ``eval_epoch``, ``training``, ``testing``):
one K5 step a train batch, a validation pass, subject-level metrics
without the pad rows, and the best-AUROC checkpoint (port format, frozen
``val_threshold`` in its metadata) that ``serve/predictor.py`` loads.

``Trainer(cfg, sets=["test"]).testing()`` evaluates the test split.

Weights come as the JAX Trainer restores them (``_restore_weights``): when
the experiment folder holds a checkpoint, the newest by mtime resumes the
run whole (weights, K5's moments and counts, the host generator, the next
epoch, that file's frozen ``val_threshold``, the best-so-far metrics of the
BEST files); otherwise ``cfg.model_weights_path`` is merged into the fresh
weights by ``partial_restore`` (phase chaining; ``val_threshold`` stays
None, so ``testing`` fits the threshold on the test split as JAX's step 4
does, ROADMAP F9); otherwise the run starts from ``init_random_weights``.
Each epoch writes the BEST files of ``BestCheckpointPolicy`` and then, with
``save_last_epoch``, the rolling ``{title}_last_epoch.ckpt``. A loss that
is not finite is reported with its batch's subjects (``nan_audit``,
JAX ``_audit_nans``), read once an epoch. ``accumulation_steps`` k > 1
applies K5 every k train batches to their mean gradient (JAX
``optax.MultiSteps``).

Randomness is explicit: weights from ``init_random_weights`` seeded by
``cfg.seed``, the train order from ``numpy.random.default_rng((cfg.seed,
epoch))`` as in the JAX package, and every dropout seed / DropPath factor
from one host ``torch.Generator`` seeded by ``cfg.seed`` and saved in every
checkpoint; a run repeats exactly, and a resumed run repeats the
uninterrupted one (at ``augment_prob`` 0: the augmentation draws from its
own generator in the loader's threads).

Not here yet, each with its ROADMAP item: Optuna, the writer and grad-norm
logging (M13), multi-GPU (M11).
``cfg.compute_dtype`` reaches the train, eval and predict steps (the bf16
policy of train/state.py; HCP's K6 route keeps a bf16 stream through K6's
bf16 form); the float32 masters, checkpoints and K5 are the same under
either policy.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
    BestCheckpointPolicy, key_patterns, latest_checkpoint, load_checkpoint,
    partial_restore, save_checkpoint)
from multimodal_neuroimage_tpu_torch.data.loader import DataPipeline
from multimodal_neuroimage_tpu_torch.evaluation.metrics import (
    SubjectAccumulator)
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (
    make_eval_step, make_train_step, optimizer_from_config)


class Trainer:
    def __init__(self, cfg, train_records: Optional[List[Mapping]] = None,
                 val_records: Optional[List[Mapping]] = None,
                 device: str = "cuda",
                 experiment_folder: Optional[str] = None,
                 sets: Optional[List[str]] = None):
        self.cfg = cfg
        self.device = device
        self.sets = list(sets or ["train", "val"])
        if train_records is None and val_records is None:
            self.pipeline = DataPipeline(cfg, device=device)
        else:
            self.pipeline = DataPipeline(
                cfg, splits={"train": list(train_records or []),
                             "val": list(val_records or [])}, device=device)
        training = "train" in self.sets
        steps = self.pipeline.steps_per_epoch("train")
        if training and steps == 0:
            raise ValueError(
                f"train split has {len(self.pipeline.splits['train'])} "
                f"subjects but one batch needs {cfg.batch_size}: zero train "
                f"steps")
        self.steps_per_epoch = steps
        self.last_folder = experiment_folder or cfg.experiment_folder
        folder = self.last_folder or cfg.log_dir
        self.model = init_random_weights(
            create_model(cfg), torch.Generator().manual_seed(cfg.seed))
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.epoch0 = 0
        self.global_step = 0
        self.val_threshold: Optional[float] = None
        self.checkpoint_path: Optional[str] = None
        resumed = self._restore_weights(folder)
        self.model.to(device)
        self.loss_specs = active_losses(
            cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss,
            use_unet_loss=cfg.use_unet_loss, use_cont_loss=cfg.use_cont_loss,
            use_mask_loss=cfg.use_mask_loss)
        self.optimizer = None
        if training:
            self.optimizer, self.schedule = optimizer_from_config(
                cfg, self.model.parameters(), steps)
            self.train_step = make_train_step(
                self.model, self.loss_specs, self.optimizer,
                cfg.compute_dtype, device)
            if resumed is not None:
                self._resume_optimizer(resumed)
        self.eval_step = make_eval_step(self.model, self.loss_specs,
                                        cfg.compute_dtype, device)
        self.accumulator = SubjectAccumulator(cfg.fine_tune_task)
        self.ckpt_policy = BestCheckpointPolicy(
            folder, cfg.experiment_title or cfg.exp_name, cfg.fine_tune_task)
        self.ckpt_policy.resume()
        self.pred_key = cfg.fine_tune_task
        self.loss_history: Dict[str, List[float]] = {"train": [], "val": [],
                                                     "test": []}
        self.step_losses: List[float] = []
        self.nan_subjects: Dict[str, set] = {}
        self._audit_queue: List[Tuple[List, Dict]] = []

    def _restore_weights(self, folder: str) -> Optional[Dict]:
        """JAX ``Trainer._restore_weights``: resume from the newest
        checkpoint in ``folder`` (returned, for the optimizer and generator
        once they exist), else chain from ``cfg.model_weights_path`` by
        ``partial_restore``, else keep the random weights."""
        resume = latest_checkpoint(folder) if folder else None
        if resume:
            ckpt = load_checkpoint(resume)
            self.model.load_state_dict(ckpt["state_dict"])
            self.epoch0 = ckpt["epoch"] + 1
            self.global_step = ckpt["step"]
            self.val_threshold = ckpt["metadata"].get("val_threshold")
            if ckpt["generator"] is not None:
                self.generator.set_state(ckpt["generator"])
            self.checkpoint_path = resume
            print(f"resumed from {resume} (next epoch {self.epoch0})")
            return ckpt
        path = self.cfg.model_weights_path
        if path:
            merged, stats, copied = partial_restore(
                self.model.state_dict(), load_checkpoint(path)["state_dict"],
                load_cls_embedding=self.cfg.load_cls_embedding)
            self.model.load_state_dict(merged)
            self.checkpoint_path = path
            print(f"phase-chained weights from {path}: {stats}; copied "
                  f"{len(copied)} tensors: {', '.join(key_patterns(copied))}")
        elif "train" not in self.sets:
            print(f"[testing] WARNING: no checkpoint in {folder!r} and no "
                  f"model_weights_path: testing the random initial weights")
        return None

    def _resume_optimizer(self, ckpt: Dict) -> None:
        if ckpt["optimizer"] is None:
            print(f"[ckpt] {self.checkpoint_path} holds no optimizer state "
                  f"(written before the train state was saved): resuming "
                  f"with a fresh optimizer (Adam moments and the LR "
                  f"schedule restart)")
            return
        self.optimizer.load_state(ckpt["optimizer"])

    def batches(self, split: str, epoch: int = 0, shuffle: bool = False
                ) -> Iterator[Tuple[Dict, List]]:
        """Batches of one split on the device (``DataPipeline.epoch``): the
        train split drops its last partial batch (reference
        dataloaders.py:139), the others pad it (name None, ``valid`` 0)."""
        return self.pipeline.epoch(split, epoch, shuffle)

    def _record(self, preds, batch, names, mode: str) -> None:
        """Window scores to the accumulator, without pad rows (JAX
        ``_drop_padded``)."""
        if self.pred_key not in preds:
            return
        keep = [i for i, n in enumerate(names) if n is not None]
        scores = preds[self.pred_key].cpu().numpy().reshape(-1)
        targets = np.asarray(batch["target"]).reshape(-1)
        self.accumulator.append([names[i] for i in keep], scores[keep],
                                targets[keep], mode)

    def _audit_nans(self, losses: Dict, names: List) -> None:
        """Queue a batch's losses for the NaN audit (JAX ``_audit_nans``),
        read in one transfer by ``_flush_nan_audit``."""
        if self.cfg.nan_audit:
            self._audit_queue.append((list(names), dict(losses)))

    def _flush_nan_audit(self) -> None:
        """Print, and keep in ``nan_subjects``, the subjects of every batch
        whose loss of one kind was not finite."""
        if not self._audit_queue:
            return
        kinds = sorted({k for _, ls in self._audit_queue for k in ls})
        values = torch.stack([
            torch.stack([ls[k].detach().float().reshape(())
                         if k in ls else ls["total"].new_zeros(())
                         for k in kinds])
            for _, ls in self._audit_queue]).cpu()
        for (names, ls), row in zip(self._audit_queue, values):
            for k, v in zip(kinds, row.tolist()):
                if k in ls and not math.isfinite(v):
                    self.nan_subjects.setdefault(k, set()).update(
                        n for n in names if n is not None)
                    print(f"[nan-audit] non-finite {k} loss; subjects "
                          f"{names}")
        self._audit_queue = []

    def train_epoch(self, epoch: int) -> float:
        totals = []
        for batch, names in self.batches("train", epoch, shuffle=True):
            losses, preds = self.train_step(batch, self.generator)
            self.global_step += 1
            self._audit_nans(losses, names)
            totals.append(float(losses["total"]))
            self._record(preds, batch, names, "train")
        self.step_losses.extend(totals)
        return float(np.mean(totals))

    def eval_epoch(self, mode: str = "val") -> float:
        """Mean loss over the split's subjects (each batch's loss excludes
        its pad rows and is weighted by its real ones)."""
        totals, weights = [], []
        for batch, names in self.batches(mode):
            losses, preds = self.eval_step(batch)
            self._audit_nans(losses, names)
            totals.append(float(losses["total"]))
            weights.append(sum(n is not None for n in names))
            self._record(preds, batch, names, mode)
        return (float(np.average(totals, weights=weights)) if totals
                else math.nan)

    def training(self) -> Dict[str, float]:
        """The epoch loop from ``epoch0`` (after a resume, the epoch after
        the checkpoint's); returns the last epoch's metric summary."""
        metrics: Dict[str, float] = {}
        for epoch in range(self.epoch0, self.cfg.nEpochs):
            t0 = time.time()
            self.loss_history["train"].append(self.train_epoch(epoch))
            self.loss_history["val"].append(self.eval_epoch("val"))
            self._flush_nan_audit()
            metrics = self.accumulator.summary(
                ["train", "val"], val_threshold=self.val_threshold)
            self.accumulator.reset()
            self._checkpoint(epoch, metrics)
            print(f"epoch {epoch}: train loss "
                  f"{self.loss_history['train'][-1]:.4f}, val loss "
                  f"{self.loss_history['val'][-1]:.4f}, "
                  f"val_AUROC {metrics.get('val_AUROC', float('nan')):.4f} "
                  f"({time.time() - t0:.1f} s)")
        return metrics

    def testing(self) -> Dict[str, float]:
        """The test split at the restored ``val_threshold`` (JAX
        ``testing``; reference trainer.py:571-582): frozen when a checkpoint
        of this folder was restored, else None and fitted on the test
        split."""
        if "test" not in self.pipeline.splits:
            raise ValueError("no test split: in-memory records give train "
                             "and val only")
        self.loss_history["test"].append(self.eval_epoch("test"))
        self._flush_nan_audit()
        metrics = self.accumulator.summary(
            ["test"], val_threshold=self.val_threshold)
        self.accumulator.reset()
        return metrics

    def _checkpoint(self, epoch: int, metrics: Dict[str, float]) -> None:
        threshold = metrics.get("val_best_threshold")
        if threshold is not None:
            self.val_threshold = threshold
        state = dict(state_dict=self.model.state_dict(),
                     optimizer=self.optimizer.state(),
                     step=self.global_step, epoch=epoch,
                     generator=self.generator.get_state())
        metadata = {"val_threshold": self.val_threshold, "metrics": metrics,
                    "epoch": epoch, "step": self.global_step}
        self.ckpt_policy.update(
            metadata=metadata, val_auroc=metrics.get("val_AUROC"),
            val_acc=metrics.get("val_Balanced_Accuracy"),
            val_loss=self.loss_history["val"][-1], **state)
        if self.cfg.save_last_epoch and self.last_folder:
            # the rolling per-epoch file, after the BEST files: the newest
            # file, which a resume reads, is the last completed epoch
            save_checkpoint(os.path.join(
                self.ckpt_policy.folder,
                f"{self.ckpt_policy.title}_last_epoch.ckpt"),
                metadata=metadata, **state)

    def best_checkpoint(self) -> Optional[str]:
        path = os.path.join(self.ckpt_policy.folder,
                            f"{self.ckpt_policy.title}_BEST_val_AUROC.ckpt")
        return path if os.path.exists(path) else None
