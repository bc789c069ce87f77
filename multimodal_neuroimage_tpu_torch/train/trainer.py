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

Randomness is explicit (utils/reproducibility.py): weights from
``init_random_weights`` seeded by ``cfg.seed``, the train order from
``host_rng(cfg.seed, epoch)`` as in the JAX package, and every dropout
seed / DropPath factor from one host ``torch.Generator``
(``root_generator(cfg.seed)``), saved in every
checkpoint; a run repeats exactly, and a resumed run repeats the
uninterrupted one (at ``augment_prob`` 0: the augmentation draws from its
own generator in the loader's threads). On a CUDA device the Trainer
selects cuDNN's deterministic algorithms (utils/reproducibility.py
``deterministic_algorithms``): at cuDNN's default choice the backbone's
convolution gradients vary run to run, and a step would not repeat.

The run's outer shell is the JAX Trainer's: the losses of every step go
to a ``Writer`` (obs/writer.py) in the experiment folder (else
``cfg.log_dir``), which keeps the one record of them (running windows of
``running_mean_size`` train steps, a history an epoch) and writes
``full_scores.csv`` and ``per_subject_predictions/iter_N.txt`` (and wandb
where ``use_wandb`` asks and the package imports; no TensorBoard); with
``log_grad_norms_every`` N > 0 every N-th step's per-module parameter and
gradient norms join them (train/state.py ``param_grad_norms``);
``validation_frequency`` validates mid-epoch; ``profiling`` cuts the run
to 1 epoch and ``PROFILING_MAX_BATCHES`` batches a split, and
``profile_dir`` traces the run (obs/profiling.py ``profile_trace``: CPU and
CUDA activity, a Chrome trace); the task's
auxiliary losses all run, the perceptual one through
nn/perceptual.py's ``PerceptualLoss``; ``optuna_trial`` (set by
hpo/optuna_harness.py) is told each epoch's objective and may prune the
run.

Across GPUs (``cfg.distributed`` under ``torchrun``, parallel/mesh.py) the
Trainer is one rank of JAX's multi-process Trainer: it joins the process
group and takes ``cuda:{LOCAL_RANK}``; ``batch_size`` is per rank, so a
step's global batch is ``batch_size * W`` and the loader gives each rank
its rows; after the weights are restored every rank takes rank 0's flat
parameters and K5 state; each step averages the gradients and losses
(train/state.py); subject scores, NaN-audit subjects and metrics are
gathered across ranks, so every rank keeps the same ``val_threshold``;
rank 0 alone writes checkpoints, ``full_scores.csv`` and the per-subject
predictions, and a barrier comes before any rank reads a checkpoint
(resume, ``testing``).
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
from multimodal_neuroimage_tpu_torch.obs.profiling import (profile_trace,
                                                           trace_annotation)
from multimodal_neuroimage_tpu_torch.obs.writer import Writer
from multimodal_neuroimage_tpu_torch.parallel.mesh import (
    barrier, broadcast_, gather_objects, initialized,
    maybe_initialize_distributed, world)
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (
    make_eval_step, make_train_step, optimizer_from_config)
from multimodal_neuroimage_tpu_torch.utils.reproducibility import (
    deterministic_algorithms, root_generator)

PROFILING_MAX_BATCHES = 10  # --profiling cap (reference trainer.py:434-437)


class Trainer:
    def __init__(self, cfg, train_records: Optional[List[Mapping]] = None,
                 val_records: Optional[List[Mapping]] = None,
                 device: str = "cuda",
                 experiment_folder: Optional[str] = None,
                 sets: Optional[List[str]] = None):
        self.cfg = cfg
        device = maybe_initialize_distributed(cfg, device)
        self.device = device
        deterministic_algorithms(device)
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
                f"subjects but one global batch needs "
                f"{cfg.batch_size * world()} (batch_size={cfg.batch_size} x "
                f"{world()} rank(s)): zero train steps")
        self.steps_per_epoch = steps
        self.last_folder = experiment_folder or cfg.experiment_folder
        folder = self.last_folder or cfg.log_dir
        self.model = init_random_weights(
            create_model(cfg), root_generator(cfg.seed))
        self.generator = root_generator(cfg.seed)
        self.epoch0 = 0
        self.global_step = 0
        self.val_threshold: Optional[float] = None
        self.checkpoint_path: Optional[str] = None
        resumed = self._restore_weights(folder)
        self.model.to(device)
        self.loss_specs = active_losses(
            cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss,
            use_unet_loss=cfg.use_unet_loss, use_cont_loss=cfg.use_cont_loss,
            use_mask_loss=cfg.use_mask_loss,
            intensity_factor=cfg.intensity_factor,
            perceptual_factor=cfg.perceptual_factor,
            reconstruction_factor=cfg.reconstruction_factor)
        self.extra_loss_fns = None
        if "perceptual" in self.loss_specs:
            from multimodal_neuroimage_tpu_torch.nn.perceptual import (
                PerceptualLoss)
            self.extra_loss_fns = {"perceptual": PerceptualLoss(
                task=cfg.task, weights_npz=cfg.vgg_weights_npz or None,
                seed=cfg.seed, device=device)}
        self.optimizer = None
        if training:
            self.optimizer, self.schedule = optimizer_from_config(
                cfg, self.model.parameters(), steps)
            self.train_step = make_train_step(
                self.model, self.loss_specs, self.optimizer,
                cfg.compute_dtype, device, self.extra_loss_fns,
                cfg.log_grad_norms_every)
            if resumed is not None:
                self._resume_optimizer(resumed)
        self._sync_ranks()
        self.eval_step = make_eval_step(self.model, self.loss_specs,
                                        cfg.compute_dtype, device,
                                        self.extra_loss_fns)
        wandb_kwargs = {"project": cfg.wandb_project, "mode": cfg.wandb_mode,
                        "name": cfg.experiment_title or cfg.exp_name}
        if cfg.wandb_entity:
            wandb_kwargs["entity"] = cfg.wandb_entity
        if cfg.wandb_key:
            os.environ.setdefault("WANDB_API_KEY", cfg.wandb_key)
        self.writer = Writer(folder, self.sets, cfg.running_mean_size,
                             use_wandb=cfg.use_wandb,
                             wandb_kwargs=wandb_kwargs)
        self.accumulator = SubjectAccumulator(cfg.fine_tune_task)
        self.ckpt_policy = BestCheckpointPolicy(
            folder, cfg.experiment_title or cfg.exp_name, cfg.fine_tune_task)
        self.ckpt_policy.resume()
        self.pred_key = cfg.fine_tune_task
        self.optuna_trial = None  # set by hpo/optuna_harness.py
        self.nan_subjects: Dict[str, set] = {}
        self._audit_queue: List[Tuple[List, Dict]] = []

    @property
    def step_losses(self) -> List[float]:
        """The total loss of each train step in the Writer's running window
        (the last ``running_mean_size`` steps of this Trainer)."""
        self.writer.fetch()
        return [float(v) for v, _ in self.writer.loss_values["total_train"]]

    def _restore_weights(self, folder: str) -> Optional[Dict]:
        """JAX ``Trainer._restore_weights``: resume from the newest
        checkpoint in ``folder`` (returned, for the optimizer and generator
        once they exist), else chain from ``cfg.model_weights_path`` by
        ``partial_restore``, else keep the random weights. Across ranks a
        barrier first, so that no rank looks before rank 0's last write
        ends."""
        barrier()
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

    def _sync_ranks(self) -> None:
        """Rank 0's weights and K5 state on every rank, once (the port's
        ``replicate``): K5's flat parameters, moments and accumulated mean,
        or, without an optimizer, each parameter."""
        if not initialized():
            return
        with torch.no_grad():
            if self.optimizer is None:
                for p in self.model.parameters():
                    broadcast_(p.data)
                return
            for t in (self.optimizer.params, self.optimizer.mu,
                      self.optimizer.nu, self.optimizer.acc):
                if t is not None:
                    broadcast_(t)

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
        whose loss of one kind was not finite. The losses are averaged over
        the ranks, so a batch's subjects are every rank's (gathered)."""
        if not self._audit_queue:
            return
        if world() > 1:
            parts = gather_objects([names for names, _ in self._audit_queue])
            self._audit_queue = [
                ([n for part in parts for n in part[i]], ls)
                for i, (_, ls) in enumerate(self._audit_queue)]
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

    def train_epoch(self, epoch: int) -> None:
        """One pass over the train split (``PROFILING_MAX_BATCHES`` batches
        under ``profiling``): each step's losses to the Writer, the norms
        of every ``log_grad_norms_every``-th step after them, a validation
        every ``validation_frequency`` batches (reference
        trainer.py:439-453)."""
        cfg = self.cfg
        for i, (batch, names) in enumerate(
                self.batches("train", epoch, shuffle=True)):
            with trace_annotation("train_step"):
                losses, preds, norms = self.train_step(
                    batch, self.generator, self.global_step)
            self.global_step += 1
            self._audit_nans(losses, names)
            self.writer.write_losses(losses, "train")
            if norms is not None:
                self.writer.write_norms(norms, self.writer.total_train_steps)
            self._record(preds, batch, names, "train")
            if (i + 1) % cfg.validation_frequency == 0:
                self.eval_epoch("val")
                self._flush_nan_audit()
                metrics = self.accumulator.summary(
                    ["train", "val"], val_threshold=self.val_threshold)
                self.writer.record_metrics(metrics)
                self.accumulator.reset(keep_mode="train")
            if cfg.profiling and i + 1 >= PROFILING_MAX_BATCHES:
                break

    def eval_epoch(self, mode: str = "val") -> None:
        """One pass over an eval split (``PROFILING_MAX_BATCHES`` batches
        under ``profiling``); each batch's losses, which exclude its pad
        rows, go to the Writer weighted by its share of real rows."""
        for i, (batch, names) in enumerate(self.batches(mode)):
            with trace_annotation("eval_step"):
                losses, preds = self.eval_step(batch)
            self._audit_nans(losses, names)
            w = sum(n is not None for n in names) / max(len(names), 1)
            self.writer.write_losses(losses, mode, weight=w)
            self._record(preds, batch, names, mode)
            if self.cfg.profiling and i + 1 >= PROFILING_MAX_BATCHES:
                break

    def training(self) -> Dict[str, float]:
        """The epoch loop from ``epoch0`` (after a resume, the epoch after
        the checkpoint's; one epoch under ``profiling``), traced into
        ``profile_dir`` when set; returns the last epoch's metric
        summary."""
        cfg = self.cfg
        n_epochs = 1 if cfg.profiling else cfg.nEpochs
        metrics: Dict[str, float] = {}
        with profile_trace(cfg.profile_dir, self.device):
            for epoch in range(self.epoch0, n_epochs):
                t0 = time.time()
                self.train_epoch(epoch)
                self.eval_epoch("val")
                lr = float(self.schedule(self.global_step))
                means = self.writer.loss_summary(lr)
                self._flush_nan_audit()
                metrics = self.accumulator.summary(
                    ["train", "val"], val_threshold=self.val_threshold)
                self.writer.write_subject_predictions(self.accumulator)
                self.writer.record_metrics(metrics)
                self.writer.save_history_to_csv()
                self.writer.register_wandb(epoch, lr)
                self.accumulator.reset()
                self._checkpoint(epoch, metrics)
                print(f"epoch {epoch}: train loss "
                      f"{means.get('total_train', math.nan):.4f}, val loss "
                      f"{means.get('total_val', math.nan):.4f}, val_AUROC "
                      f"{metrics.get('val_AUROC', math.nan):.4f} "
                      f"({time.time() - t0:.1f} s)")
                if self.optuna_trial is not None:
                    self._optuna_report(epoch, metrics)
        return metrics

    def _optuna_report(self, epoch: int, metrics: Dict[str, float]) -> None:
        """The epoch's objective to the trial, which may prune the run
        (reference trainer.py:319-331): ``optuna.TrialPruned`` where optuna
        imports, else the harness's ``_Pruned``."""
        from multimodal_neuroimage_tpu_torch.hpo.optuna_harness import (
            _objective_value, _Pruned)
        self.optuna_trial.report(
            _objective_value(self.cfg, metrics, self), epoch)
        if self.optuna_trial.should_prune():
            try:
                import optuna
            except ImportError:
                raise _Pruned()
            raise optuna.TrialPruned()

    def testing(self) -> Dict[str, float]:
        """The test split at the restored ``val_threshold`` (JAX
        ``testing``; reference trainer.py:571-582): frozen when a checkpoint
        of this folder was restored, else None and fitted on the test
        split; the Writer's summary, files and metrics as after an
        epoch."""
        if "test" not in self.pipeline.splits:
            raise ValueError("no test split: in-memory records give train "
                             "and val only")
        self.eval_epoch("test")
        self.writer.loss_summary(0.0)
        self._flush_nan_audit()
        metrics = self.accumulator.summary(
            ["test"], val_threshold=self.val_threshold)
        self.writer.write_subject_predictions(self.accumulator)
        self.writer.record_metrics(metrics)
        self.writer.save_history_to_csv()
        self.accumulator.reset()
        return metrics

    def _checkpoint(self, epoch: int, metrics: Dict[str, float]) -> None:
        """The epoch's BEST and last-epoch files, written by rank 0
        (``save_checkpoint``); every rank keeps the validation threshold,
        since the metrics are global (JAX ``_checkpoint``). No barrier
        here: a reader waits at its own (``_restore_weights``), and a study
        relays a failed write at the next pruning decision
        (hpo/optuna_harness.py)."""
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
            val_loss=self.writer.loss_history.get(
                "total_val_loss_history", [None])[-1], **state)
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
