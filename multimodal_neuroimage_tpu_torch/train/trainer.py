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

``Trainer(cfg, sets=["test"]).testing()`` evaluates the test split with
the weights of ``cfg.model_weights_path`` or of the experiment folder's
best checkpoint (``ckpt/checkpoint.py`` ``default_checkpoint``), at the
``val_threshold`` frozen in it.

Randomness is explicit: weights from ``init_random_weights`` seeded by
``cfg.seed``, the train order from ``numpy.random.default_rng((cfg.seed,
epoch))`` as in the JAX package, and every dropout seed / DropPath factor
from one host ``torch.Generator`` seeded by ``cfg.seed``; a run repeats
exactly.

Not here yet, each with its ROADMAP item: auto-resume and
``partial_restore`` phase chaining (M5; training into a folder that holds a
checkpoint, or from ``model_weights_path``, raises), Optuna, the writer and
grad-norm logging, the NaN audit (M13), multi-GPU (M11).
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
    BestCheckpointPolicy, default_checkpoint, latest_checkpoint,
    load_checkpoint)
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
        folder = experiment_folder or cfg.experiment_folder or cfg.log_dir
        self.model = init_random_weights(
            create_model(cfg), torch.Generator().manual_seed(cfg.seed))
        self.val_threshold: Optional[float] = None
        if training:
            self._refuse_resume(folder)
        else:
            self._load_weights(folder)
        self.model.to(device)
        self.loss_specs = active_losses(
            cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss,
            use_unet_loss=cfg.use_unet_loss, use_cont_loss=cfg.use_cont_loss,
            use_mask_loss=cfg.use_mask_loss)
        if training:
            self.optimizer, self.schedule = optimizer_from_config(
                cfg, self.model.parameters(), steps)
            self.train_step = make_train_step(
                self.model, self.loss_specs, self.optimizer,
                cfg.compute_dtype, device)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.eval_step = make_eval_step(self.model, self.loss_specs,
                                        cfg.compute_dtype, device)
        self.accumulator = SubjectAccumulator(cfg.fine_tune_task)
        self.ckpt_policy = BestCheckpointPolicy(
            folder, cfg.experiment_title or cfg.exp_name, cfg.fine_tune_task)
        self.pred_key = cfg.fine_tune_task
        self.loss_history: Dict[str, List[float]] = {"train": [], "val": [],
                                                     "test": []}
        self.step_losses: List[float] = []

    def _refuse_resume(self, folder: str) -> None:
        if self.cfg.model_weights_path:
            raise NotImplementedError(
                "training from model_weights_path (partial_restore phase "
                "chaining) is ROADMAP M5")
        resume = latest_checkpoint(folder)
        if resume is not None:
            raise NotImplementedError(
                f"{folder!r} holds {os.path.basename(resume)}: auto-resume is "
                f"ROADMAP M5; train into a folder without checkpoints")

    def _load_weights(self, folder: str) -> None:
        """The weights to evaluate, strictly, and their frozen threshold."""
        path = default_checkpoint(self.cfg, folder)
        if path is None:
            raise FileNotFoundError(
                f"no checkpoint in {folder!r} and no model_weights_path")
        ckpt = load_checkpoint(path)
        self.model.load_state_dict(ckpt["state_dict"])
        self.val_threshold = ckpt["metadata"].get("val_threshold")
        self.checkpoint_path = path

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

    def train_epoch(self, epoch: int) -> float:
        totals = []
        for batch, names in self.batches("train", epoch, shuffle=True):
            losses, preds = self.train_step(batch, self.generator)
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
            totals.append(float(losses["total"]))
            weights.append(sum(n is not None for n in names))
            self._record(preds, batch, names, mode)
        return (float(np.average(totals, weights=weights)) if totals
                else math.nan)

    def training(self) -> Dict[str, float]:
        """The epoch loop; returns the last epoch's metric summary."""
        metrics: Dict[str, float] = {}
        for epoch in range(self.cfg.nEpochs):
            t0 = time.time()
            self.loss_history["train"].append(self.train_epoch(epoch))
            self.loss_history["val"].append(self.eval_epoch("val"))
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
        """The test split at the frozen validation threshold (JAX
        ``testing``; reference trainer.py:571-582)."""
        if "test" not in self.pipeline.splits:
            raise ValueError("no test split: in-memory records give train "
                             "and val only")
        self.loss_history["test"].append(self.eval_epoch("test"))
        metrics = self.accumulator.summary(
            ["test"], val_threshold=self.val_threshold)
        self.accumulator.reset()
        return metrics

    def _checkpoint(self, epoch: int, metrics: Dict[str, float]) -> None:
        threshold = metrics.get("val_best_threshold")
        if threshold is not None:
            self.val_threshold = threshold
        self.ckpt_policy.update(
            state_dict=self.model.state_dict(),
            metadata={"val_threshold": self.val_threshold,
                      "metrics": metrics, "epoch": epoch,
                      "step": self.optimizer.count},
            val_auroc=metrics.get("val_AUROC"),
            val_acc=metrics.get("val_Balanced_Accuracy"),
            val_loss=self.loss_history["val"][-1])

    def best_checkpoint(self) -> Optional[str]:
        path = os.path.join(self.ckpt_policy.folder,
                            f"{self.ckpt_policy.title}_BEST_val_AUROC.ckpt")
        return path if os.path.exists(path) else None
