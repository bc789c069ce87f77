"""Training runtime over in-memory records (counterpart of multimodal_neuroimage_tpu/train/trainer.py).

``Trainer(cfg, train_records, val_records)`` takes records shaped as the
``Predictor``'s requests plus a target (the flagship's ``{subject, fmri (84,
T), struct (84, 84), target}``, HCP's ``{subject, fmri (22, T), target}``),
turns them into items once on the host (data/loader.py ``item_for``; in the
device gear the raw series, band-split on the device a batch by
``device_preprocess``), and runs the JAX Trainer's loop (``train_epoch``,
``eval_epoch``, ``training``, :312-392): shuffled drop-last train
batches, one K5 step each, a validation pass, subject-level metrics, and
the best-AUROC checkpoint (port format, frozen ``val_threshold`` in its
metadata) that ``serve/predictor.py`` loads.

Randomness is explicit: weights from ``init_random_weights`` seeded by
``cfg.seed``, the train order from ``numpy.random.default_rng(cfg.seed +
epoch)``, and every dropout seed / DropPath factor from one host
``torch.Generator`` seeded by ``cfg.seed``; a run repeats exactly.

Not here yet, each with its ROADMAP item: on-disk cohorts, ``DataPipeline``
and the ``native`` gear (N5), auto-resume and ``partial_restore`` phase
chaining (M5), Optuna, the writer and grad-norm logging, the NaN audit
(M13), multi-GPU (M11). ``cfg.compute_dtype`` reaches the train, eval and
predict steps (the bf16 policy of train/state.py; HCP's K6 route keeps a
bf16 stream through K6's bf16 form); the float32 masters, checkpoints and
K5 are the same under either policy.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
    BestCheckpointPolicy)
from multimodal_neuroimage_tpu_torch.data.loader import (collate,
                                                          device_preprocess,
                                                          item_for)
from multimodal_neuroimage_tpu_torch.evaluation.metrics import (
    SubjectAccumulator)
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.serve.predictor import check_supported
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (
    make_eval_step, make_train_step, optimizer_from_config)


class Trainer:
    def __init__(self, cfg, train_records: List[Mapping],
                 val_records: List[Mapping], device: str = "cuda",
                 experiment_folder: Optional[str] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = device
        self._item_fn = item_for(cfg)
        self.items = {"train": [self._item(r) for r in train_records],
                      "val": [self._item(r) for r in val_records]}
        steps = len(self.items["train"]) // cfg.batch_size
        if steps == 0:
            raise ValueError(
                f"train split has {len(self.items['train'])} subjects but "
                f"one batch needs {cfg.batch_size}: zero train steps")
        self.steps_per_epoch = steps
        self.model = init_random_weights(
            create_model(cfg), torch.Generator().manual_seed(cfg.seed))
        self.model.to(device)
        self.optimizer, self.schedule = optimizer_from_config(
            cfg, self.model.parameters(), steps)
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.loss_specs = active_losses(
            cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss,
            use_unet_loss=cfg.use_unet_loss, use_cont_loss=cfg.use_cont_loss,
            use_mask_loss=cfg.use_mask_loss)
        self.train_step = make_train_step(self.model, self.loss_specs,
                                          self.optimizer, cfg.compute_dtype,
                                          device)
        self.eval_step = make_eval_step(self.model, self.loss_specs,
                                        cfg.compute_dtype, device)
        self.accumulator = SubjectAccumulator(cfg.fine_tune_task)
        folder = experiment_folder or cfg.experiment_folder or cfg.log_dir
        self.ckpt_policy = BestCheckpointPolicy(
            folder, cfg.experiment_title or cfg.exp_name, cfg.fine_tune_task)
        self.val_threshold: Optional[float] = None
        self.pred_key = cfg.fine_tune_task
        self.loss_history: Dict[str, List[float]] = {"train": [], "val": []}
        self.step_losses: List[float] = []

    def _item(self, record: Mapping) -> Dict:
        item = self._item_fn(record, self.cfg)
        item["target"] = np.float32(record["target"])
        return item

    def batches(self, split: str, epoch: int = 0, shuffle: bool = False
                ) -> Iterator[Tuple[Dict, List[str]]]:
        """Batches of one split, the device gear's bands made on the device
        (``device_preprocess``); train drops its last partial batch
        (reference dataloaders.py:139), eval keeps it."""
        items = self.items[split]
        order = (np.random.default_rng(self.cfg.seed + epoch).permutation(
            len(items)) if shuffle else np.arange(len(items)))
        bs = self.cfg.batch_size
        stop = len(items) - len(items) % bs if split == "train" else len(items)
        for i in range(0, stop, bs):
            batch, names = collate([items[j] for j in order[i:i + bs]])
            yield device_preprocess(batch, self.cfg, self.device), names

    def _record(self, preds, batch, names, mode: str) -> None:
        if self.pred_key in preds:
            self.accumulator.append(names, preds[self.pred_key].cpu().numpy(),
                                    batch["target"], mode)

    def train_epoch(self, epoch: int) -> float:
        totals = []
        for batch, names in self.batches("train", epoch, shuffle=True):
            losses, preds = self.train_step(batch, self.generator)
            totals.append(float(losses["total"]))
            self._record(preds, batch, names, "train")
        self.step_losses.extend(totals)
        return float(np.mean(totals))

    def eval_epoch(self, mode: str = "val") -> float:
        totals, weights = [], []
        for batch, names in self.batches(mode):
            losses, preds = self.eval_step(batch)
            totals.append(float(losses["total"]))
            weights.append(len(names))
            self._record(preds, batch, names, mode)
        return float(np.average(totals, weights=weights))

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
