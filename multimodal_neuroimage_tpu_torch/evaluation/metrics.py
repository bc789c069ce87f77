"""Classification / regression metrics and subject-level aggregation
(counterpart of multimodal_neuroimage_tpu/evaluation/metrics.py).

Plain numpy, no sklearn (the card's machine has none): ``auroc`` is the
Mann-Whitney statistic with ties counted a half (what sklearn's trapezoid
over the ROC curve gives), ``roc_curve`` is sklearn's algorithm including
its ``drop_intermediate`` thinning, and the accuracy, recall, F1 and R^2
follow sklearn's definitions and zero-division conventions. Across ranks
(parallel/mesh.py) the subject rows are gathered before any metric
(``gather_ragged``, JAX's): the metrics are global and the same on every
rank.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from multimodal_neuroimage_tpu_torch.parallel.mesh import (gather_objects,
                                                           process_allgather,
                                                           world)


def sigmoid(x) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=np.float64)))


def rac(truth, pred) -> float:
    """Raw accuracy."""
    truth, pred = np.asarray(truth, float), np.asarray(pred, float)
    return float(np.mean(truth == pred))


def bac(truth, pred) -> float:
    """Balanced accuracy: the mean recall over the classes present in
    ``truth`` (sklearn balanced_accuracy_score)."""
    truth, pred = np.asarray(truth, float), np.asarray(pred, float)
    recalls = [np.mean(pred[truth == c] == c) for c in np.unique(truth)]
    return float(np.mean(recalls))


def _recall(truth, pred, pos) -> float:
    hit = truth == pos
    return float(np.mean(pred[hit] == pos)) if hit.any() else 0.0


def _f1(truth, pred) -> float:
    tp = float(np.sum((truth == 1) & (pred == 1)))
    fp = float(np.sum((truth != 1) & (pred == 1)))
    fn = float(np.sum((truth == 1) & (pred != 1)))
    return 2 * tp / (2 * tp + fp + fn) if tp + fp + fn > 0 else 0.0


def _average_ranks(score: np.ndarray) -> np.ndarray:
    """1-based ranks of ``score``, ties sharing their mean rank."""
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    ranks = np.empty(len(s), np.float64)
    starts = np.r_[0, np.flatnonzero(np.diff(s)) + 1]
    ends = np.r_[starts[1:], len(s)]
    for a, b in zip(starts, ends):
        ranks[order[a:b]] = (a + b + 1) / 2.0
    return ranks


def auroc(truth, score) -> float:
    truth = np.asarray(truth, float)
    score = np.asarray(score, np.float64)
    pos = truth == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUROC needs both classes in truth")
    ranks = _average_ranks(score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def roc_curve(truth, score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) as sklearn.metrics.roc_curve with its
    defaults (pos_label 1, drop_intermediate=True, first threshold inf)."""
    truth = np.asarray(truth, float) == 1
    score = np.asarray(score, np.float64)
    order = np.argsort(score, kind="mergesort")[::-1]
    score, truth = score[order], truth[order]
    idx = np.r_[np.flatnonzero(np.diff(score)), truth.size - 1]
    tps = np.cumsum(truth, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    thresholds = score[idx]
    if len(fps) > 2:
        keep = np.flatnonzero(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                        np.diff(tps, 2)),
                                    True])
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    thresholds = np.r_[np.inf, thresholds]
    return fps / fps[-1], tps / tps[-1], thresholds


def roc_threshold_metrics(truth, score, *,
                          frozen_threshold: Optional[float] = None
                          ) -> Dict[str, float]:
    """g-mean-optimal operating point, or the frozen validation threshold
    when given (test mode)."""
    truth = np.asarray(truth, float)
    score = np.asarray(score, np.float64)
    if frozen_threshold is not None:
        pred = (score > frozen_threshold).astype(float)
        tpr = _recall(truth, pred, 1.0)
        fpr = 1.0 - _recall(truth, pred, 0.0)
        best = dict(threshold=float(frozen_threshold),
                    gmean=float(np.sqrt(tpr * (1 - fpr))),
                    specificity=float(1 - fpr), sensitivity=float(tpr))
    else:
        fpr, tpr, thresholds = roc_curve(truth, score)
        gmeans = np.sqrt(tpr * (1 - fpr))
        ix = int(np.argmax(gmeans))
        best = dict(threshold=float(thresholds[ix]), gmean=float(gmeans[ix]),
                    specificity=float(1 - fpr[ix]),
                    sensitivity=float(tpr[ix]))
        pred = (score > best["threshold"]).astype(float)
    best["f1_score"] = _f1(truth, pred)
    best["best_bal_acc"] = bac(truth, pred)
    return best


def gather_ragged(v) -> np.ndarray:
    """Every rank's 1-D array, of lengths that may differ (each rank's
    share of a padded eval tail), concatenated in rank order (JAX
    ``gather_ragged``): the lengths are gathered first, the values padded
    with NaN to the longest, gathered as float64 and trimmed. One process:
    the array itself."""
    v = np.asarray(v).reshape(-1)
    if world() == 1:
        return v
    lengths = process_allgather(np.asarray([len(v)], np.int64)).reshape(-1)
    m = int(lengths.max())
    if m == 0:
        return v
    padded = np.full(m, np.nan, np.float64)
    padded[:len(v)] = v
    stacked = process_allgather(padded).reshape(len(lengths), m)
    return np.concatenate([stacked[i, :int(n)]
                           for i, n in enumerate(lengths)])


def regression_metrics(truth, pred) -> Dict[str, float]:
    truth = np.asarray(truth, dtype=np.float64)
    pred = np.asarray(pred, dtype=np.float64)
    ss_res = float(np.sum((truth - pred) ** 2))
    ss_tot = float(np.sum((truth - truth.mean()) ** 2))
    r2 = (1.0 - ss_res / ss_tot if ss_tot != 0.0
          else (1.0 if ss_res == 0.0 else 0.0))
    return {
        "MAE": float(np.mean(np.abs(pred - truth))),
        "MSE": float(np.mean((pred - truth) ** 2)),
        "NMSE": float(np.mean((pred - truth) ** 2
                              / np.maximum(truth ** 2, 1e-12))),
        "R2_score": r2,
    }


@dataclass
class SubjectAccumulator:
    """Per-subject window-score accumulation (trainer.py:756-778)."""

    fine_tune_task: str = "binary_classification"
    scores: Dict[str, List[float]] = field(default_factory=dict)
    truths: Dict[str, float] = field(default_factory=dict)
    modes: Dict[str, str] = field(default_factory=dict)

    def append(self, subjects, scores, truths, mode: str) -> None:
        scores = np.asarray(scores).reshape(-1)
        truths = np.asarray(truths).reshape(-1)
        for subj, sc, tr in zip(np.asarray(subjects).reshape(-1), scores,
                                truths):
            key = str(subj)
            self.scores.setdefault(key, []).append(float(sc))
            self.truths[key] = float(tr)
            self.modes[key] = mode

    def reset(self, keep_mode: Optional[str] = None) -> None:
        if keep_mode is None:
            self.scores, self.truths, self.modes = {}, {}, {}
            return
        keep = {k for k, m in self.modes.items() if m == keep_mode}
        self.scores = {k: v for k, v in self.scores.items() if k in keep}
        self.truths = {k: v for k, v in self.truths.items() if k in keep}
        self.modes = {k: v for k, v in self.modes.items() if k in keep}

    def per_subject(self, mode: str):
        """(subjects, mean scores, stds, truths) for one split; scores are
        sigmoided per window before averaging for classification. Across
        ranks every rank's rows, in rank order (``gather_ragged``; a
        collective, so every rank calls it)."""
        subjects, means, stds, truths = [], [], [], []
        for subj, vals in self.scores.items():
            if self.modes[subj] != mode:
                continue
            v = np.asarray(vals, dtype=np.float64)
            if self.fine_tune_task == "binary_classification":
                v = sigmoid(v)
            subjects.append(subj)
            means.append(float(v.mean()))
            stds.append(float(v.std()))
            truths.append(self.truths[subj])
        if world() > 1:
            subjects = [s for part in gather_objects(subjects) for s in part]
            means, stds, truths = (gather_ragged(np.asarray(a, np.float64))
                                   for a in (means, stds, truths))
        return subjects, np.asarray(means), np.asarray(stds), np.asarray(
            truths)

    def summary(self, modes, *, val_threshold: Optional[float] = None
                ) -> Dict[str, float]:
        """The metrics of each split over every rank's subjects."""
        metrics: Dict[str, float] = {}
        for mode in modes:
            _, pred, _, truth = self.per_subject(mode)
            if len(pred) == 0:
                continue
            if self.fine_tune_task == "regression":
                for k, v in regression_metrics(truth, pred).items():
                    metrics[f"{mode}_{k}"] = v
                continue
            hard = (pred > 0.5).astype(float)
            metrics[f"{mode}_Balanced_Accuracy"] = bac(truth, hard)
            metrics[f"{mode}_Regular_Accuracy"] = rac(truth, hard)
            if len(np.unique(truth)) > 1:
                metrics[f"{mode}_AUROC"] = auroc(truth, pred)
                frozen = val_threshold if mode == "test" else None
                best = roc_threshold_metrics(truth, pred,
                                             frozen_threshold=frozen)
                metrics[f"{mode}_best_bal_acc"] = best["best_bal_acc"]
                metrics[f"{mode}_best_threshold"] = best["threshold"]
                metrics[f"{mode}_gmean"] = best["gmean"]
                metrics[f"{mode}_specificity"] = best["specificity"]
                metrics[f"{mode}_sensitivity"] = best["sensitivity"]
                metrics[f"{mode}_f1_score"] = best["f1_score"]
        return metrics
