"""The port's training loop pieces against the JAX package (and sklearn),
on the CPU: the four LR schedules, the BCE / L1 criteria and the loss
registry, the numpy metrics (AUROC and roc_curve against sklearn, the rest
against the JAX package's sklearn-backed functions), and the ``Trainer``
on a tiny synthetic cohort: a seeded run repeats exactly, the best-AUROC
checkpoint is written and the ``Predictor`` serves it.

Tolerance: float32 losses at rtol 2e-4 / atol 1e-4 (the goldens'); the
schedules at rtol 1e-5 / atol 1e-10 (JAX evaluates them in float32, the
port in float64); metrics in float64 at 1e-12.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score, roc_curve as sk_roc_curve

from __graft_entry__ import _flagship_cfg
from multimodal_neuroimage_tpu.evaluation import metrics as jmetrics
from multimodal_neuroimage_tpu.train import losses as jlosses
from multimodal_neuroimage_tpu.train.schedules import (
    build_schedule as jbuild_schedule)
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.evaluation import metrics as tmetrics
from multimodal_neuroimage_tpu_torch.train import losses as tlosses
from multimodal_neuroimage_tpu_torch.train.schedules import build_schedule

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


@pytest.mark.parametrize("policy", ["step", "SGDR", "OneCycle", "CosAnn"])
def test_schedules_match_jax(policy):
    kw = dict(lr_step=7, lr_gamma=0.9, lr_warmup=5, lr_T_mult=1)
    want = jbuild_schedule(policy, 1e-3, 120, **kw)
    got = build_schedule(policy, 1e-3, 120, **kw)
    for t in list(range(0, 130, 3)) + [36, 37, 119, 120, 121, 500]:
        # atol: float32 rounding of a 1e-3 base LR near the cosine's zero
        np.testing.assert_allclose(got(t), float(want(jnp.asarray(t))),
                                   rtol=1e-5, atol=1e-10,
                                   err_msg=f"{policy} t={t}")


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, 1)) * 4).astype(np.float32)
    target = rng.integers(0, 2, 6).astype(np.float32)
    valid = np.asarray([1, 1, 1, 1, 0, 1], np.float32)
    for v in (None, valid):
        want = jlosses.bce_with_logits(
            jnp.asarray(logits[:, 0]), jnp.asarray(target),
            None if v is None else jnp.asarray(v))
        got = tlosses.bce_with_logits(
            torch.from_numpy(logits[:, 0]), torch.from_numpy(target),
            None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL,
                                   atol=ATOL)
        want = jlosses.l1_loss(jnp.asarray(logits[:, 0]), jnp.asarray(target),
                               None if v is None else jnp.asarray(v))
        got = tlosses.l1_loss(torch.from_numpy(logits[:, 0]),
                              torch.from_numpy(target),
                              None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL,
                                   atol=ATOL)
    for task in ("binary_classification", "regression"):
        specs = tlosses.active_losses("FuncStruct", task)
        assert list(specs) == list(jlosses.active_losses("FuncStruct", task))
        out = {task: torch.from_numpy(logits)}
        batch = {"target": torch.from_numpy(target)}
        want = jlosses.compute_losses({task: jnp.asarray(logits)},
                                      {"target": jnp.asarray(target)},
                                      jlosses.active_losses("FuncStruct",
                                                            task))
        got = tlosses.compute_losses(out, batch, specs)
        for k in want:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flag", ["use_merge_loss", "use_unet_loss"])
def test_auxiliary_losses_name_roadmap_m10(flag):
    """An auxiliary loss still to port raises, naming ROADMAP M10; the
    merge loss is ported and joins the head's loss (held against JAX's by
    tests/test_torch_fmri_nets.py)."""
    if flag == "use_merge_loss":
        assert set(tlosses.active_losses(
            "FuncStruct", "binary_classification", use_merge_loss=True)) == {
                "merge", "binary_classification"}
        return
    with pytest.raises(NotImplementedError, match="M10"):
        tlosses.active_losses("FuncStruct", "binary_classification",
                              **{flag: True})


def _scores(seed, n=40, ties=False):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 2, n).astype(np.float64)
    score = rng.normal(size=n) + truth
    if ties:
        score = np.round(score, 1)
    return truth, score


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_auroc_and_roc_curve_match_sklearn(seed, ties):
    truth, score = _scores(seed, ties=ties)
    np.testing.assert_allclose(tmetrics.auroc(truth, score),
                               roc_auc_score(truth, score), rtol=1e-12)
    for got, want in zip(tmetrics.roc_curve(truth, score),
                         sk_roc_curve(truth, score)):
        np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("seed,ties", [(3, False), (4, True)])
def test_metrics_match_jax_package(seed, ties):
    truth, score = _scores(seed, ties=ties)
    prob = 1 / (1 + np.exp(-score))
    hard = prob > 0.5
    assert tmetrics.bac(truth, hard) == pytest.approx(
        jmetrics.bac(truth, hard), abs=1e-12)
    assert tmetrics.rac(truth, hard) == pytest.approx(
        jmetrics.rac(truth, hard), abs=1e-12)
    for frozen in (None, 0.55):
        got = tmetrics.roc_threshold_metrics(truth, prob,
                                             frozen_threshold=frozen)
        want = jmetrics.roc_threshold_metrics(truth, prob,
                                              frozen_threshold=frozen)
        assert got == pytest.approx(want, abs=1e-12)
    got = tmetrics.regression_metrics(truth + 1, score)
    assert got == pytest.approx(jmetrics.regression_metrics(truth + 1,
                                                            score), abs=1e-12)
    ja = jmetrics.SubjectAccumulator()
    ta = tmetrics.SubjectAccumulator()
    subjects = [f"s{i % 25}" for i in range(len(truth))]
    for acc in (ja, ta):
        acc.append(subjects[:20], score[:20], truth[:20], "val")
        acc.append(subjects[20:], score[20:], truth[20:], "test")
    assert ta.summary(["val", "test"], val_threshold=0.5) == pytest.approx(
        ja.summary(["val", "test"], val_threshold=0.5), abs=1e-12)


def test_metrics_edge_cases_follow_sklearn():
    with pytest.raises(ValueError):
        tmetrics.auroc([1, 1, 1], [0.1, 0.2, 0.3])
    assert tmetrics.regression_metrics([2.0, 2.0], [2.0, 2.0])[
        "R2_score"] == 1.0
    best = tmetrics.roc_threshold_metrics([0, 1, 0, 1], [0.1, 0.2, 0.3, 0.4],
                                          frozen_threshold=0.9)
    assert best["f1_score"] == 0.0 and best["sensitivity"] == 0.0


# ---- Trainer mechanics on a tiny cohort --------------------------------------------

def _cohort(cfg, n, seed):
    """Records with a label-linked signal: positives get a stronger
    struct diagonal and a slow fMRI oscillation."""
    rng = np.random.default_rng(seed)
    R = cfg.intermediate_vec
    out = []
    for i in range(n):
        y = float(i % 2)
        T = int(rng.integers(350, 369))
        t = np.arange(T)[None]
        fmri = (rng.normal(size=(R, T)) + 50.0
                + 2.0 * y * np.sin(2 * np.pi * t / 40.0))
        s = rng.normal(size=(R, R))
        out.append({"subject": f"sub-{seed}-{i:02d}", "fmri": fmri,
                    "struct": (s + s.T) / 2 + 3.0 * y * np.eye(R),
                    "target": y})
    return out


@pytest.fixture(scope="module")
def tiny_cfg():
    jcfg = dataclasses.replace(
        _flagship_cfg(tiny=True), compute_dtype="float32", preprocess="host",
        batch_size=2, nEpochs=2, lr_init=1e-3, experiment_title="tiny",
        seed=3).validate()
    return Config(**dataclasses.asdict(jcfg))      # the port's own Config


def test_trainer_repeats_exactly_and_serves_its_best_checkpoint(tiny_cfg,
                                                                tmp_path):
    from multimodal_neuroimage_tpu_torch.ckpt.checkpoint import (
        load_checkpoint)
    from multimodal_neuroimage_tpu_torch.serve.predictor import Predictor
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    train, val = _cohort(tiny_cfg, 6, 0), _cohort(tiny_cfg, 4, 1)
    runs = []
    for k in range(2):
        tr = Trainer(tiny_cfg, train, val, device="cpu",
                     experiment_folder=str(tmp_path / f"run{k}"))
        metrics = tr.training()
        runs.append((tr, metrics))
    (a, ma), (b, mb) = runs
    assert ma == mb and a.step_losses == b.step_losses
    assert len(a.step_losses) == 2 * 3 and all(np.isfinite(a.step_losses))
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    assert "val_AUROC" in ma and "train_AUROC" in ma
    ckpt = a.best_checkpoint()
    assert ckpt is not None
    meta = load_checkpoint(ckpt)["metadata"]
    assert meta["val_threshold"] is not None and meta["best_auroc"] > 0
    pred = Predictor(tiny_cfg, ckpt, [{k: r[k] for k in ("subject", "fmri",
                                                         "struct")}
                                      for r in val], device="cpu")
    assert pred.threshold == meta["val_threshold"]
    scores = pred.predict()
    assert set(scores) == {r["subject"] for r in val}
    assert all(0.0 < s["score"] < 1.0 for s in scores.values())


def test_trainer_refuses_an_empty_train_split(tiny_cfg, tmp_path):
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    with pytest.raises(ValueError, match="zero train steps"):
        Trainer(tiny_cfg, _cohort(tiny_cfg, 1, 0), [], device="cpu",
                experiment_folder=str(tmp_path))
