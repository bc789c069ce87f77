"""The phase chain in the port against the JAX package on the CPU.

* ``cli.main.config_from_args`` against JAX's for several argument lists
  (user flags beat the phase overlays);
* ``_best_checkpoint_for`` / ``weight_loader`` pick JAX's file on one
  ``experiments`` tree (same and cross target, same title, BEST over
  last-epoch, ``strict_chaining``);
* ``partial_restore`` gives JAX's merged weights through the converters:
  phase 3 -> 5 (``SwinClassifier`` -> ``FuncStructAdd``,
  ``SwinClassifierUNet`` -> ``FuncStructUNetAdd``), 3 -> 6 (->
  ``SwinFusionNet``), a BERT and a fusion stage of other depths (the stacked
  leaf skipped whole), and ``load_cls_embedding=False``;
* ``Trainer.testing`` restores weights and threshold as JAX's Trainer does,
  held against JAX's ``testing()`` on one tiny cohort: a folder whose
  ``BEST_val_accuracy`` file is newer than its ``BEST_val_AUROC`` file (the
  newest file and its threshold), and a step-4 run from a phase-3
  ``model_weights_path`` (merged weights, the threshold fitted on the test
  split);
* a run stopped after epoch 1 and resumed equals the uninterrupted run bit
  for bit (weights, K5's moments and counts, the accumulated gradient at
  ``k = 2``, the host generator); a checkpoint of the older format (weights
  and metadata only) resumes with a fresh optimizer; a file that is not a
  port checkpoint raises, naming it;
* accumulation at ``k = 2`` against JAX's ``optax.MultiSteps`` chain;
* the NaN audit names the subjects of a non-finite loss.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import combiner_cases as cc
from multimodal_neuroimage_tpu.ckpt import checkpoint as jckpt
from multimodal_neuroimage_tpu.cli import main as jcli
from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.train.state import (
    create_optimizer as jcreate_optimizer)
from multimodal_neuroimage_tpu_torch.ckpt import checkpoint as tckpt
from multimodal_neuroimage_tpu_torch.cli import main as tcli
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.data import synthetic as tsyn
from multimodal_neuroimage_tpu_torch.train.state import create_optimizer
from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _jcfg(cfg):
    return JConfig(**dataclasses.asdict(cfg))


# ---- the CLI's config and its choice of checkpoint ----------------------------------

@pytest.mark.parametrize("argv", [
    ["--step", "3", "--dataset_name", "DTI+sMRI"],
    ["--step", "5", "--multimodality_type", "add", "--batch_size", "2",
     "--fusion_depths", "1,1", "--no-save_last_epoch"],
    ["--step", "6", "--lr_init", "0.5", "--fusion_drop_rate", "0.1"],
    ["--step", "4", "--lr_warmup", "10", "--optim", "Adam",
     "--model_weights_path", "x/DTI+sMRI.ckpt"],
    ["--step", "1", "--dataset_name", "hcp", "--nEpochs", "3"],
])
def test_config_from_args_matches_jax(argv):
    """The phase overlay under the flags: a flag the user set (batch 2 at
    step 5, fusion dropout 0.1 at step 6, Adam at step 4) beats the
    phase's default."""
    got = tcli.config_from_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jcli.config_from_args(argv))
    assert got.step == int(argv[1])


def _experiment(base, name, task, target, exp_name, files):
    """An experiment folder archived by the port's args_logger, holding
    ``files`` ({file name: mtime})."""
    folder = os.path.join(base, "experiments", name)
    cfg = Config(base_path=base, task=task, target=target, exp_name=exp_name,
                 experiment_folder=folder)
    tcli.args_logger(cfg)
    for fname, mtime in files.items():
        path = os.path.join(folder, fname)
        open(path, "wb").close()
        os.utime(path, (mtime, mtime))
    return folder


def test_best_checkpoint_for_matches_jax(tmp_path):
    """One ``experiments`` tree, several questions: JAX's
    ``_best_checkpoint_for`` only globs and reads ``arguments.pkl``, so it
    reads the port's tree."""
    base = str(tmp_path)
    _experiment(base, "a_sex", "VIT", "sex", "a",
                {"a_BEST_val_AUROC.ckpt": 100, "a_last_epoch.ckpt": 400})
    _experiment(base, "b_sex", "VIT", "sex", "b",
                {"b_BEST_val_AUROC.ckpt": 300})
    _experiment(base, "c_age", "VIT", "age", "c",
                {"c_BEST_val_loss.ckpt": 900})
    _experiment(base, "d_sex", "FuncStruct", "sex", "d",
                {"d_last_epoch.ckpt": 800})
    _experiment(base, "e_sex", "SwinFusion", "sex", "e", {})
    questions = [
        ("VIT", dict(target="sex", exp_name="z"), True),     # newest same-target
        ("VIT", dict(target="sex", exp_name="a"), True),     # same title first
        ("VIT", dict(target="BMI", exp_name="z"), True),     # cross-target
        ("FuncStruct", dict(target="sex", exp_name="z"), True),
        ("FuncStruct", dict(target="sex", exp_name="z"), False),  # last-epoch
        ("SwinFusion", dict(target="sex", exp_name="e"), False),
    ]
    for task, kw, best_only in questions:
        cfg = Config(base_path=base, **kw)
        got = tcli._best_checkpoint_for(task, cfg, best_only)
        assert got == jcli._best_checkpoint_for(task, _jcfg(cfg), best_only)
    assert os.path.basename(tcli._best_checkpoint_for(
        "VIT", Config(base_path=base, exp_name="a"))) == \
        "a_BEST_val_AUROC.ckpt"
    for step in (1, 3, 4, 5, 6):
        cfg = Config(base_path=base, step=step, exp_name="b")
        assert tcli.weight_loader(cfg) == jcli.weight_loader(_jcfg(cfg))
    strict = Config(base_path=base, target="BMI", strict_chaining=True)
    for fn, c in ((tcli._best_checkpoint_for, strict),
                  (jcli._best_checkpoint_for, _jcfg(strict))):
        with pytest.raises(FileNotFoundError, match="CROSS-target"):
            fn("VIT", c)


# ---- partial_restore ---------------------------------------------------------------------

TINY_BERT = dict(transformer_hidden_layers=2, bert_intermediate_size=64,
                 num_heads_2DBert=4, size_of_model="small")
TINY_FUSION = dict(fusion_ex_depths=(1,), fusion_depths=(2,),
                   fusion_re_depths=(1,), fusion_ex_heads=(2,),
                   fusion_heads=(2,), fusion_re_heads=(2,))
CHAINS = {
    "3to5_add": (dict(task="VIT", dataset_name="DTI+sMRI",
                      size_of_model="small"),
                 dict(task="FuncStruct", dataset_name="multimodal",
                      multimodality_type="add", **TINY_BERT), True),
    "3to5_unet": (dict(task="VIT", dataset_name="DTI+sMRI", use_unet=True,
                       size_of_model="small"),
                  dict(task="FuncStruct", dataset_name="multimodal",
                       multimodality_type="add", use_unet=True,
                       **TINY_BERT), True),
    "3to6": (dict(task="VIT", dataset_name="DTI+sMRI"),
             dict(task="SwinFusion", dataset_name="struct", **TINY_FUSION),
             True),
    "depth": (dict(task="FuncStruct", dataset_name="multimodal",
                   **TINY_BERT, **TINY_FUSION),
              dict(task="FuncStruct", dataset_name="multimodal",
                   **{**TINY_BERT, "transformer_hidden_layers": 3},
                   **{**TINY_FUSION, "fusion_depths": (4,)}), True),
    "no_cls": (dict(task="FuncStruct", dataset_name="multimodal",
                    **TINY_BERT, **TINY_FUSION),
               dict(task="FuncStruct", dataset_name="multimodal",
                    multimodality_type="add", **TINY_BERT), False),
}


def _model_params(kw, seed):
    cfg = JConfig(compute_dtype="float32", **kw).validate()
    batch = cc._example_batch(2, t=16, r=84)
    batch.update(smri=batch["struct"], dti=batch["struct"])
    return cc.random_params(jcreate(cfg), batch, seed)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_partial_restore_matches_jax(chain):
    """JAX's partial_restore on the flax trees and the port's on the
    converted state dicts give the same merged weights, key by key. At
    other depths JAX skips a whole stacked leaf (a BERT's ``layers``, a
    fusion stage's ``pairs``): no layer of it is copied."""
    src_kw, tgt_kw, cls = CHAINS[chain]
    src, tgt = _model_params(src_kw, 1), _model_params(tgt_kw, 2)
    merged, _ = jckpt.partial_restore(tgt, src, load_cls_embedding=cls)
    want = jax_params_to_state_dict(merged)
    target = jax_params_to_state_dict(tgt)
    got, stats, copied = tckpt.partial_restore(
        target, jax_params_to_state_dict(src), load_cls_embedding=cls)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    changed = {k for k in target if not torch.equal(target[k], want[k])}
    assert changed and changed <= set(copied)
    if chain.startswith("3to5"):
        assert {k.split(".")[0] for k in copied} == (
            {"swin", "unet"} if "unet" in chain else {"swin"})
    if chain == "depth":
        assert not any(".encoder.layer." in k or "layers_Fusion" in k
                       for k in copied)
        assert any(".embeddings." in k for k in copied)
    if chain == "no_cls":
        assert stats["cls_skipped"] and not any("cls_embedding" in k
                                                for k in copied)


# ---- Trainer.testing: the weights and the threshold -------------------------------------

@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chain_cohort"))
    return tsyn.generate_synthetic_cohort(root, n_subjects=40, seed=3)


def _smri_cfg(root, folder, **kw):
    base = dict(task="VIT", step=3, dataset_name="sMRI", target="sex",
                size_of_model="small", batch_size=2, nEpochs=1, workers=1,
                compute_dtype="float32", preprocess="host",
                experiment_folder=str(folder), experiment_title="t")
    return tsyn.synthetic_config(root, **{**base, **kw}).validate()


@pytest.mark.parametrize("case", ["newer_accuracy", "step4_chain"])
def test_testing_restores_as_the_jax_trainer(cohort, tmp_path, case):
    """``newer_accuracy``: the folder's ``BEST_val_accuracy`` file (weights
    B, threshold 0.7) is newer than its ``BEST_val_AUROC`` file (weights A,
    threshold 0.3): both Trainers test B at 0.7 (the serving rule,
    ``default_checkpoint``, would take A). ``step4_chain``: step 4 in a
    fresh folder from a phase-3 checkpoint (threshold 0.9 in it): the
    weights merged by partial_restore and the threshold fitted on the test
    split, as JAX's step 4 does (ROADMAP F9)."""
    from multimodal_neuroimage_tpu.train.trainer import Trainer as JTrainer
    batch = {"smri": cc._example_batch(2, r=84)["struct"]}
    jmodel = jcreate(_jcfg(_smri_cfg(cohort, tmp_path)))
    weights = [cc.random_params(jmodel, batch, seed) for seed in (1, 2)]
    sides = {}
    for side in ("jax", "port"):
        folder = tmp_path / side
        source = tmp_path / f"{side}_phase3" / "p3_BEST_val_AUROC.ckpt"
        files = ([(folder / "t_BEST_val_AUROC.ckpt", weights[0], 0.3, 100),
                  (folder / "t_BEST_val_accuracy.ckpt", weights[1], 0.7,
                   200)] if case == "newer_accuracy"
                 else [(source, weights[1], 0.9, 100)])
        for path, params, thr, mtime in files:
            if side == "jax":
                jckpt.save_checkpoint(str(path), params=params,
                                      metadata={"val_threshold": thr})
            else:
                tckpt.save_checkpoint(str(path),
                                      jax_params_to_state_dict(params),
                                      {"val_threshold": thr})
            os.utime(path, (mtime, mtime))
        kw = ({} if case == "newer_accuracy" else
              dict(step=4, task="test", model_weights_path=str(source)))
        cfg = _smri_cfg(cohort, folder, **kw)
        if side == "jax":
            sides[side] = JTrainer(_jcfg(cfg), sets=["test"]).testing()
        else:
            trainer = Trainer(cfg, sets=["test"], device="cpu")
            sides[side] = trainer.testing()
    got, want = sides["port"], sides["jax"]
    if case == "newer_accuracy":
        assert trainer.checkpoint_path.endswith("t_BEST_val_accuracy.ckpt")
        assert trainer.val_threshold == 0.7
    else:
        assert trainer.val_threshold is None
    for key in ("test_AUROC", "test_best_threshold", "test_best_bal_acc",
                "test_Balanced_Accuracy"):
        assert got[key] == pytest.approx(want[key], abs=1e-5), key


# ---- resume, old files, foreign files --------------------------------------------------

def _records(n, seed, first=0, nan_subject=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = rng.normal(size=(84, 84))
        if f"s{first + i}" == nan_subject:
            s[3, 5] = np.nan
        out.append({"subject": f"s{first + i}", "smri": s + s.T,
                    "target": float(i % 2)})
    return out


def _run(cfg, folder, n_epochs):
    trainer = Trainer(dataclasses.replace(cfg, nEpochs=n_epochs),
                      _records(6, 0), _records(4, 1, 6), device="cpu",
                      experiment_folder=str(folder))
    trainer.training()
    return trainer


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Three train steps an epoch with K5 every 2 (the accumulated mean
    crosses the epoch boundary) and DropPath from the host generator: one
    epoch, then a new Trainer in the same folder resuming at epoch 1, ends
    bit-equal to two epochs in one run."""
    cfg = _smri_cfg("unused", tmp_path, drop_path_rate=0.2,
                    accumulation_steps=2, optim="AdamW")
    _run(cfg, tmp_path / "a", 1)
    resumed = _run(cfg, tmp_path / "a", 2)
    whole = _run(cfg, tmp_path / "b", 2)
    assert resumed.epoch0 == 1 and whole.epoch0 == 0
    assert resumed.optimizer.count == whole.optimizer.count == 3
    assert resumed.optimizer.mini_step == whole.optimizer.mini_step == 0
    for k, v in whole.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for k in ("mu", "nu", "acc"):
        assert torch.equal(getattr(resumed.optimizer, k),
                           getattr(whole.optimizer, k)), k
    assert torch.equal(resumed.generator.get_state(),
                       whole.generator.get_state())
    assert resumed.loss_history["train"] == whole.loss_history["train"][1:]
    a = tckpt.load_checkpoint(str(tmp_path / "a" / "t_last_epoch.ckpt"))
    b = tckpt.load_checkpoint(str(tmp_path / "b" / "t_last_epoch.ckpt"))
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] == 6
    assert a["metadata"]["val_threshold"] == b["metadata"]["val_threshold"]


def test_older_checkpoint_resumes_with_a_fresh_optimizer(tmp_path, capsys):
    """A checkpoint of the older format (``state_dict`` and ``metadata``
    only) loads, and a run resumes from it at the next epoch with a fresh
    optimizer and a warning."""
    cfg = _smri_cfg("unused", tmp_path / "run")
    state = _run(cfg, tmp_path / "first", 1).model.state_dict()
    os.makedirs(tmp_path / "run")
    path = str(tmp_path / "run" / "t_BEST_val_AUROC.ckpt")
    torch.save({"state_dict": state, "metadata": {"val_threshold": 0.4,
                                                  "epoch": 0}}, path)
    ckpt = tckpt.load_checkpoint(path)
    assert ckpt["optimizer"] is None and ckpt["generator"] is None
    assert ckpt["epoch"] == 0
    trainer = _run(cfg, tmp_path / "run", 2)
    assert trainer.epoch0 == 1 and trainer.optimizer.count == 3
    assert "fresh optimizer" in capsys.readouterr().out


def test_foreign_checkpoint_raises_naming_the_file(tmp_path):
    """A JAX checkpoint in the folder is not skipped: resuming from it
    raises, naming the file."""
    jmodel = jcreate(_jcfg(_smri_cfg("unused", tmp_path)))
    params = cc.random_params(jmodel, {"smri": np.zeros((2, 84, 84),
                                                        np.float32)})
    path = str(tmp_path / "jax" / "t_last_epoch.ckpt")
    jckpt.save_checkpoint(path, params=params)
    with pytest.raises(ValueError, match="t_last_epoch.ckpt"):
        tckpt.load_checkpoint(path)
    with pytest.raises(ValueError, match="not a checkpoint of the PyTorch"):
        _run(_smri_cfg("unused", tmp_path), tmp_path / "jax", 1)


# ---- accumulation, the NaN audit -----------------------------------------------------------

@pytest.mark.parametrize("optim,clip", [("adamw", False), ("adam", True)])
def test_accumulation_matches_jax_multisteps(optim, clip):
    """K5 every 2 micro-steps on the running mean of their gradients
    (clipped as a whole, the schedule at the count of updates) against JAX's
    ``optax.MultiSteps`` over the unfused chain: the parameters after every
    micro-step, unchanged between updates."""
    rng = np.random.default_rng(0)
    n = 4096
    p0 = rng.normal(size=n).astype(np.float32)
    grads = [(rng.normal(size=n) * (3.0 if clip else 1.0)).astype(np.float32)
             for _ in range(6)]

    def schedule(t):
        return 1e-2 * 0.9 ** t

    tx = jcreate_optimizer(optim, schedule, 1e-2, clip, 20.0,
                           accumulation_steps=2)
    jp = jax.numpy.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = create_optimizer(optim, [param], schedule, 1e-2, clip, 20.0,
                           accumulation_steps=2)
    for i, g in enumerate(grads):
        upd, state = tx.update(jax.numpy.asarray(g), state, jp)
        jp = jp + upd
        before = param.detach().clone()
        opt.zero_grad()
        param.grad.copy_(torch.from_numpy(g))
        opt.step()
        if i % 2 == 0:
            assert torch.equal(param.detach(), before)
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp),
                                   rtol=1e-5, atol=1e-7, err_msg=str(i))
    assert opt.count == 3 and opt.mini_step == 0


def test_nan_audit_names_the_subjects(tmp_path, capsys):
    """A subject whose matrix holds a NaN makes its batch's loss NaN: the
    audit prints the batch's subjects and keeps them by loss kind."""
    cfg = _smri_cfg("unused", tmp_path)
    trainer = Trainer(cfg, _records(4, 0, nan_subject="s1"),
                      _records(2, 1, 4), device="cpu",
                      experiment_folder=str(tmp_path / "exp"))
    trainer.training()
    out = capsys.readouterr().out
    assert "s1" in trainer.nan_subjects["total"]
    assert "[nan-audit] non-finite total loss" in out and "'s1'" in out
