"""The run's outer shell, the port against the JAX package on the CPU
(obs/writer.py, obs/profiling.py, train/state.py ``param_grad_norms``,
the Trainer's loop fields):

* fed the same loss dicts, weights, norms, metrics and subject scores,
  the port's ``Writer`` writes ``full_scores.csv`` and
  ``per_subject_predictions/iter_N.txt`` byte-equal to JAX's;
* ``param_grad_norms`` on a combiner's parameters and a gradient of the
  same shapes: JAX's keys, in its order, and its values;
* the Trainer: ``profiling`` stops after 1 epoch and 10 batches a split,
  ``log_grad_norms_every`` puts the norms of every N-th step in
  ``full_scores.csv``, ``validation_frequency`` validates mid-epoch,
  ``profile_dir`` leaves a Chrome trace naming the steps;
* the analytic operation counts equal JAX's.
"""

import csv
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combiner_cases as cc
from __graft_entry__ import _flagship_cfg
from multimodal_neuroimage_tpu.evaluation.metrics import (
    SubjectAccumulator as JAccumulator)
from multimodal_neuroimage_tpu.obs import profiling as jprof
from multimodal_neuroimage_tpu.obs.writer import Writer as JWriter
from multimodal_neuroimage_tpu.train.state import (
    param_grad_norms as jparam_grad_norms)
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.evaluation.metrics import (
    SubjectAccumulator)
from multimodal_neuroimage_tpu_torch.obs import profiling as tprof
from multimodal_neuroimage_tpu_torch.obs.writer import Writer
from multimodal_neuroimage_tpu_torch.train import state as tstate
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _feed(writer, acc, to_scalar, epochs=2, steps=7, window=4):
    """The same run into a Writer: train steps (a running window of
    ``window``), padded eval batches, norms, metrics, subject scores."""
    rng = np.random.default_rng(0)
    for epoch in range(epochs):
        for s in range(steps):
            losses = {"binary_classification": rng.random() * 2,
                      "total": rng.random() * 3, "unet": rng.random()}
            writer.write_losses({k: to_scalar(v) for k, v in
                                 sorted(losses.items())}, "train")
            if s % 3 == 2:
                writer.write_norms({"grad/global": to_scalar(rng.random()),
                                    "param/swin": to_scalar(rng.random())},
                                   writer.total_train_steps)
        for w in (1.0, 0.5):
            writer.write_losses({"binary_classification": to_scalar(
                rng.random()), "total": to_scalar(rng.random())}, "val", w)
        writer.loss_summary(1e-3 * (epoch + 1))
        for mode, base in (("train", 0), ("val", 10)):
            acc.append([f"sub-{base + i % 3}" for i in range(6)],
                       rng.normal(size=6), np.asarray([i % 2 for i in
                                                       range(6)], float),
                       mode)
        writer.write_subject_predictions(acc)
        writer.record_metrics({"val_AUROC": float(rng.random()),
                               "train_loss": float(rng.random())})
        writer.save_history_to_csv()
        acc.reset()


def test_writer_files_are_jax_byte_for_byte(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    jw = JWriter(str(a), ["train", "val"], running_mean_size=4)
    tw = Writer(str(b), ["train", "val"], running_mean_size=4)
    _feed(jw, JAccumulator("binary_classification"),
          lambda v: jnp.asarray(v, jnp.float32))
    _feed(tw, SubjectAccumulator("binary_classification"),
          lambda v: torch.tensor(v, dtype=torch.float32))
    files = ["full_scores.csv", "per_subject_predictions/iter_0.txt",
             "per_subject_predictions/iter_1.txt"]
    for f in files:
        assert (b / f).read_bytes() == (a / f).read_bytes(), f
    with open(b / "full_scores.csv") as fh:
        header = next(csv.reader(fh))
    assert "total_train_loss_history" in header and "norm/grad/global" in \
        header and "lr" in header
    assert tw.total_train_steps == jw.total_train_steps == 14
    assert len(tw.loss_values["total_train"]) == 4      # the window


def test_param_grad_norms_match_jax():
    """A combiner's parameters and a gradient of their shapes (numpy
    draws, carried across by ``jax_params_to_state_dict``): the port's
    norms over flat buffers have JAX's keys, in the order JAX's jitted step
    returns them, and its values."""
    cfg, jmodel, params, port, batch = cc.setup("unet_add")
    grads = cc.random_params(jmodel, batch, seed=1)
    want = jparam_grad_norms(params, grads)
    gstate = jax_params_to_state_dict(grads)
    names = [n for n, _ in port.named_parameters()]
    flat_p = torch.cat([p.detach().reshape(-1) for p in port.parameters()])
    flat_g = torch.cat([gstate[n].reshape(-1) for n in names])
    got = tstate.param_grad_norms(tstate.top_level_segments(port), flat_p,
                                  flat_g)
    assert list(got) == sorted(want)
    assert {k.split("/")[1] for k in got} == set(params) | {"global"}
    for k in got:
        cc.close(got[k], want[k], k, 1e-5, 1e-6)


def _tiny(tmp_path, **kw):
    kw = {"nEpochs": 3, **kw}
    jcfg = dataclasses.replace(
        _flagship_cfg(tiny=True), compute_dtype="float32", preprocess="host",
        batch_size=2, lr_init=1e-3, experiment_title="tiny", seed=3,
        **kw).validate()
    return Config(**dataclasses.asdict(jcfg))


def _records(cfg, n, seed):
    rng = np.random.default_rng(seed)
    R = cfg.intermediate_vec
    return [{"subject": f"sub-{seed}-{i:02d}",
             "fmri": rng.normal(size=(R, 360)) + 50.0,
             "struct": rng.normal(size=(R, R)), "target": float(i % 2)}
            for i in range(n)]


def test_profiling_run_stops_at_one_epoch_and_ten_batches(tmp_path):
    """24 train and 24 val subjects at batch 2 (12 batches each) and 3
    epochs: ``profiling`` trains 10 steps of one epoch and validates 10
    batches; ``log_grad_norms_every`` 3 writes the norms of steps 3, 6 and
    9; ``profile_dir`` leaves a Chrome trace naming the train steps."""
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny(tmp_path, profiling=True, log_grad_norms_every=3,
                profile_dir=str(tmp_path / "prof"))
    tr = Trainer(cfg, _records(cfg, 24, 0), _records(cfg, 24, 1),
                 device="cpu", experiment_folder=str(tmp_path / "exp"))
    tr.training()
    assert tr.global_step == tr.writer.total_train_steps == 10
    assert len(tr.writer.loss_history["total_train_loss_history"]) == 1
    assert len(tr.step_losses) == 10 and np.isfinite(tr.step_losses).all()
    with open(tmp_path / "exp" / "full_scores.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["norm/grad/global"] != "" for r in rows] == [True] * 3
    assert {"norm/grad/fmri_embed", "norm/param/swin",
            "total_train_loss_history", "lr"} <= set(rows[0])
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1
    with open(tmp_path / "prof" / traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"train_step", "eval_step"} <= names
    iters = os.listdir(tmp_path / "exp" / "per_subject_predictions")
    assert iters == ["iter_0.txt"]
    text = (tmp_path / "exp" / "per_subject_predictions" /
            "iter_0.txt").read_text()
    assert text.count("(val)") == 20 and text.count("(train)") == 20


def test_validation_frequency_validates_mid_epoch(tmp_path):
    """``validation_frequency`` 2 over 3 train batches: one validation
    mid-epoch, one at its end (two metric rows, two val loss means)."""
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    cfg = _tiny(tmp_path, validation_frequency=2, nEpochs=1)
    tr = Trainer(cfg, _records(cfg, 6, 0), _records(cfg, 4, 1),
                 device="cpu", experiment_folder=str(tmp_path / "exp"))
    tr.training()
    assert tr.writer.eval_iter == 2
    assert len(tr.writer.metric_history["val_AUROC"]) == 2
    # both validations' batches average into the epoch's val loss
    assert len(tr.writer.loss_history["total_val_loss_history"]) == 1


def test_profile_trace_is_written_when_the_region_raises(tmp_path):
    """A run that fails inside ``profile_trace`` still leaves its trace,
    with the ranges opened before the error."""
    with pytest.raises(RuntimeError, match="mid-run"):
        with tprof.profile_trace(str(tmp_path), device="cpu"):
            with tprof.trace_annotation("train_step"):
                torch.ones(4).sum()
            raise RuntimeError("mid-run")
    traces = os.listdir(tmp_path)
    assert len(traces) == 1
    with open(tmp_path / traces[0]) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "train_step" in names


@pytest.mark.parametrize("fn,args", [
    ("attention_flops", (49, 96, 3)), ("mlp_flops", (49, 96, 4.0)),
    ("swin_block_flops", (12, 12, 24, 6, 6)), ("swin_encoder_flops", ()),
    ("bert_flops", (369, 84, 16))])
def test_operation_counts_equal_jax(fn, args):
    assert getattr(tprof, fn)(*args) == getattr(jprof, fn)(*args)
