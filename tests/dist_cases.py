"""Ranks of the port under ``torch.distributed`` for tests/test_torch_dist.py.

``spawn(case, payload, tmp)`` starts one process per rank on the CPU
(gloo, ``MASTER_ADDR`` 127.0.0.1, a port from ``bind(0)``), each running
``python tests/dist_cases.py CASE IN OUT`` with ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` set, waits for all of them within its own timeout (a hung
rendezvous kills the ranks and fails that test alone) and returns each
rank's result. A rank imports torch and the port only, takes one thread,
and writes its result with ``torch.save``.

Cases (``CASES``): ``step`` (train steps on a global batch's rows),
``trainer`` (a Trainer on a cohort on disk: files written, metrics, resume,
run_predict), ``draws`` (dropout seeds, DropPath factors and a flagship
forward with dropout on), ``gather`` (``gather_ragged`` and the subject
metrics), ``study`` (a two-trial study), ``desync`` and ``abort`` (the
study's channel raising on every rank), ``fault`` (a study whose
follower runs out of memory, or meets a kernel's error, in one trial).
"""

import builtins
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(case, payload, tmp, world=2, timeout=240.0):
    """Run ``case`` on ``world`` ranks; their results in rank order. Raises
    AssertionError with every rank's log when a rank fails or the ranks
    outlast ``timeout`` seconds (then every rank is killed)."""
    tmp = str(tmp)
    inp = os.path.join(tmp, f"{case}.in.pt")
    torch.save(payload, inp)
    port = free_port()
    ranks = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = os.path.join(tmp, f"{case}.{r}.out.pt")
        log = os.path.join(tmp, f"{case}.{r}.log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, inp, out],
                cwd=REPO, env=env, stdout=fh, stderr=subprocess.STDOUT)
        ranks.append((proc, out, log))
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for proc, _, _ in ranks:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for proc, _, _ in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    logs = "\n".join(f"--- rank {r} (rc {p.returncode})\n" + open(log).read()
                     for r, (p, _, log) in enumerate(ranks))
    assert not timed_out, f"{case}: ranks outlasted {timeout} s\n{logs}"
    assert all(p.returncode == 0 for p, _, _ in ranks), logs
    return [torch.load(out, weights_only=False) for _, out, _ in ranks]


# ---- the ranks' side -------------------------------------------------------------


def _join(**change):
    """Join the process group (gloo on the CPU) with a default Config."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed)
    cfg = Config(distributed=True, **change)
    return cfg, maybe_initialize_distributed(cfg, "cpu")


def no_bert_dropout(model):
    """The rates the models fix, zeroed (tests/combiner_cases.py)."""
    from multimodal_neuroimage_tpu_torch.nn.bert import BertEncoder, BertLayer
    for m in model.modules():
        if isinstance(m, BertLayer):
            m.rates = (0.0, 0.0)
        elif isinstance(m, BertEncoder):
            m.hidden_dropout = 0.0
    return model


def case_step(p):
    """Train steps of ``p["cfg"]`` from ``p["state"]``, AdamW at the
    constant ``p["lr"]``: step i on this rank's rows of ``p["batches"][i]``.
    Returns each step's losses and averaged gradient, and the parameters
    after the last."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.parallel.mesh import (
        maybe_initialize_distributed, rank)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (
        create_optimizer, make_train_step)
    cfg = Config(**p["cfg"])
    maybe_initialize_distributed(cfg, "cpu")
    model = create_model(cfg)
    model.load_state_dict(p["state"])
    if p.get("no_bert_dropout"):
        no_bert_dropout(model)
    names = [n for n, _ in model.named_parameters()]
    opt = create_optimizer("adamw", model.parameters(), lambda t: p["lr"],
                           p["weight_decay"])
    step = make_train_step(model, active_losses(
        cfg.task, cfg.fine_tune_task, use_merge_loss=cfg.use_merge_loss),
        opt, cfg.compute_dtype, "cpu")
    gen = torch.Generator().manual_seed(cfg.seed)
    bs, r = cfg.batch_size, rank()
    out = {"losses": [], "grads": []}
    for i, batch in enumerate(p["batches"]):
        rows = {k: v[r * bs:(r + 1) * bs] for k, v in batch.items()}
        losses, _, _ = step(rows, gen, i)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        out["grads"].append({n: v.detach().clone()
                             for n, v in zip(names, opt._views)})
    out["params"] = {n: t.detach().clone()
                     for n, t in model.named_parameters()}
    return out


def _record_writes(root):
    """Every path under ``root`` this process opens for writing or
    ``torch.save``s to (a list that grows)."""
    root = os.path.abspath(root)
    written = []
    real_open, real_save = builtins.open, torch.save

    def note(path):
        path = os.path.abspath(os.fspath(path))
        if path.startswith(root):
            written.append(os.path.relpath(path, root))

    def open_(file, mode="r", *a, **k):
        if isinstance(file, (str, os.PathLike)) and any(
                c in mode for c in "wax+"):
            note(file)
        return real_open(file, mode, *a, **k)

    def save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):
            note(f)
        return real_save(obj, f, *a, **k)

    builtins.open = open_
    torch.save = save
    return written


def case_trainer(p):
    """On the cohort at ``p["root"]``: a 1-epoch Trainer in folder a, a
    2-epoch Trainer resuming in a, a 2-epoch Trainer in b, and run_predict
    of b; the files this rank wrote, the metrics and thresholds, the
    parameters of both 2-epoch runs, the predictions."""
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.serve.predictor import run_predict
    from multimodal_neuroimage_tpu_torch.train.trainer import Trainer
    from multimodal_neuroimage_tpu_torch.parallel.mesh import barrier
    written = _record_writes(p["out"])
    out = {}

    def cfg(folder, epochs):
        return synthetic.synthetic_config(
            p["root"], **{**p["cfg"], "nEpochs": epochs,
                          "experiment_folder": os.path.join(p["out"], folder),
                          "distributed": True}).validate()

    first = Trainer(cfg("a", 1), device="cpu")
    out["metrics"] = first.training()
    out["threshold"] = first.val_threshold
    out["steps"] = first.steps_per_epoch
    resumed = Trainer(cfg("a", 2), device="cpu")
    out["epoch0"] = resumed.epoch0
    resumed.training()
    whole = Trainer(cfg("b", 2), device="cpu")
    out["whole_metrics"] = whole.training()
    for key, tr in (("resumed", resumed), ("whole", whole)):
        out[key] = {"params": {n: t.detach().clone() for n, t in
                               tr.model.named_parameters()},
                    "mu": tr.optimizer.mu.clone(),
                    "generator": tr.generator.get_state(),
                    "step_losses": tr.step_losses}
    out["predictions"] = run_predict(cfg("b", 2), device="cpu")
    barrier()
    out["written"] = sorted(set(written))
    return out


def case_draws(p):
    """Dropout seeds, DropPath factors of a batch of 4 and a dropout mask
    drawn from one seeded generator on this rank, the generator's state
    after, and the tiny flagship's training forward (dropout on) on the
    batch ``p["batch"]`` from ``p["state"]``."""
    from multimodal_neuroimage_tpu_torch.config import Config
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.nn.common import (draw_seed,
                                                           drop_path_factors,
                                                           dropout)
    from multimodal_neuroimage_tpu_torch.train.state import batch_to_device
    _join()
    gen = torch.Generator().manual_seed(7)
    out = {"seeds": [draw_seed(gen) for _ in range(3)],
           "factors": drop_path_factors((4, 2), 0.5, gen),
           "mask": dropout(torch.ones(4, 3, 16), 0.5, draw_seed(gen))}
    out["state"] = gen.get_state()
    model = create_model(Config(**p["cfg"]))
    model.load_state_dict(p["state"])
    with torch.no_grad():
        out["logits"] = model.train()(
            batch_to_device(p["batch"], "cpu"),
            generator=torch.Generator().manual_seed(3))[
                "binary_classification"]
    return out


def case_gather(p):
    """``gather_ragged`` of rank r's ``p["parts"][r]``, ``process_allgather``
    of a fixed row, and the summary of rank r's share of the subjects."""
    from multimodal_neuroimage_tpu_torch.evaluation.metrics import (
        SubjectAccumulator, gather_ragged)
    from multimodal_neuroimage_tpu_torch.parallel.mesh import (
        process_allgather, rank)
    _join()
    r = rank()
    acc = SubjectAccumulator()
    subs, scores, truths = p["subjects"][r]
    acc.append(subs, scores, truths, "val")
    return {"ragged": gather_ragged(p["parts"][r]),
            "stacked": process_allgather([r, 10 + r]),
            "per_subject": acc.per_subject("val"),
            "summary": acc.summary(["val"])}


def _study_cfg(p):
    from multimodal_neuroimage_tpu_torch.data import synthetic
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    oh.SEARCH_SPACE["batch_size"] = ("cat", [2], None, False)
    return synthetic.synthetic_config(
        p["root"], **{**p["cfg"], "distributed": True}).validate()


def case_study(p):
    """A study of ``num_trials`` trials; the trial parameters each rank
    trained, and ``run_study``'s result."""
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    from multimodal_neuroimage_tpu_torch.train import trainer as tmod
    cfg = _study_cfg(p)
    trained = []

    class Recording(tmod.Trainer):
        def __init__(self, c, *a, **k):
            trained.append({k: getattr(c, k) for k in oh.SEARCH_SPACE}
                           | {"folder": c.experiment_folder})
            super().__init__(c, *a, **k)

    tmod.Trainer = Recording
    return {"trained": trained, "result": oh.run_study(cfg, device="cpu")}


def case_fault(p):
    """A study whose follower meets ``p["fault"]`` in trial 1's first
    training step: out of memory (each rank's trained trials,
    ``run_study``'s result and its count of the channel's messages) or the
    launcher's own error (each rank's error)."""
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    from multimodal_neuroimage_tpu_torch.parallel.mesh import rank
    from multimodal_neuroimage_tpu_torch.train import state as smod
    from multimodal_neuroimage_tpu_torch.train import trainer as tmod
    cfg = _study_cfg(p)
    trained = []

    class Recording(tmod.Trainer):
        def __init__(self, c, *a, **k):
            trained.append(os.path.basename(c.experiment_folder))
            super().__init__(c, *a, **k)

    losses = smod.compute_losses

    def compute_losses(*a, **k):
        if rank() == 1 and trained[-1] == "trial_1":
            if p["fault"] == "oom":
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory (injected on rank 1)")
            raise RuntimeError("bert_layer_forward failed: cudaError 2")
        return losses(*a, **k)

    tmod.Trainer = Recording
    smod.compute_losses = compute_losses
    try:
        result = oh.run_study(cfg, device="cpu")
    except Exception as e:
        return {"trained": trained, "raised": f"{type(e).__name__}: {e}"}
    return {"trained": trained, "result": result, "seq": oh._CHANNEL.seq,
            "raised": None}


def case_desync(p):
    """Rank 1 counts one message more than the leader; each rank's error
    on the next broadcast."""
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    from multimodal_neuroimage_tpu_torch.parallel.mesh import rank
    _join()
    oh._CHANNEL.seq += rank()
    try:
        oh.broadcast_params({"lr_init": 1e-4})
    except RuntimeError as e:
        return {"raised": str(e)}
    return {"raised": None}


def case_abort(p):
    """A study whose leader fails to write its checkpoint in trial 0: each
    rank's error."""
    from multimodal_neuroimage_tpu_torch.ckpt import checkpoint
    from multimodal_neuroimage_tpu_torch.hpo import optuna_harness as oh
    from multimodal_neuroimage_tpu_torch.parallel.mesh import rank
    cfg = _study_cfg(p)

    def fail(*a, **k):
        raise OSError("disk full (injected)")

    if rank() == 0:
        checkpoint.save_checkpoint = fail
    from multimodal_neuroimage_tpu_torch.train import trainer as tmod
    tmod.save_checkpoint = checkpoint.save_checkpoint
    try:
        oh.run_study(cfg, device="cpu")
    except Exception as e:
        return {"raised": f"{type(e).__name__}: {e}"}
    return {"raised": None}


CASES = {"step": case_step, "trainer": case_trainer, "draws": case_draws,
         "gather": case_gather, "study": case_study, "desync": case_desync,
         "abort": case_abort, "fault": case_fault}


if __name__ == "__main__":
    case, inp, out = sys.argv[1:4]
    torch.set_num_threads(1)
    result = CASES[case](torch.load(inp, weights_only=False))
    torch.save(result, out)
    from multimodal_neuroimage_tpu_torch.parallel.mesh import shutdown
    shutdown()
