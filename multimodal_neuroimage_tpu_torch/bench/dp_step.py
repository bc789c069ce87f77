"""One rank of the flagship's data-parallel training step, and its
one-process yardsticks (parallel/mesh.py).

    torchrun --standalone --nproc_per_node N \\
        -m multimodal_neuroimage_tpu_torch.bench.dp_step OUT \\
        [--backend nccl|gloo] [--device cuda:0] [--compare]

Each rank builds the flagship (``FuncStructCross``) at full width under its
bf16 default from one seed, every dropout rate 0, joins the launcher's
process group and takes ``STEPS`` AdamW updates at a constant learning
rate: step s on its rows ``r * BATCH`` to ``(r + 1) * BATCH`` of global
batch s (``global_batches``: W * BATCH subjects drawn from numpy).
``--backend gloo`` starts a gloo group, which two ranks on one card need
(NCCL refuses two ranks on one device), with ``--device`` naming the card;
the default is the port's own choice, NCCL on ``cuda:{LOCAL_RANK}``. cuDNN
runs its deterministic algorithms, as under the Trainer
(``build_step``: utils/reproducibility.py ``deterministic_algorithms``; its
default weight- and input-gradient algorithms of the backbone's convs vary
run to run, which the comparisons below would read as a difference). Each
rank writes ``OUT.rank<r>.pt``: the flat parameters and K5's moments after
the last update, the first step's averaged gradient, each step's losses,
the kernel launches of its steps (every count set to 0 just before them),
the parameters' names and sizes, and the all-reduce's time at K5's flat
gradient buffer (the median of ``ALLREDUCE_ITERS`` CUDA-synchronised calls
of ``all_reduce_mean_``, after two of warm-up).

The yardsticks of W ranks, one process on the same rows:

- ``accumulated_reference``: ``accumulation_steps`` W, micro-step ``s * W
  + r`` on rank r's rows of step s, at the same learning rate at every
  update (K5 counts updates, so both runs read the constant schedule
  alike); it differs from the ranks only in how the mean of the W
  gradients is summed;
- ``micro_gradients``: the W gradients of the first step, whose float64
  mean the first step's averaged gradient is held against.

``--compare``: after the ranks, rank 0 runs both on its card and prints
``worst_difference`` of each. The parameters after AdamW are the
ill-conditioned side: a mean that cancels to about zero can change sign
with its last rounding, and AdamW turns the sign into a step of about the
learning rate.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

LR = 1e-3
SEED = 20261019
BATCH, STEPS = 4, 2          # a rank's batch, updates
ALLREDUCE_ITERS = 10
NO_DROPOUT = dict(transformer_dropout_rate=0.0, bert_attn_dropout=0.0,
                  fusion_drop_rate=0.0, fusion_attn_drop_rate=0.0,
                  fusion_drop_path_rate=0.0)


def flagship_config(batch: int = BATCH, **kw):
    """The flagship at its defaults (bf16 policy, std layout), ``batch``
    subjects a rank, dropout off."""
    from multimodal_neuroimage_tpu_torch.config import Config
    return Config(task="FuncStruct", dataset_name="multimodal",
                  multimodality_type="cross_attention", target="sex",
                  fine_tune_task="binary_classification", batch_size=batch,
                  preprocess="host", seed=SEED, **NO_DROPOUT,
                  **kw).validate()


def global_batches(world: int, batch: int, steps: int,
                   seed: int = SEED) -> List[Dict[str, np.ndarray]]:
    """``steps`` global batches of ``world * batch`` subjects: the
    flagship's two bands (368 TRs x 84 ROIs), its 84 x 84 matrix and
    alternating targets, from numpy."""
    rng = np.random.default_rng(seed)
    n = world * batch
    out = []
    for _ in range(steps):
        b = {k: rng.normal(size=(n, 368, 84)).astype(np.float32)
             for k in ("fmri_lowfreq_sequence",
                       "fmri_ultralowfreq_sequence")}
        b["struct"] = rng.normal(size=(n, 84, 84)).astype(np.float32)
        b["target"] = (np.arange(n) % 2).astype(np.float32)
        out.append(b)
    return out


def rows(batch: Dict[str, np.ndarray], r: int, size: int):
    """Rank ``r``'s rows of a global batch (data/loader.py's order)."""
    return {k: v[r * size:(r + 1) * size] for k, v in batch.items()}


def build_step(cfg, device, accumulation_steps: int = 1):
    """(model, K5 optimizer, train step) of ``cfg`` on ``device`` from
    ``SEED``'s random weights, AdamW at the constant ``LR``, with cuDNN's
    deterministic algorithms on a CUDA device (as the Trainer selects
    them)."""
    from multimodal_neuroimage_tpu_torch.models.registry import (
        create_model, init_random_weights)
    from multimodal_neuroimage_tpu_torch.train.losses import active_losses
    from multimodal_neuroimage_tpu_torch.train.state import (
        create_optimizer, make_train_step)
    from multimodal_neuroimage_tpu_torch.utils.reproducibility import (
        deterministic_algorithms)
    deterministic_algorithms(device)
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(SEED))
    model.to(device)
    opt = create_optimizer("adamw", model.parameters(), lambda t: LR,
                           cfg.weight_decay,
                           accumulation_steps=accumulation_steps)
    step = make_train_step(model, active_losses(cfg.task,
                                                cfg.fine_tune_task),
                           opt, cfg.compute_dtype, device)
    return model, opt, step


def accumulated_reference(world: int, device="cuda") -> torch.Tensor:
    """The flat parameters after ``STEPS`` updates of one process with
    ``accumulation_steps`` = ``world`` on the ranks' rows in turn."""
    _, opt, step = build_step(flagship_config(), device, world)
    gen = torch.Generator().manual_seed(SEED + 2)
    for s, b in enumerate(global_batches(world, BATCH, STEPS)):
        for r in range(world):
            step(rows(b, r, BATCH), gen, s * world + r)
    if opt.count != STEPS:
        raise AssertionError(f"{opt.count} updates, expected {STEPS}")
    return opt.params.detach().cpu().clone()


def micro_gradients(world: int, device="cuda") -> List[torch.Tensor]:
    """The W ranks' gradients of the first step, one process: each rank's
    rows of global batch 0 at the initial weights (``accumulation_steps``
    W holds the update back), as K5's flat buffer after each micro-step
    (bf16-rounded under the bf16 policy)."""
    _, opt, step = build_step(flagship_config(), device, world)
    gen = torch.Generator().manual_seed(SEED + 2)
    b = global_batches(world, BATCH, 1)[0]
    out = []
    for r in range(world):
        step(rows(b, r, BATCH), gen, r)
        out.append(opt.grads.detach().cpu().clone())
    return out


def worst_difference(result: Dict, reference: torch.Tensor,
                     key: str = "params"):
    """(max |diff| / max-abs, name) of the parameter tensor of ``result``'s
    flat ``key`` buffer farthest from ``reference``'s, each against its own
    max-abs."""
    worst, off = (-1.0, ""), 0
    for name, n in result["sizes"]:
        a, b = result[key][off:off + n], reference[off:off + n]
        off += n
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        worst = max(worst, (err / scale if scale else err, name))
    return worst


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def allreduce_ms(buf: torch.Tensor, iters: int = ALLREDUCE_ITERS) -> float:
    """Median ms of ``iters`` CUDA-synchronised ``all_reduce_mean_`` calls
    on ``buf`` (after two of warm-up); every rank calls it together."""
    from multimodal_neuroimage_tpu_torch.parallel.mesh import (
        all_reduce_mean_)
    times = []
    for i in range(iters + 2):
        _sync(buf.device)
        t0 = time.perf_counter()
        all_reduce_mean_(buf)
        _sync(buf.device)
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run_rank(out: str, backend: str, device: str) -> Dict:
    """This rank's steps (module docstring); returns what it writes."""
    import torch.distributed as dist
    from multimodal_neuroimage_tpu_torch import ops
    from multimodal_neuroimage_tpu_torch.parallel import mesh
    if backend == "gloo":
        dist.init_process_group("gloo", init_method="env://")
    cfg = flagship_config(distributed=True)
    device = mesh.maybe_initialize_distributed(cfg, device)
    r, world = mesh.rank(), mesh.world()
    model, opt, step = build_step(cfg, device)
    gen = torch.Generator().manual_seed(SEED + 2)
    batches = global_batches(world, BATCH, STEPS)
    _sync(device)
    ops.reset_launches()
    losses, first_grads = [], None
    for s, b in enumerate(batches):
        got, _, _ = step(rows(b, r, BATCH), gen, s)
        losses.append({k: float(v) for k, v in got.items()})
        if first_grads is None:
            first_grads = opt.grads.detach().cpu().clone()
    _sync(device)
    counts = {k: n for k, n in ops.launches().items() if n}
    result = {"rank": r, "world": world, "backend": dist.get_backend(),
              "device": device,
              "device_name": (torch.cuda.get_device_name(device)
                              if torch.device(device).type == "cuda"
                              else "cpu"),
              "params": opt.params.detach().cpu().clone(),
              "mu": opt.mu.detach().cpu().clone(),
              "nu": opt.nu.detach().cpu().clone(), "losses": losses,
              "first_grads": first_grads, "launches": counts,
              "count": opt.count,
              "sizes": [(n, p.numel()) for n, p in model.named_parameters()],
              "allreduce_ms": allreduce_ms(opt.grads.clone()),
              "allreduce_bytes": 4 * opt.grads.numel()}
    torch.save(result, f"{out}.rank{r}.pt")
    mesh.shutdown()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "multimodal_neuroimage_tpu_torch.bench.dp_step")
    p.add_argument("out")
    p.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    p.add_argument("--device", default="cuda")
    p.add_argument("--compare", action="store_true")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("dp_step: no CUDA device")
    if "RANK" not in os.environ:
        raise SystemExit("dp_step: run under a launcher (torchrun) that "
                         "sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR "
                         "and MASTER_PORT")
    res = run_rank(a.out, a.backend, a.device)
    print(f"rank {res['rank']} of {res['world']} ({res['backend']}, "
          f"{res['device_name']}): losses "
          f"{[round(l['total'], 6) for l in res['losses']]}; launches "
          f"{res['launches']}; all-reduce of {res['allreduce_bytes']} B "
          f"{res['allreduce_ms']:.3f} ms")
    if a.compare and res["rank"] == 0:
        rel, name = worst_difference(
            res, accumulated_reference(res["world"], res["device"]))
        micro = micro_gradients(res["world"], res["device"])
        grel, gname = worst_difference(
            res, torch.stack([g.double() for g in micro]).mean(0),
            "first_grads")
        print(f"rank 0 vs one process over the same rows: the first step's "
              f"averaged gradient vs the float64 mean of the "
              f"{res['world']} micro-step gradients, largest max|diff| / "
              f"max-abs {grel:.3e} ({gname}); the parameters after {STEPS} "
              f"updates vs accumulation_steps={res['world']}, {rel:.3e} "
              f"({name}); {res['device_name']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
