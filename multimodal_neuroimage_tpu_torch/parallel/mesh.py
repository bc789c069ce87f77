"""Processes, ranks and collectives (counterpart of
multimodal_neuroimage_tpu/parallel/mesh.py).

The port runs one process per GPU under ``torch.distributed``, launched by
``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``). A rank is a JAX process with one device, and the
semantics are those of the JAX package's ``shard_map`` step
(train/state.py ``make_train_step``), the path its Pallas kernels take on
several chips:

- ``cfg.batch_size`` is per rank, as it is per process in JAX, so the
  global batch is ``batch_size * world()``; ``DataPipeline`` gives rank r
  the rows ``order[step * bs * W + r * bs:][:bs]`` (data/loader.py);
- each rank runs forward and backward on its own rows, and the work that
  couples a batch stays within the rank (``BatchStatNorm``, the merge,
  contrastive and mask losses);
- one ``all_reduce`` over K5's flat gradient buffer averages the
  gradients (JAX's single ``pmean``), one more the step's losses.

What JAX's module has and this one does not:

- ``build_mesh``, ``mesh_for_batch``, ``batch_sharding`` /
  ``replicated_sharding``, ``shard_batch``, ``replicate`` and
  ``host_local_rows``: each rank holds one device and its own rows, so
  there is no mesh to build and no global array to cut. The parameters stay
  replicated by construction: every rank starts from rank 0's weights
  (``broadcast_``) and applies the same averaged gradient;
- ``force_host_devices``: the CPU tests start real processes under gloo.

Collectives on device tensors are ``all_reduce`` and ``broadcast`` only
(NCCL on the card, gloo on the CPU). Host gathers (subject scores, names,
the study's messages) go through a gloo group on CPU tensors, so that a
run under NCCL never copies host values to the card for them.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist

# the gloo group of the host gathers, made once by ``maybe_initialize_
# distributed`` on every rank (None: the default group is gloo already)
_HOST_GROUP = None


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    """The number of ranks (1 without a process group)."""
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if initialized() else 0


def visible_chip_count() -> int:
    """The CUDA devices this process sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def check_parallel_config(cfg, world_size: int) -> None:
    """Refuse what the port does not run across ``world_size`` ranks:
    ``spmd_mode="gspmd"`` above one rank (JAX's GSPMD step couples the
    batch-statistics norms and the batch losses across the global batch;
    the port has no such program), a ``mesh_shape`` other than None or
    ``(world_size,)``, and ``mesh_axes`` other than ``("data",)``."""
    if world_size > 1 and cfg.spmd_mode == "gspmd":
        raise ValueError(
            f"spmd_mode='gspmd' at world size {world_size}: the port runs "
            f"JAX's shard_map step (per-rank forward and backward, one "
            f"gradient mean); use spmd_mode 'auto' or 'shard_map'")
    shape = cfg.mesh_shape
    if shape is not None and tuple(int(s) for s in shape) != (world_size,):
        raise ValueError(
            f"mesh_shape={tuple(shape)}: the port's mesh is one 'data' axis "
            f"of one device a rank, ({world_size},) at this world size; "
            f"leave mesh_shape unset")
    axes = cfg.mesh_axes
    if isinstance(axes, str):        # the CLI's string form
        axes = tuple(axes.replace(",", " ").split())
    if tuple(axes) != ("data",):
        raise ValueError(f"mesh_axes={axes!r}: the port has one 'data' axis")


def maybe_initialize_distributed(cfg, device="cuda") -> str:
    """Join the launcher's process group and return this rank's device.

    - ``WORLD_SIZE`` > 1 in the environment while ``cfg.distributed`` is
      false raises: W processes would each train their own copy into one
      folder.
    - ``cfg.distributed`` without a launcher's environment (no ``RANK`` /
      ``WORLD_SIZE``) runs as one process and says so, as JAX's
      ``maybe_initialize_distributed`` does.
    - Otherwise the process group starts from the environment (``env://``:
      ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL for a CUDA device, which is
      ``cuda:{LOCAL_RANK}`` unless ``device`` names an index, made current;
      gloo for ``cpu``. A group that the caller started already is kept,
      whatever its backend.

    Then ``check_parallel_config`` at the group's world size."""
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if env_world > 1 and not cfg.distributed and not initialized():
        raise ValueError(
            f"WORLD_SIZE={env_world} in the environment but distributed is "
            f"off: pass --distributed (Config.distributed=True), or each of "
            f"the {env_world} processes trains its own copy into one folder")
    dev = torch.device(device)
    if not cfg.distributed and not initialized():
        check_parallel_config(cfg, 1)
        return str(dev)
    if not initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            print("[dist] distributed=True without a launcher's environment "
                  "(RANK, WORLD_SIZE): running as one process")
            check_parallel_config(cfg, 1)
            return str(dev)
        r = int(os.environ["RANK"])
        local = int(os.environ.get("LOCAL_RANK", r))
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", local)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", rank=r,
                                world_size=env_world)
    elif dev.type == "cuda":
        if dev.index is None:
            dev = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank())))
        torch.cuda.set_device(dev)
    _ensure_host_group()
    check_parallel_config(cfg, world())
    return str(dev)


def _ensure_host_group() -> None:
    """Make the gloo group of the host gathers once, on every rank (a
    collective: every rank reaches it in the same order)."""
    global _HOST_GROUP
    if _HOST_GROUP is None and dist.get_backend() != "gloo":
        _HOST_GROUP = dist.new_group(backend="gloo")


def shutdown() -> None:
    """Leave the process group (the CLI's last act under a launcher)."""
    global _HOST_GROUP
    if initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def local_batch_slice(n_items: int) -> slice:
    """This rank's contiguous share of ``n_items`` (JAX
    ``local_batch_slice``; the reference's DistributedSampler rank
    slicing)."""
    per = n_items // world()
    return slice(rank() * per, (rank() + 1) * per)


def all_reduce_mean_(t: torch.Tensor) -> torch.Tensor:
    """Average ``t`` over the ranks in place (sum, then divide by the world
    size; the same result on every rank) and return it. Without a process
    group it is left as it is."""
    if initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        t.div_(world())
    return t


def agreed(fn: Callable[[], Any]) -> Any:
    """``fn()`` on every rank, an error of any rank raised on every rank
    once all have ended ``fn``: the ranks take one host all-reduce of a
    flag a rank a call (no device synchronisation: the allocator and the
    launchers raise on the host), so that no rank is left in the step's
    collectives after another failed. Where every failure is out of
    memory, each rank raises ``torch.cuda.OutOfMemoryError`` naming the
    ranks (the failed call's tensors go with its own error first);
    otherwise a rank raises its own error, or a ``RuntimeError`` naming
    the ranks that failed. Without a process group ``fn`` runs as it
    is."""
    if not initialized():
        return fn()
    own, oom = None, ""
    try:
        out = fn()
    except torch.cuda.OutOfMemoryError as e:
        oom, out = f": {e}", None
    except Exception as e:
        own, out = e, None
    flags = torch.zeros(world(), dtype=torch.int32)
    flags[rank()] = 2 if own is not None else int(bool(oom))
    dist.all_reduce(flags, op=dist.ReduceOp.SUM, group=_HOST_GROUP)
    failed = ", ".join(str(r) for r in flags.nonzero().flatten().tolist())
    if own is not None:
        raise own
    if int(flags.max()) == 2:
        raise RuntimeError(f"the step failed on rank {failed}")
    if failed:
        raise torch.cuda.OutOfMemoryError(
            f"out of memory on rank {failed}{oom}")
    return out


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if initialized():
        dist.broadcast(t, src)
    return t


def barrier() -> None:
    """Wait for every rank (on the host group), e.g. before reading a file
    that rank 0 writes."""
    if initialized():
        dist.barrier(group=_HOST_GROUP)


def process_allgather(x) -> np.ndarray:
    """Every rank's host array of one shape, stacked in rank order as
    ``(world, *x.shape)``; ``x[None]`` without a process group. (JAX's
    returns ``x`` itself on one process; the callers here reshape.)"""
    x = np.ascontiguousarray(np.asarray(x))
    if not initialized():
        return x[None]
    t = torch.from_numpy(x)
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t, group=_HOST_GROUP)
    return np.stack([o.numpy() for o in out])


def gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    process group)."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * world()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_HOST_GROUP)
    return box[0]


def broadcast_buffer(buf: np.ndarray, src: int = 0) -> np.ndarray:
    """Rank ``src``'s fixed-shape uint8 host buffer on every rank (the
    study's messages, hpo/optuna_harness.py)."""
    if not initialized():
        return buf
    t = torch.from_numpy(np.ascontiguousarray(buf, dtype=np.uint8).copy())
    dist.broadcast(t, src, group=_HOST_GROUP)
    return t.numpy()
