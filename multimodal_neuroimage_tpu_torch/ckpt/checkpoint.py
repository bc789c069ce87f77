"""The port's checkpoint format (counterpart of multimodal_neuroimage_tpu/ckpt/checkpoint.py).

One ``torch.save`` file holding the whole train state: ``state_dict``,
the optimizer (K5's flat moments ``mu`` / ``nu``, its update ``count``
and, under gradient accumulation, the running mean ``acc`` of the
micro-step gradients and its ``mini_step``), ``step`` and ``epoch``, the
state of the host ``torch.Generator`` that draws every dropout seed, and
``metadata`` (the frozen g-mean validation threshold as ``val_threshold``,
which ``Trainer.testing`` and the Predictor read as the JAX package's do).
Files are read with ``weights_only=True``: tensors and plain containers
only, no arbitrary unpickling.

A file written before the train state was saved holds ``state_dict`` and
``metadata`` only: it loads with ``optimizer`` and ``generator`` None,
and a resumed run starts a fresh optimizer with a warning (the JAX
Trainer's ``fresh_opt_state`` fallback). A file that is not a port
checkpoint (a JAX flax-msgpack ``.ckpt`` in the same tree, say) raises
``ValueError`` naming it.

``partial_restore`` is the phase-chaining merge (JAX ``partial_restore``)
on the port's state dicts, at the granularity of JAX's parameter leaves:
a stack that JAX keeps as one scanned leaf (a BERT's layers, a SwinV2 or
fusion stage's block pairs) is copied whole or not at all.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

State = Dict[str, torch.Tensor]


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    metadata: Optional[Dict[str, Any]] = None, *,
                    optimizer: Optional[Dict[str, Any]] = None,
                    step: int = 0, epoch: int = 0,
                    generator: Optional[torch.Tensor] = None) -> str:
    """Write the train state atomically (a temporary file, then rename).
    ``optimizer``: ``FusedAdam.state()``; ``generator``: a
    ``torch.Generator``'s ``get_state()``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()},
               "metadata": dict(metadata or {}),
               "optimizer": None if optimizer is None else {
                   k: v.detach().cpu() if torch.is_tensor(v) else v
                   for k, v in optimizer.items()},
               "step": int(step), "epoch": int(epoch),
               "generator": generator}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{"state_dict", "metadata", "optimizer", "step", "epoch",
    "generator"}; an older file's missing train state comes back as None
    (``epoch`` from its metadata where it recorded one, else -1)."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(f"{path} is not a checkpoint of the PyTorch port "
                         f"({type(e).__name__}: {e})") from e
    if not isinstance(payload, dict) or "state_dict" not in payload:
        raise ValueError(f"{path} is not a checkpoint of the PyTorch port "
                         f"(no state_dict)")
    meta = payload.get("metadata", {})
    return {"state_dict": payload["state_dict"], "metadata": meta,
            "optimizer": payload.get("optimizer"),
            "step": int(payload.get("step", meta.get("step", 0))),
            "epoch": int(payload.get("epoch", meta.get("epoch", -1))),
            "generator": payload.get("generator")}


def load_metadata(path: str) -> Dict[str, Any]:
    return load_checkpoint(path)["metadata"]


def latest_checkpoint(folder: str, pattern: str = "*.ckpt") -> Optional[str]:
    files = glob.glob(os.path.join(folder, pattern))
    return max(files, key=os.path.getmtime) if files else None


def default_checkpoint(cfg, folder: Optional[str] = None) -> Optional[str]:
    """The weights to serve when none are named (JAX serve/predictor.py
    ``_default_checkpoint``): ``cfg.model_weights_path``; else in
    ``folder`` (default ``cfg.experiment_folder``) the title's best file
    (``BEST_val_loss`` for regression, ``BEST_val_AUROC`` then
    ``BEST_val_accuracy`` for classification), else the newest ``*BEST*``
    file, else the newest checkpoint, with a warning that it was not
    chosen on validation. ``Trainer.testing`` restores by the Trainer's
    own rule instead (train/trainer.py ``_restore_weights``)."""
    if cfg.model_weights_path:
        return cfg.model_weights_path
    folder = folder or cfg.experiment_folder
    if not folder:
        return None
    title = cfg.experiment_title or cfg.exp_name
    order = (("BEST_val_loss",) if cfg.fine_tune_task == "regression"
             else ("BEST_val_AUROC", "BEST_val_accuracy"))
    for best in order:
        preferred = os.path.join(folder, f"{title}_{best}.ckpt")
        if os.path.exists(preferred):
            return preferred
    bests = glob.glob(os.path.join(folder, "*BEST*.ckpt"))
    if bests:
        return max(bests, key=os.path.getmtime)
    fallback = latest_checkpoint(folder)
    if fallback is not None:
        print(f"[predict] WARNING: no BEST checkpoint in {folder!r}; "
              f"using {os.path.basename(fallback)} (not validation-selected)")
    return fallback


# ---- phase chaining -----------------------------------------------------------

_BERT_LAYER = re.compile(r"^(.*\.encoder\.layer)\.(\d+)\.(.*)$")
_BLOCK = re.compile(r"^(.*\.blocks)\.(\d+)\.(.*)$")


def _depths(keys: Iterable[str]) -> Dict[str, int]:
    """Blocks of each ``...blocks`` stack among ``keys``."""
    depth: Dict[str, int] = {}
    for k in keys:
        m = _BLOCK.match(k)
        if m:
            depth[m[1]] = max(depth.get(m[1], 0), int(m[2]) + 1)
    return depth


def _jax_leaves(keys: Iterable[str]) -> Dict[Tuple, List[str]]:
    """The port's state-dict keys grouped as JAX holds the same tensors: a
    BERT's layers are one scanned leaf each (``layers/layer``); a SwinV2 or
    fusion stage of even depth is scanned in (shift 0, shift) pairs, one
    leaf per pair member and tensor (``pairs/block_0|block_1``); an odd
    stage keeps a leaf per block. {leaf: its keys in stack order}."""
    keys = list(keys)
    depth = _depths(keys)
    leaves: Dict[Tuple, List[Tuple[int, str]]] = {}
    for k in keys:
        m = _BERT_LAYER.match(k)
        if m:
            leaf, pos = (m[1], "layers", m[3]), int(m[2])
        else:
            m = _BLOCK.match(k)
            j = int(m[2]) if m else 0
            if m and depth[m[1]] % 2 == 0:
                leaf, pos = (m[1], "pairs", j % 2, m[3]), j // 2
            elif m:
                leaf, pos = (m[1], "block", j, m[3]), 0
            else:
                leaf, pos = (k,), 0
        leaves.setdefault(leaf, []).append((pos, k))
    return {leaf: [k for _, k in sorted(v)] for leaf, v in leaves.items()}


def partial_restore(target: Mapping[str, torch.Tensor],
                    source: Mapping[str, torch.Tensor], *,
                    load_cls_embedding: bool = True
                    ) -> Tuple[State, Dict[str, int], List[str]]:
    """Merge ``source`` into ``target`` (JAX ``partial_restore``): a JAX
    leaf (``_jax_leaves``) is copied when the target has it with the same
    shape, stack length included; otherwise it keeps the target's value.
    Keys naming ``cls_embedding`` are skipped unless
    ``load_cls_embedding``. Returns (merged state, counts of leaves
    copied / shape-skipped / missing in the target / cls-skipped, the
    copied keys)."""
    tgt, src = _jax_leaves(target), _jax_leaves(source)
    merged = dict(target)
    stats = {"copied": 0, "shape_skipped": 0, "missing": 0, "cls_skipped": 0}
    copied: List[str] = []
    for leaf, keys in src.items():
        if leaf not in tgt:
            stats["missing"] += 1
            continue
        if not load_cls_embedding and any("cls_embedding" in k
                                          for k in keys):
            stats["cls_skipped"] += 1
            continue
        if len(keys) != len(tgt[leaf]) or any(
                source[a].shape != target[b].shape
                for a, b in zip(keys, tgt[leaf])):
            stats["shape_skipped"] += 1
            continue
        for a, b in zip(keys, tgt[leaf]):
            merged[b] = source[a].to(target[b].dtype)
        copied.extend(tgt[leaf])
        stats["copied"] += 1
    return merged, stats, copied


def key_patterns(keys: Iterable[str]) -> List[str]:
    """``keys`` with every numeric path component as ``*``, deduplicated in
    order: a readable list of what a merge copied."""
    out: Dict[str, None] = {}
    for k in keys:
        out[re.sub(r"\.\d+(?=\.)", ".*", k)] = None
    return list(out)


class BestCheckpointPolicy:
    """Best-validation save policy (JAX ckpt/checkpoint.py
    BestCheckpointPolicy, reference trainer.py:660-690): classification
    keeps ``{title}_BEST_val_AUROC.ckpt`` (and the accuracy file when AUROC
    did not improve), regression ``{title}_BEST_val_loss.ckpt``. Every file
    holds the whole train state (``save_checkpoint``'s keyword arguments);
    the metadata carries the frozen ``val_threshold``."""

    def __init__(self, folder: str, title: str,
                 fine_tune_task: str = "binary_classification"):
        self.folder = folder
        self.title = title
        self.task = fine_tune_task
        self.best_auroc = 0.0
        self.best_acc = 0.0
        self.best_loss = float("inf")
        os.makedirs(folder, exist_ok=True)

    def resume(self) -> None:
        """The best-so-far metrics from the BEST files already in the folder
        (JAX ``resume``), so that a resumed run cannot overwrite a better
        BEST file with a worse one."""
        for fname, attr, better in (
                (f"{self.title}_BEST_val_AUROC.ckpt", "best_auroc", max),
                (f"{self.title}_BEST_val_accuracy.ckpt", "best_acc", max),
                (f"{self.title}_BEST_val_loss.ckpt", "best_loss", min)):
            path = os.path.join(self.folder, fname)
            if not os.path.exists(path):
                continue
            val = load_metadata(path).get(attr)
            if val is not None:
                setattr(self, attr, better(getattr(self, attr), float(val)))

    def _save(self, kind: str, state_dict, metadata, extra) -> str:
        return save_checkpoint(os.path.join(
            self.folder, f"{self.title}_BEST_val_{kind}.ckpt"), state_dict,
            metadata, **extra)

    def update(self, *, state_dict: Mapping[str, torch.Tensor],
               metadata: Dict[str, Any], val_auroc: Optional[float] = None,
               val_acc: Optional[float] = None,
               val_loss: Optional[float] = None, **extra) -> Optional[str]:
        """Save if a tracked metric improved; returns the path written."""
        meta = dict(metadata, best_auroc=self.best_auroc,
                    best_acc=self.best_acc, best_loss=self.best_loss)
        if self.task == "regression":
            if val_loss is not None and val_loss < self.best_loss:
                self.best_loss = meta["best_loss"] = val_loss
                return self._save("loss", state_dict, meta, extra)
            return None
        wrote = None
        if val_auroc is not None and val_auroc > self.best_auroc:
            self.best_auroc = meta["best_auroc"] = val_auroc
            wrote = self._save("AUROC", state_dict, meta, extra)
        if val_acc is not None and val_acc > self.best_acc:
            self.best_acc = meta["best_acc"] = val_acc
            if wrote is None:
                wrote = self._save("accuracy", state_dict, meta, extra)
        return wrote
