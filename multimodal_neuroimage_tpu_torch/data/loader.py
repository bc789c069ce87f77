"""Items and batches (counterpart of multimodal_neuroimage_tpu/data/
datasets.py's item branches and data/loader.py ``collate``,
``device_preprocess`` and ``DataPipeline``).

An item function takes one subject's arrays as an in-memory request (no
paths): data/datasets.py ``ItemLoader`` hands it either the caller's
request or the arrays it loaded from an on-disk cohort. The preprocessing
is the port's own ``data/filters.py`` (the host gear) or, where
``device_fmri`` holds (the ``device`` gear, ``Config``'s default),
``ops/fir.py`` on the device: the item is then the raw series zero-filled to
368 TRs plus its native length (``raw_fmri_item``), and
``device_preprocess`` band-splits each batch where it will be consumed.

- ``hcp_item``: ``{subject, fmri (22, T <= 1200)}``, z-scored over the whole
  array, zero-padded to 1200 TRs (front gets pad // 2), as ``(1200, 22)``
  ``fmri_sequence`` (``ItemLoader.hcp``).
- ``fmri_timeseries_item``: the ABCD phase-1/2 series ``(84, T)`` (first 20
  TRs already dropped, as ``_load_abcd_fmri_raw`` returns it) through
  ``preprocess_fmri_host`` with ``cfg.fmri_type`` (``ItemLoader
  .fmri_timeseries``, host gear).
- ``multimodal_item``: the flagship's ``{subject, fmri (84, T), struct (84,
  84)}`` band split (``ItemLoader.multimodal``); ``multimodal_prs_item``
  also carries the request's three polygenic scores ``prs`` as float32
  (``ItemLoader.multimodal_prs``).
- ``fmri_image_item``: ``{subject, fmri_image}``, a 4-D volume as
  ``read_nifti`` gives it, stored as float32 ``fmri_sequence``
  (``ItemLoader.fmri_image``).
- ``dti_item``, ``smri_item``, ``dti_smri_item``, ``struct_pair_item``: the
  structural requests ``{subject, dti}``, ``{subject, smri}``, ``{subject,
  struct}`` (DTI+sMRI) and ``{subject, smri, dti}`` (phase 6's pair), each
  84x84 matrix z-scored over the whole matrix in float64 and stored as
  float16 (``ItemLoader.dti`` / ``smri`` / ``dti_smri`` / ``struct_pair``).
  They always stay on the host gear, as JAX's ``device_fmri`` leaves them.

``DataPipeline`` batches this rank's rows of the splits: an on-disk cohort split
by ``SplitManager``, or the caller's per-split lists of in-memory requests.
The native gear (``preprocess="native"``, data/native.py) loads whole
on-disk batches in C++: the structural matrices z-scored, the fMRI series
band-split, the fMRI_image volumes read.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.data.filters import (design_highpass_fir,
                                                          pad_time_axis,
                                                          preprocess_fmri_host,
                                                          zscore)
from multimodal_neuroimage_tpu_torch.data.index import (SubjectRecord,
                                                        MULTIMODAL,
                                                        build_subject_index,
                                                        check_dataset)
from multimodal_neuroimage_tpu_torch.data.splits import SplitManager
from multimodal_neuroimage_tpu_torch.parallel.mesh import rank, world
from multimodal_neuroimage_tpu_torch.utils.reproducibility import host_rng

ABCD_SEQ_LEN = 368     # ABCD pad target
HCP_SEQ_LEN = 1200     # HCP pad target


def hcp_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T)} -> {subject_name, fmri_sequence (1200, R)}."""
    y = zscore(np.asarray(request["fmri"], dtype=np.float64), axis=None)
    return {"subject_name": str(request["subject"]),
            "fmri_sequence": pad_time_axis(y, HCP_SEQ_LEN).T.astype(
                np.float32)}


def device_fmri(cfg) -> bool:
    """Whether ``cfg``'s fMRI items take the device gear (``ItemLoader``'s
    ``device_fmri``): the FIR split only, without the sinc-resampled
    ultralow band, for the datasets and fMRI types the device split
    serves; every other item stays on the host gear."""
    return (cfg.preprocess == "device" and cfg.filtering_type == "FIR"
            and cfg.feature_map_gen != "resample"
            and cfg.dataset_name in ("fMRI_timeseries",) + MULTIMODAL
            and cfg.fmri_type in ("timeseries", "divided_frequency",
                                  "time_domain_low", "time_domain_ultralow"))


def raw_fmri_item(request: Mapping) -> Dict[str, np.ndarray]:
    """The device gear's fMRI payload: the raw (R, T <= 368) series
    zero-filled to (R, 368) float32, and its native length
    (``ItemLoader._raw_fmri_item``)."""
    y = np.asarray(request["fmri"], dtype=np.float64)
    R, T = y.shape
    buf = np.zeros((R, ABCD_SEQ_LEN), dtype=np.float32)
    buf[:, :T] = y
    return {"fmri_raw": buf, "fmri_length": np.int32(T)}


def fmri_timeseries_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T)} -> the fMRI-only item for ``cfg.fmri_type``
    (keys ``fmri_sequence`` and, by type, the band sequences; the raw
    payload in the device gear)."""
    if device_fmri(cfg):
        return {"subject_name": str(request["subject"]),
                **raw_fmri_item(request)}
    item = preprocess_fmri_host(
        np.asarray(request["fmri"], dtype=np.float64), cfg.fmri_type,
        ABCD_SEQ_LEN, cfg.filtering_type, cfg.fir_lb_hz, cfg.tr_seconds,
        cfg.fir_order, cfg.feature_map_gen, cfg.feature_map_size)
    return {"subject_name": str(request["subject"]), **item}


def fmri_image_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri_image (X, Y, Z, T)} -> its float32 ``fmri_sequence``
    (JAX ``ItemLoader.fmri_image``)."""
    return {"subject_name": str(request["subject"]),
            "fmri_sequence": np.asarray(request["fmri_image"]).astype(
                np.float32)}


def struct_matrix(matrix) -> np.ndarray:
    """A structural matrix z-scored over all its entries in float64, stored
    as float16 (JAX ``_struct_matrix``)."""
    return zscore(np.asarray(matrix, dtype=np.float64),
                  axis=None).astype(np.float16)


def _matrices_item(*keys):
    """The item function of requests {subject, *keys}: each matrix through
    ``struct_matrix``."""
    def item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
        out = {"subject_name": str(request["subject"])}
        for key in keys:
            out[key] = struct_matrix(request[key])
        return out
    return item


dti_item = _matrices_item("dti")
smri_item = _matrices_item("smri")
dti_smri_item = _matrices_item("struct")
struct_pair_item = _matrices_item("smri", "dti")


def multimodal_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T), struct (R, R)} -> the model's per-item dict
    (the raw fMRI payload in the device gear)."""
    struct = struct_matrix(request["struct"])
    if device_fmri(cfg):
        return {"subject_name": str(request["subject"]), "struct": struct,
                **raw_fmri_item(request)}
    y = np.asarray(request["fmri"], dtype=np.float64)
    bands = preprocess_fmri_host(
        y, "divided_frequency", ABCD_SEQ_LEN, cfg.filtering_type,
        cfg.fir_lb_hz, cfg.tr_seconds, cfg.fir_order, cfg.feature_map_gen,
        cfg.feature_map_size)
    return {"subject_name": str(request["subject"]),
            "struct": struct,
            "fmri_raw_sequence": bands["fmri_sequence"],
            "fmri_lowfreq_sequence": bands["fmri_lowfreq_sequence"],
            "fmri_ultralowfreq_sequence": bands["fmri_ultralowfreq_sequence"]}


def multimodal_prs_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri, struct, prs (3,)} -> ``multimodal_item`` plus
    ``prs`` float32."""
    return {**multimodal_item(request, cfg),
            "prs": np.asarray(request["prs"], dtype=np.float32)}


def item_for(cfg) -> Callable[[Mapping, object], Dict[str, np.ndarray]]:
    """The item function of ``cfg.dataset_name`` (``ItemLoader``'s
    dispatch); raises for a dataset the port does not know."""
    check_dataset(cfg.dataset_name)
    return {"hcp": hcp_item, "fMRI_timeseries": fmri_timeseries_item,
            "fMRI_image": fmri_image_item, "multimodal": multimodal_item,
            "multimodal_prs": multimodal_prs_item, "DTI": dti_item,
            "sMRI": smri_item, "DTI+sMRI": dti_smri_item,
            "struct": struct_pair_item}[cfg.dataset_name]


def collate(items: List[Dict], target_key: str = "target"
            ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Stack item dicts; the phenotype target is renamed to 'target' and
    subject_name strings stay host-side."""
    names = [it["subject_name"] for it in items]
    batch: Dict[str, np.ndarray] = {}
    for key in items[0]:
        if key == "subject_name":
            continue
        out_key = "target" if key == target_key else key
        batch[out_key] = np.stack([np.asarray(it[key]) for it in items])
    return batch, names


def device_preprocess(batch: Dict, cfg, device) -> Dict:
    """The device gear on one collated batch (JAX data/loader.py
    ``device_preprocess``): the raw series and lengths go to ``device``,
    ``ops/fir.py`` splits them there, and the bands replace them under the
    keys the model reads, as tensors on ``device``; other keys pass as they
    are. A batch without raw series (host gear) is returned unchanged.

    fMRI-only batches take their keys from ``cfg.fmri_type``. A flagship
    (multimodal) batch always takes the three divided-frequency bands,
    per-ROI z-scored, as its host item does whatever ``fmri_type`` says:
    the JAX function keys it by ``fmri_type`` too, and at the default
    ``"timeseries"`` hands the flagship only ``fmri_sequence`` (ROADMAP
    F4)."""
    if "fmri_raw" not in batch:
        return batch
    from multimodal_neuroimage_tpu_torch.ops.fir import fir_bandsplit_batch
    multimodal = cfg.dataset_name in MULTIMODAL
    kind = "divided_frequency" if multimodal else cfg.fmri_type
    bands = fir_bandsplit_batch(
        torch.as_tensor(batch["fmri_raw"], dtype=torch.float32,
                        device=device),
        torch.as_tensor(batch["fmri_length"], device=device),
        t_max=ABCD_SEQ_LEN, lb_hz=cfg.fir_lb_hz, tr_seconds=cfg.tr_seconds,
        fir_order=cfg.fir_order, global_zscore_raw=kind == "timeseries")
    out = {k: v for k, v in batch.items()
           if k not in ("fmri_raw", "fmri_length")}
    if kind == "timeseries":
        out["fmri_sequence"] = bands["raw"]
    elif kind == "time_domain_low":
        out["fmri_sequence"] = bands["low"]
    elif kind == "time_domain_ultralow":
        out["fmri_sequence"] = bands["ultralow"]
    else:
        out["fmri_raw_sequence" if multimodal else "fmri_sequence"] = \
            bands["raw"]
        out["fmri_lowfreq_sequence"] = bands["low"]
        out["fmri_ultralowfreq_sequence"] = bands["ultralow"]
    return out


MODEL_INPUTS = ("fmri_sequence", "fmri_raw_sequence", "fmri_lowfreq_sequence",
                "fmri_ultralowfreq_sequence", "struct", "smri", "dti", "prs")
# each structural dataset's matrices, by batch key (the native gear's too)
STRUCT_INPUTS = {"DTI": ("dti",), "sMRI": ("smri",), "DTI+sMRI": ("struct",),
                 "struct": ("smri", "dti"), "multimodal": ("struct",),
                 "multimodal_prs": ("struct",)}


class DataPipeline:
    """Split-aware batches of this rank (JAX data/loader.py
    ``DataPipeline`` without a mesh; parallel/mesh.py).

    ``splits`` gives the per-split lists (in-memory requests, or records);
    without it the cohort on disk is indexed (``build_subject_index``) and
    split by ``SplitManager``. Batches
    follow JAX's: the order from ``host_rng(cfg.seed, epoch)`` when
    shuffled; across W ranks (``torch.distributed``) a step's global batch
    is ``order[step * bs * W:][:bs * W]`` and rank r takes its rows ``r *
    bs`` to ``(r + 1) * bs``; the train split drops its last partial global
    batch, and every other split carries ``valid`` and pads each rank's
    share of its tail to ``batch_size`` with repeated subjects, ``valid`` 0
    and name None on the pad rows. Items load
    on a pool of ``cfg.workers`` threads; at ``preprocess="native"`` whole
    batches of an on-disk cohort load in C++ (data/native.py) where the
    JAX gear covers them (FIR split, no augmentation), which raises rather
    than falls back when the library cannot be built."""

    def __init__(self, cfg, splits: Optional[Dict[str, List]] = None,
                 device="cuda"):
        from multimodal_neuroimage_tpu_torch.data.datasets import ItemLoader
        self.cfg = cfg
        self.device = device
        # train items augment; eval items never do
        self.item_loader = ItemLoader(cfg, augment=True)
        self.eval_item_loader = ItemLoader(cfg, augment=False)
        if splits is None:
            self.records = build_subject_index(cfg)
            by_name = {r.subject: r for r in self.records}
            names = SplitManager(cfg.base_path, cfg.dataset_name, cfg.seed,
                                 cfg.train_split, cfg.val_split).split(
                list(by_name))
            splits = {k: [by_name[s] for s in v if s in by_name]
                      for k, v in zip(("train", "val", "test"), names)}
        self.splits = {k: list(v) for k, v in splits.items()}
        if (cfg.preprocess == "native" and cfg.dataset_name != "hcp"
                and any(not isinstance(r, SubjectRecord)
                        for recs in self.splits.values() for r in recs)):
            raise ValueError(
                "preprocess='native' loads batches of a cohort on disk; "
                "in-memory records take the 'host' or 'device' gear")
        self.pool = ThreadPoolExecutor(max_workers=max(cfg.workers, 1))

    def steps_per_epoch(self, split: str = "train") -> int:
        """Full global batches of ``split``: ``batch_size`` rows a rank."""
        return len(self.splits[split]) // (self.cfg.batch_size * world())

    def _native_supported(self, split: str) -> bool:
        cfg = self.cfg
        if cfg.preprocess != "native" or (split == "train"
                                          and cfg.augment_prob > 0):
            return False      # augmentation runs in the item path
        if cfg.dataset_name in ("DTI", "sMRI", "DTI+sMRI", "struct",
                                "fMRI_image"):
            return True
        if cfg.filtering_type != "FIR" or cfg.feature_map_gen == "resample":
            return False      # fastpipe implements only the FIR-taps split
        return cfg.dataset_name in MULTIMODAL or (
            cfg.dataset_name == "fMRI_timeseries"
            and cfg.fmri_type == "divided_frequency")

    def _native_batch(self, recs: List[SubjectRecord]
                      ) -> Tuple[Dict[str, np.ndarray], List[str]]:
        """One batch through native/fastpipe.cpp: the structural matrices
        z-scored as float32, the three bands (n, t_max, R) float32, or the
        fMRI_image volumes as float32 ``fmri_sequence``."""
        from multimodal_neuroimage_tpu_torch.data import native
        cfg = self.cfg
        R = cfg.intermediate_vec
        batch: Dict[str, np.ndarray] = {
            "subject": np.asarray([r.idx for r in recs], np.int64),
            "target": np.asarray([r.target for r in recs], np.float32)}
        if cfg.dataset_name == "fMRI_image":
            from multimodal_neuroimage_tpu_torch.data.nifti import (
                read_nifti_header)
            paths = [r.paths["fmri_image"] for r in recs]
            batch["fmri_sequence"] = native.nifti_batch(
                paths, read_nifti_header(paths[0]), cfg.workers)
            return batch, [r.subject for r in recs]
        for key in STRUCT_INPUTS.get(cfg.dataset_name, ()):
            batch[key] = native.matrix_batch([r.paths[key] for r in recs],
                                             R, R, cfg.workers)
        if cfg.dataset_name == "multimodal_prs":
            batch["prs"] = np.stack([r.prs for r in recs]).astype(np.float32)
        if cfg.dataset_name not in MULTIMODAL + ("fMRI_timeseries",):
            return batch, [r.subject for r in recs]
        multimodal = cfg.dataset_name in MULTIMODAL
        taps = design_highpass_fir(cfg.fir_order, cfg.fir_lb_hz,
                                   1.0 / cfg.tr_seconds)
        bands = native.bandsplit_batch(
            [r.paths["fmri"] for r in recs], taps,
            t_max=cfg.sequence_length, n_rois=R, nthreads=cfg.workers)
        batch["fmri_raw_sequence" if multimodal else "fmri_sequence"] = \
            bands["raw"]
        batch["fmri_lowfreq_sequence"] = bands["low"]
        batch["fmri_ultralowfreq_sequence"] = bands["ultralow"]
        return batch, [r.subject for r in recs]

    def _batches(self, split: str, epoch: int, shuffle: bool
                 ) -> Iterator[Tuple[Dict[str, np.ndarray], List]]:
        recs = self.splits[split]
        order = (host_rng(self.cfg.seed, epoch).permutation(
            len(recs)) if shuffle else np.arange(len(recs)))
        loader = self.item_loader if split == "train" else \
            self.eval_item_loader
        native = self._native_supported(split)
        bs = self.cfg.batch_size
        global_bs, first = bs * world(), rank() * bs

        def load(idxs):
            if native:
                return self._native_batch([recs[i] for i in idxs])
            return collate(list(self.pool.map(lambda i: loader(recs[i]),
                                              idxs)), self.cfg.target)

        n_steps = len(recs) // global_bs
        for step in range(n_steps):
            start = step * global_bs + first
            batch, names = load(order[start:start + bs])
            if split != "train":
                batch["valid"] = np.ones(len(names), np.float32)
            yield batch, names
        tail = len(recs) - n_steps * global_bs
        if split != "train" and tail > 0:
            start = n_steps * global_bs + first
            ks = range(start, start + bs)
            batch, names = load(np.asarray([order[k % len(recs)]
                                            for k in ks]))
            pad = [k >= len(recs) for k in ks]
            batch["valid"] = np.asarray([0.0 if p else 1.0 for p in pad],
                                        np.float32)
            yield batch, [None if p else n for n, p in zip(names, pad)]

    def _to_device(self, batch: Dict) -> Dict:
        """The batch's model inputs as float32 tensors on ``device``, the
        device gear's bands made there; targets, ``valid`` and indices
        stay on the host."""
        out = device_preprocess(batch, self.cfg, self.device)
        for k in MODEL_INPUTS:
            if k in out:
                out[k] = torch.as_tensor(out[k], dtype=torch.float32,
                                         device=self.device)
        return out

    def epoch(self, split: str, epoch: int = 0,
              shuffle: Optional[bool] = None, to_device: bool = True
              ) -> Iterator[Tuple[Dict, List]]:
        """Yield (batch, subject names) of one split (shuffled by default
        for train). With ``to_device`` each batch is sent to ``device``
        (``_to_device``) one batch ahead of the one yielded."""
        if shuffle is None:
            shuffle = split == "train"
        it = self._batches(split, epoch, shuffle)
        if not to_device:
            yield from it
            return
        pending = None
        for batch, names in it:
            nxt = (self._to_device(batch), names)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending
