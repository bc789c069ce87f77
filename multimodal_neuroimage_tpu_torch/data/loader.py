"""Host-side items and batching for in-memory requests (counterpart of the
host branches of multimodal_neuroimage_tpu/data/datasets.py ``ItemLoader``
and of data/loader.py ``collate``).

A request carries one subject's raw series, not a path: no
``SubjectRecord``, no pandas. The preprocessing is the port's own
``data/filters.py`` (the host gear) or, where ``device_fmri`` holds (the
``device`` gear, ``Config``'s default), ``ops/fir.py`` on the device: the
item is then the raw series zero-filled to 368 TRs plus its native length
(``raw_fmri_item``), and ``device_preprocess`` band-splits each batch where
it will be consumed.

- ``hcp_item``: ``{subject, fmri (22, T <= 1200)}``, z-scored over the whole
  array, zero-padded to 1200 TRs (front gets pad // 2), as ``(1200, 22)``
  ``fmri_sequence`` (``ItemLoader.hcp``).
- ``fmri_timeseries_item``: the ABCD phase-1/2 series ``(84, T)`` (first 20
  TRs already dropped, as ``_load_abcd_fmri_raw`` returns it) through
  ``preprocess_fmri_host`` with ``cfg.fmri_type`` (``ItemLoader
  .fmri_timeseries``, host gear).
- ``multimodal_item``: the flagship's ``{subject, fmri (84, T), struct (84,
  84)}`` band split (``ItemLoader.multimodal``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch

from multimodal_neuroimage_tpu_torch.data.filters import (pad_time_axis,
                                                          preprocess_fmri_host,
                                                          zscore)

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
            and cfg.dataset_name in ("fMRI_timeseries", "multimodal")
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


def multimodal_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T), struct (R, R)} -> the model's per-item dict
    (the raw fMRI payload in the device gear)."""
    struct = zscore(np.asarray(request["struct"], dtype=np.float64),
                    axis=None).astype(np.float16)
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


def item_for(cfg) -> Callable[[Mapping, object], Dict[str, np.ndarray]]:
    """The item function of ``cfg.dataset_name`` (``ItemLoader``'s
    dispatch); raises for the datasets the port does not load yet."""
    items = {"hcp": hcp_item, "fMRI_timeseries": fmri_timeseries_item,
             "multimodal": multimodal_item}
    if cfg.dataset_name not in items:
        raise NotImplementedError(
            f"dataset {cfg.dataset_name!r} is not loaded by the port yet "
            f"(ROADMAP M8/M9: its models are not ported either)")
    return items[cfg.dataset_name]


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
    multimodal = cfg.dataset_name == "multimodal"
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
