"""Host-side items and batching for in-memory requests (counterpart of the
host branches of multimodal_neuroimage_tpu/data/datasets.py ``ItemLoader``
and of data/loader.py ``collate``).

A request carries one subject's raw series, not a path: no
``SubjectRecord``, no pandas. The preprocessing is the port's own
``data/filters.py``.

- ``hcp_item``: ``{subject, fmri (22, T <= 1200)}``, z-scored over the whole
  array, zero-padded to 1200 TRs (front gets pad // 2), as ``(1200, 22)``
  ``fmri_sequence`` (``ItemLoader.hcp``).
- ``fmri_timeseries_item``: the ABCD phase-1/2 series ``(84, T)`` (first 20
  TRs already dropped, as ``_load_abcd_fmri_raw`` returns it) through
  ``preprocess_fmri_host`` with ``cfg.fmri_type`` (``ItemLoader
  .fmri_timeseries``, host gear).
- ``multimodal_item``: the flagship's ``{subject, fmri (84, T), struct (84,
  84)}`` band split (``ItemLoader.multimodal``, host gear).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Tuple

import numpy as np

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


def fmri_timeseries_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T)} -> the fMRI-only item for ``cfg.fmri_type``
    (keys ``fmri_sequence`` and, by type, the band sequences)."""
    item = preprocess_fmri_host(
        np.asarray(request["fmri"], dtype=np.float64), cfg.fmri_type,
        ABCD_SEQ_LEN, cfg.filtering_type, cfg.fir_lb_hz, cfg.tr_seconds,
        cfg.fir_order, cfg.feature_map_gen, cfg.feature_map_size)
    return {"subject_name": str(request["subject"]), **item}


def multimodal_item(request: Mapping, cfg) -> Dict[str, np.ndarray]:
    """{subject, fmri (R, T), struct (R, R)} -> the model's per-item dict."""
    y = np.asarray(request["fmri"], dtype=np.float64)
    bands = preprocess_fmri_host(
        y, "divided_frequency", ABCD_SEQ_LEN, cfg.filtering_type,
        cfg.fir_lb_hz, cfg.tr_seconds, cfg.fir_order, cfg.feature_map_gen,
        cfg.feature_map_size)
    struct = zscore(np.asarray(request["struct"], dtype=np.float64),
                    axis=None).astype(np.float16)
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
