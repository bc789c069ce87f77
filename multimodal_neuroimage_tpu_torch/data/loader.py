"""Host-side batching for in-memory requests (counterpart of multimodal_neuroimage_tpu/data/loader.py ``collate``).

``multimodal_item`` is the host branch of the JAX package's
``ItemLoader.multimodal`` (data/datasets.py) without ``SubjectRecord`` and
pandas: a request carries the subject's raw ``(84, T)`` ROI series (the
first 20 TRs already dropped, as ``_load_abcd_fmri_raw`` returns it) and its
raw ``(84, 84)`` struct matrix. The band split is the shared JAX-free
``data/filters.preprocess_fmri_host``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

from multimodal_neuroimage_tpu.data.filters import (preprocess_fmri_host,
                                                    zscore)

ABCD_SEQ_LEN = 368     # ABCD pad target


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
