"""Per-subject items of a cohort (counterpart of the ported branches of
multimodal_neuroimage_tpu/data/datasets.py ``ItemLoader``).

``ItemLoader(cfg)(record)`` takes an on-disk ``SubjectRecord`` or an
in-memory request (``{subject, fmri, struct?, prs?, target?}``; the structural
datasets' ``{subject, dti | smri | struct | smri and dti, target?}``). A
record's arrays are loaded as the JAX loader loads them (``load``: the ABCD
series without its first 20 TRs, transposed to (ROI, T); HCP's (22, T)
series; each structural matrix as stored; an ``fMRI_image`` volume through
data/nifti.py ``read_nifti``), then both kinds go through the
same item
function of data/loader.py (``item_for``), so the preprocessing of the
host and device gears is one code for both. A record's item also carries
``subject`` (its index) and its target under ``cfg.target``, as JAX's
``_base`` gives them.

With ``augment`` and ``cfg.augment_prob > 0`` (the train split) the raw
ABCD series, or the fMRI_image volume, takes ``BrainGaussian`` noise before
the preprocessing, at the point of the JAX chain; HCP and structural items
take none.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np

from multimodal_neuroimage_tpu_torch.data.augmentations import BrainGaussian
from multimodal_neuroimage_tpu_torch.data.index import (SubjectRecord,
                                                        check_dataset)
from multimodal_neuroimage_tpu_torch.data.loader import item_for
from multimodal_neuroimage_tpu_torch.data.nifti import read_nifti

ABCD_SKIP_TR = 20      # first 20 TRs dropped
# the request key that takes the augmentation, by dataset: the raw ABCD
# series, or the fMRI_image volume
AUGMENTED = {"fMRI_timeseries": "fmri", "multimodal": "fmri",
             "multimodal_prs": "fmri", "fMRI_image": "fmri_image"}


def load_abcd_fmri(path: str) -> np.ndarray:
    """(T, R) npy -> (R, T) float64 with the first 20 TRs dropped."""
    return np.load(path)[ABCD_SKIP_TR:].T.astype(np.float64)


class ItemLoader:
    def __init__(self, cfg, augment: bool = False):
        check_dataset(cfg.dataset_name)
        self.cfg = cfg
        self.item_fn = item_for(cfg)
        self.augment = (BrainGaussian(augment_prob=cfg.augment_prob,
                                      seed=cfg.seed)
                        if augment and cfg.augment_prob > 0
                        and cfg.dataset_name in AUGMENTED else None)

    def load(self, record: SubjectRecord) -> Dict[str, np.ndarray]:
        """One on-disk subject's arrays as an in-memory request."""
        request = {"subject": record.subject}
        if record.prs is not None:
            request["prs"] = record.prs
        for key, path in record.paths.items():
            if key == "fmri_image":
                request[key] = read_nifti(path)
            elif key != "fmri":
                request[key] = np.load(path)
            elif self.cfg.dataset_name == "hcp":
                request[key] = np.load(path).astype(np.float64)
            else:
                request[key] = load_abcd_fmri(path)
        return request

    def __call__(self, record: Union[SubjectRecord, Mapping]
                 ) -> Dict[str, np.ndarray]:
        if isinstance(record, SubjectRecord):
            out = {"subject": np.int64(record.idx),
                   self.cfg.target: np.float32(record.target)}
            request = self.load(record)
        else:
            out = ({self.cfg.target: np.float32(record["target"])}
                   if "target" in record else {})
            request = record
        if self.augment is not None:
            key = AUGMENTED[self.cfg.dataset_name]
            request = {**request, key: self.augment(
                np.asarray(request[key], dtype=np.float64))}
        out.update(self.item_fn(request, self.cfg))
        return out
