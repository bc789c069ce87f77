"""Train-time augmentation (the port's own copy of
multimodal_neuroimage_tpu/data/augmentations.py): with probability
``augment_prob``, add zero-mean gaussian noise scaled to a fraction of the
signal's std, from a generator seeded once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class BrainGaussian:
    """Per-item gaussian noise augmentation for ROI timeseries / matrices."""

    def __init__(self, augment_prob: float = 0.0, noise_std_frac: float = 0.1,
                 seed: Optional[int] = None, **_):
        self.prob = float(augment_prob)
        self.noise_std_frac = float(noise_std_frac)
        self.rng = np.random.default_rng(seed)

    def __call__(self, y: np.ndarray) -> np.ndarray:
        if self.prob <= 0.0 or self.rng.uniform() >= self.prob:
            return y
        scale = self.noise_std_frac * float(np.std(y))
        return y + self.rng.normal(0.0, scale, size=y.shape).astype(y.dtype)
