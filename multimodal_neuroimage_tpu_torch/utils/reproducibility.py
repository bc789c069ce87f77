"""Reproducibility helpers (counterpart of multimodal_neuroimage_tpu/utils/reproducibility.py).

Every random draw of the port comes from an explicit source: host numpy
streams keyed by ``(seed, *stream)`` (``host_rng``, the JAX package's own,
which keeps the batch order of every rank in lockstep), and
``torch.Generator`` objects seeded from one root seed (``root_generator``,
the counterpart of JAX's ``root_key``), from which the train steps draw
their dropout seeds and DropPath factors.

The JAX package's jitted step repeats bit for bit. On a CUDA device the
port's does so only under cuDNN's deterministic algorithms: at cuDNN's
default choice the weight gradients of the SwinFusion backbone's
convolutions vary run to run. ``deterministic_algorithms`` selects them
for a CUDA device, and the Trainer applies it.
"""

from __future__ import annotations

import numpy as np
import torch

REFERENCE_SEED = 55555555  # reference main.py:53


def host_rng(seed: int, *stream: int) -> np.random.Generator:
    """Counter-based host rng: the same ``(seed, *stream)`` gives the same
    stream in every process (JAX ``host_rng``, bit for bit)."""
    return np.random.default_rng((seed, *stream))


def root_generator(seed: int = REFERENCE_SEED,
                   device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (JAX
    ``root_key``). The device is explicit: a CPU generator's stream is the
    same on every machine, which is why the train steps draw from one."""
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def deterministic_algorithms(device) -> bool:
    """On a CUDA ``device`` select cuDNN's deterministic algorithms
    (``cudnn.deterministic = True``, ``cudnn.benchmark = False``), so that
    a step repeats bit for bit; on any other device change nothing.
    Returns whether the setting was applied."""
    if torch.device(device).type != "cuda":
        return False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return True
