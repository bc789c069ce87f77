"""Perceptual (feature-space) loss for the reconstruction tasks
(counterpart of multimodal_neuroimage_tpu/nn/perceptual.py).

The reference's Percept_Loss (reference losses.py:314-376): random 2-D
slices of the fMRI volume pair, a ``memory_constraint`` fraction of them
(0.25 for autoencoder reconstruction, 0.1 otherwise, losses.py:346-349),
through VGG16's first two stages (relu1_2, relu2_2, losses.py:90-120),
compared by MSE.

``Vgg16Features`` is NCHW ``nn.Conv2d`` (cuDNN's convolutions on the card:
no TPU kernel is behind them). ``load_vgg16_npz`` reads the JAX package's
npz (``conv{i}_{j}/kernel`` HWIO, ``/bias``); nothing is downloaded. With
no weights file the features are random (a smoke path) and one warning is
printed, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CONVS = (("conv1_1", 3, 64), ("conv1_2", 64, 64), ("conv2_1", 64, 128),
         ("conv2_2", 128, 128))

_warned = False


class Vgg16Features(nn.Module):
    """conv1_1, conv1_2 (relu1_2), 2x2 max-pool, conv2_1, conv2_2 (relu2_2)
    (reference losses.py:96-104); 3x3 kernels, padding 1."""

    def __init__(self):
        super().__init__()
        for name, cin, cout in CONVS:
            self.add_module(name, nn.Conv2d(cin, cout, 3, padding=1))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: (N, 3, H, W) -> (relu1_2, relu2_2)."""
        h = F.relu(self.conv1_1(x))
        h = F.relu(self.conv1_2(h))
        relu1_2 = h
        h = F.max_pool2d(h, 2, 2)
        h = F.relu(self.conv2_1(h))
        h = F.relu(self.conv2_2(h))
        return relu1_2, h


def load_vgg16_npz(path: str, model: Optional[Vgg16Features] = None
                   ) -> Vgg16Features:
    """``model`` (a new one by default) with the npz's stage weights: HWIO
    kernels to OIHW."""
    model = model or Vgg16Features()
    data = np.load(path)
    state = {}
    for name, _, _ in CONVS:
        state[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(data[f"{name}/kernel"].transpose(3, 2, 0, 1))
        ).float()
        state[f"{name}.bias"] = torch.from_numpy(
            np.asarray(data[f"{name}/bias"])).float()
    model.load_state_dict(state)
    return model


class PerceptualLoss:
    """Callable loss: MSE between VGG features of prediction and target
    slices (reference losses.py:351-376)."""

    def __init__(self, task: str = "transformer_reconstruction",
                 weights_npz: Optional[str] = None, seed: int = 0,
                 device="cuda"):
        global _warned
        self.memory_constraint = (0.25 if task == "autoencoder_reconstruction"
                                  else 0.1)
        self.seed = seed
        if weights_npz:
            self.model = load_vgg16_npz(weights_npz)
        else:
            if not _warned:
                print("[perceptual] no VGG16 weights provided: using random "
                      "features (smoke mode)")
                _warned = True
            self.model = Vgg16Features()
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in self.model.parameters():
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
        self.model.to(device).requires_grad_(False)

    @staticmethod
    def _as_volume(x: torch.Tensor) -> torch.Tensor:
        """The reference's (B, C, W, H, D, T) layout (losses.py:340-344);
        also a model's (B, T, E) series (one (T, E) image an item) and
        (B, H, W, D, T) channelless volumes."""
        if x.ndim == 3:
            B, T, E = x.shape
            return x.reshape(B, 1, T, E, 1, 1)
        if x.ndim == 5:
            return x[:, None]
        return x

    def slice_count(self, shape) -> Tuple[int, int]:
        """(slices of a volume pair of ``shape``, slices kept)."""
        B, C, W, H, D, T = self._as_volume(torch.empty(shape,
                                                       device="meta")).shape
        n = B * T * D
        return n, max(int(n * self.memory_constraint), 1)

    def __call__(self, pred: torch.Tensor, target: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 valid: Optional[torch.Tensor] = None,
                 idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pred / target: (B, C, W, H, D, T) volumes or the shapes
        ``_as_volume`` takes. The kept slices are ``idx`` when given, else
        the head of ``torch.randperm`` from ``generator`` (a host generator;
        seeded by ``seed`` when None). ``valid`` (B,) weights each slice by
        its batch row, so pad rows drop out exactly."""
        if pred.shape != target.shape or pred.ndim not in (3, 5, 6):
            raise ValueError(f"perceptual loss takes two volumes of one "
                             f"shape, 3-, 5- or 6-D; got {tuple(pred.shape)}"
                             f" and {tuple(target.shape)}")
        pred, target = self._as_volume(pred), self._as_volume(target)
        B, C, W, H, D, T = pred.shape
        n_slices, keep = self.slice_count(pred.shape)
        if idx is None:
            gen = generator or torch.Generator().manual_seed(self.seed)
            idx = torch.randperm(n_slices, generator=gen)[:keep]
        idx = idx.to(pred.device)

        def slices(x):
            s = x.permute(0, 5, 1, 4, 2, 3).reshape(n_slices, W, H)
            return s.index_select(0, idx)[:, None].expand(-1, 3, -1, -1)

        pf = self.model(slices(pred.float()))
        tf = self.model(slices(target.float()))
        loss = pred.new_zeros((), dtype=torch.float32)
        if valid is None:
            for a, b in zip(pf, tf):
                loss = loss + ((a - b) ** 2).mean()
            return loss
        # the slices run (B, T, C, D): a slice's row is idx // (T C D)
        w = valid.float().index_select(0, idx // (T * C * D))
        denom = torch.clamp(w.sum(), min=1.0)
        for a, b in zip(pf, tf):
            per_slice = ((a - b) ** 2).mean(dim=tuple(range(1, a.ndim)))
            loss = loss + (per_slice * w).sum() / denom
        return loss
