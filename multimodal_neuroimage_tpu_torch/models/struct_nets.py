"""Structural-matrix models of phase 3 (counterpart of multimodal_neuroimage_tpu/models/struct_nets.py).

Batch-dict wrappers around the SwinV2 encoder (nn/swin2d.py, K4 in every
block), with the input routed by dataset (``struct_input``):

* ``SwinClassifier``: the 84x84 matrix -> SwinV2 -> one logit;
* ``SwinClassifierVAE``: an MLP VAE (84^2 -> 64^2 -> 32^2 -> 16^2 and back,
  sigmoid output) whose reconstruction feeds the SwinV2;
* ``SwinClassifierUNet``: the UNet denoiser (nn/unet.py) before the SwinV2.

Module names are the JAX package's (``swin``, ``vae``, ``unet``); inside
them the reference torch names (``fc1`` ... ``fc6``, ``fc31``/``fc32``,
``inc.double_conv.0``, ``layers.{i}.blocks.{j}``). The whole forward runs
in float32 without TF32 (``full_f32``); under the bf16 policy the input
arrives as bf16 and is widened, as the JAX models' ``astype(float32)``
does. In training the VAE's reparameterisation draws its noise from the
step's host ``torch.Generator``, so the card and the CPU draw the same.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.common import full_f32
from multimodal_neuroimage_tpu_torch.nn.swin2d import (SwinTransformerV2,
                                                       size_preset)
from multimodal_neuroimage_tpu_torch.nn.unet import UNet2D

STRUCT_KEYS = {"DTI": "dti", "sMRI": "smri", "DTI+sMRI": "struct",
               "struct": "struct"}


def struct_input(batch: Mapping[str, torch.Tensor],
                 dataset_name: str) -> torch.Tensor:
    """The model input of ``dataset_name``'s batch (``dti``, ``smri`` or
    ``struct``), else the first of struct, smri, dti present."""
    key = STRUCT_KEYS.get(dataset_name, "struct")
    if key in batch:
        return batch[key]
    for k in ("struct", "smri", "dti"):
        if k in batch:
            return batch[k]
    raise KeyError(f"no structural input in batch for {dataset_name}")


class MlpVae(nn.Module):
    """MLP VAE over the flattened matrix: fc1, fc2 encode, fc31 / fc32 give
    mu / logvar, fc4 ... fc6 decode to a sigmoid reconstruction. Eval:
    z = mu; training: z = mu + exp(logvar / 2) * eps, eps ~ N(0, 1) from
    ``generator`` on the host."""

    def __init__(self, side: int = 84, latent: int = 16 * 16):
        super().__init__()
        self.fc1 = nn.Linear(side * side, 64 * 64)
        self.fc2 = nn.Linear(64 * 64, 32 * 32)
        self.fc31 = nn.Linear(32 * 32, latent)
        self.fc32 = nn.Linear(32 * 32, latent)
        self.fc4 = nn.Linear(latent, 32 * 32)
        self.fc5 = nn.Linear(32 * 32, 64 * 64)
        self.fc6 = nn.Linear(64 * 64, side * side)

    def forward(self, x: torch.Tensor, generator=None):
        relu = torch.relu
        h = relu(self.fc2(relu(self.fc1(x.reshape(x.shape[0], -1)))))
        mu, logvar = self.fc31(h), self.fc32(h)
        z = mu
        if self.training:
            eps = torch.randn(mu.shape, generator=generator).to(mu.device)
            z = mu + torch.exp(0.5 * logvar) * eps
        recon = torch.sigmoid(self.fc6(relu(self.fc5(relu(self.fc4(z))))))
        return recon.reshape(x.shape), mu, logvar


class SwinClassifier(nn.Module):
    """84x84 matrix -> SwinV2 -> logit."""

    def __init__(self, size_of_model: str = "large", patch_size: int = 7,
                 swin_embed_dim: int = 12, window_size: int = 6,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 fine_tune_task: str = "binary_classification",
                 dataset_name: str = "sMRI"):
        super().__init__()
        self.fine_tune_task = fine_tune_task
        self.dataset_name = dataset_name
        self._front()
        depths, heads = size_preset(size_of_model)
        self.swin = SwinTransformerV2(
            (84, 84), patch_size, swin_embed_dim, depths, heads, window_size,
            mlp_ratio, drop_rate, attn_drop_rate, drop_path_rate)

    def _front(self) -> None:
        """The variants' front module, registered before ``swin``."""

    @classmethod
    def from_config(cls, cfg) -> "SwinClassifier":
        return cls(size_of_model=cfg.size_of_model, patch_size=cfg.patch_size,
                   swin_embed_dim=cfg.swin_embed_dim,
                   window_size=cfg.window_size, mlp_ratio=cfg.mlp_ratio,
                   drop_rate=cfg.drop_rate, attn_drop_rate=cfg.attn_drop_rate,
                   drop_path_rate=cfg.drop_path_rate,
                   fine_tune_task=cfg.fine_tune_task,
                   dataset_name=cfg.dataset_name)

    def _encode(self, x: torch.Tensor, generator
                ) -> Dict[str, torch.Tensor]:
        return {self.fine_tune_task: self.swin(x, generator)}

    def forward(self, batch: Mapping[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict:
        if self.training and generator is None:
            raise ValueError("a training forward draws its dropout from an "
                             "explicit torch.Generator; pass generator=")
        with full_f32():
            return self._encode(
                struct_input(batch, self.dataset_name).float(), generator)


class SwinClassifierVAE(SwinClassifier):
    """VAE reconstruction -> SwinV2; also returns ``vae_recon``,
    ``vae_mu`` and ``vae_logvar``."""

    def _front(self) -> None:
        self.vae = MlpVae()

    def _encode(self, x, generator):
        recon, mu, logvar = self.vae(x, generator)
        return {self.fine_tune_task: self.swin(recon, generator),
                "vae_recon": recon, "vae_mu": mu, "vae_logvar": logvar}


class SwinClassifierUNet(SwinClassifier):
    """UNet denoiser -> SwinV2; also returns ``struct_input`` and
    ``struct_output`` (the denoised matrix)."""

    def _front(self) -> None:
        self.unet = UNet2D()

    def _encode(self, x, generator):
        denoised = self.unet(x[:, None])[:, 0]
        return {self.fine_tune_task: self.swin(denoised, generator),
                "struct_input": x, "struct_output": denoised}
