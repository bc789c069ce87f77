"""Model dispatch (counterpart of multimodal_neuroimage_tpu/models/registry.py).

The JAX ``create_model`` decision tree over the port's models: the phase-1
``TransformerNet`` (``2DBERT``, and ``test`` on fMRI-only datasets outside
the divided-frequency mode), phase 2's fMRI nets (``lowfreqBERT``, and
``test`` on ``fMRI_timeseries`` / ``hcp`` at ``divided_frequency``: the
MulT ``TransformerNetCrossAttention`` at ``fmri_multimodality_type=
'cross_attention'``, ``TransformerNetTwoChannels`` at any other value),
the phase-3 struct nets (``VIT``, and ``test``
on ``DTI`` / ``sMRI`` / ``DTI+sMRI``: ``use_vae``, then ``use_unet``, then
the plain ``SwinClassifier``), phase 5's six combiners (``FuncStruct``,
and ``test`` on the multimodal datasets: ``add`` -> ``FuncStructAdd`` or,
with ``use_unet``, ``FuncStructUNetAdd``; ``transfer`` ->
``FuncStructTransfer``; ``cross_attention`` -> ``FuncStructCross`` or, with
``use_unet``, ``FuncStructUNetCross`` / ``FuncStructUNetCrossPRS`` by
``use_prs``; step 4 on divided-frequency fMRI from a ``DTI+sMRI``
checkpoint -> ``FuncStructTransfer``) and the phase-6 ``SwinFusionNet``
(``SwinFusion``, and ``test`` on ``struct``). Any other task or dataset
raises ``NotImplementedError``, as JAX's does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.models.fmri_nets import (
    TransformerNet, TransformerNetCrossAttention, TransformerNetTwoChannels)
from multimodal_neuroimage_tpu_torch.models.func_struct import (
    FuncStructAdd, FuncStructCross, FuncStructTransfer, FuncStructUNetAdd,
    FuncStructUNetCross, FuncStructUNetCrossPRS)
from multimodal_neuroimage_tpu_torch.models.struct_nets import (
    SwinClassifier, SwinClassifierUNet, SwinClassifierVAE)
from multimodal_neuroimage_tpu_torch.models.swinfusion_net import (
    SwinFusionNet)
from multimodal_neuroimage_tpu_torch.nn.common import LayerNorm
from multimodal_neuroimage_tpu_torch.nn.crossmodal import MultiheadAttention
from multimodal_neuroimage_tpu_torch.nn.unet import BatchStatNorm


def _swin_variant(cfg) -> nn.Module:
    """Step-3 dispatch."""
    if cfg.use_vae:
        return SwinClassifierVAE.from_config(cfg)
    if cfg.use_unet:
        return SwinClassifierUNet.from_config(cfg)
    return SwinClassifier.from_config(cfg)


def _lowfreq_variant(cfg) -> nn.Module:
    """Step-2 dispatch (JAX ``_lowfreq_variant``)."""
    if cfg.fmri_multimodality_type == "cross_attention":
        return TransformerNetCrossAttention.from_config(cfg)
    return TransformerNetTwoChannels.from_config(cfg)


def _funcstruct_variant(cfg) -> nn.Module:
    """Step-5 dispatch (JAX ``_funcstruct_variant``)."""
    if cfg.multimodality_type == "add":
        cls = FuncStructUNetAdd if cfg.use_unet else FuncStructAdd
        return cls.from_config(cfg)
    if cfg.multimodality_type == "transfer":
        return FuncStructTransfer.from_config(cfg)
    if cfg.use_unet:
        cls = FuncStructUNetCrossPRS if cfg.use_prs else FuncStructUNetCross
        return cls.from_config(cfg)
    return FuncStructCross.from_config(cfg)


def create_model(cfg) -> nn.Module:
    task = cfg.task.lower()
    if task == "2dbert":
        return TransformerNet.from_config(cfg)
    if task == "lowfreqbert":
        return _lowfreq_variant(cfg)
    if task == "vit":
        return _swin_variant(cfg)
    if task == "funcstruct":
        return _funcstruct_variant(cfg)
    if task == "swinfusion":
        return SwinFusionNet.from_config(cfg)
    if task == "test":
        if cfg.dataset_name in ("fMRI_timeseries", "hcp"):
            if cfg.fmri_type == "divided_frequency":
                if (cfg.model_weights_path is not None
                        and "DTI+sMRI" in str(cfg.model_weights_path)):
                    return FuncStructTransfer.from_config(cfg)
                return _lowfreq_variant(cfg)
            return TransformerNet.from_config(cfg)
        if cfg.dataset_name in ("DTI", "sMRI", "DTI+sMRI"):
            return _swin_variant(cfg)
        if cfg.dataset_name == "struct":
            return SwinFusionNet.from_config(cfg)
        if "multimodal" in cfg.dataset_name:
            return _funcstruct_variant(cfg)
    raise NotImplementedError(f"task {cfg.task} / dataset {cfg.dataset_name}")


@torch.no_grad()
def init_random_weights(model: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``generator``: Linear, Conv
    and transposed Conv layers get torch's default init (kaiming-uniform(a=
    sqrt(5)) weights, U(+-1/sqrt(fan_in)) biases), LayerNorms and the
    UNet's BatchStatNorms 1 + N(0, 0.1) scales and
    N(0, 0.1) shifts, embeddings N(0, 0.02), the MulT attention's
    in-projection xavier-uniform weights and N(0, 0.02) biases (a
    ``TimeProj`` is a Conv), and every other tensor
    (logit scales, q/v biases, bias tables: constants at construction)
    N(0, 0.02) around its constant. The LayerNorm jitter keeps SwinV2's
    zero-initialised res-post-norms from silencing whole blocks."""

    def uniform(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)

    def normal(t, std):
        return torch.randn(t.shape, generator=generator) * std

    done = set()
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d,
                            nn.ConvTranspose2d)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            # kaiming_uniform(a=sqrt(5)) has bound sqrt(6 / ((1 + 5) fan_in))
            uniform(mod.weight, bound)
            if mod.bias is not None:
                uniform(mod.bias, bound)
        elif isinstance(mod, (LayerNorm, BatchStatNorm)):
            mod.weight.copy_(1.0 + normal(mod.weight, 0.1))
            mod.bias.copy_(normal(mod.bias, 0.1))
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight, 0.02))
        elif isinstance(mod, MultiheadAttention):
            # xavier-uniform over the (3E, E) in-projection (fairseq's)
            E = mod.in_proj_weight.shape[1]
            uniform(mod.in_proj_weight, math.sqrt(6.0 / (4 * E)))
            mod.in_proj_bias.copy_(normal(mod.in_proj_bias, 0.02))
        else:
            continue
        done.update(id(p) for p in mod.parameters(recurse=False))
    for p in model.parameters():
        if id(p) not in done:
            p.add_(normal(p, 0.02))
    return model
