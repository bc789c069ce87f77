"""Model dispatch (counterpart of multimodal_neuroimage_tpu/models/registry.py).

Ported: the flagship ``FuncStructCross`` and the phase-1
``TransformerNet`` (``2DBERT``, and ``test`` on fMRI-only datasets outside
the divided-frequency mode). Every other task raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.models.fmri_nets import TransformerNet
from multimodal_neuroimage_tpu_torch.models.func_struct import FuncStructCross
from multimodal_neuroimage_tpu_torch.nn.common import LayerNorm


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to PyTorch yet "
                               f"(ROADMAP {item})")


def _funcstruct_variant(cfg) -> nn.Module:
    if cfg.multimodality_type in ("add", "transfer"):
        raise _not_ported(f"FuncStruct multimodality_type="
                          f"{cfg.multimodality_type!r}", "M9")
    if cfg.use_unet:
        raise _not_ported("FuncStructUNetCross(PRS)", "M9")
    return FuncStructCross.from_config(cfg)


def create_model(cfg) -> nn.Module:
    task = cfg.task.lower()
    if task == "funcstruct":
        return _funcstruct_variant(cfg)
    if task == "test" and "multimodal" in cfg.dataset_name:
        return _funcstruct_variant(cfg)
    fmri_test = task == "test" and cfg.dataset_name in ("fMRI_timeseries",
                                                        "hcp")
    if task == "2dbert" or (fmri_test
                            and cfg.fmri_type != "divided_frequency"):
        return TransformerNet.from_config(cfg)
    if task == "lowfreqbert" or fmri_test:
        raise _not_ported(f"task {cfg.task!r} (two-channel and cross-"
                          f"attention fMRI nets)", "M7")
    if task == "vit" or (task == "test" and cfg.dataset_name in (
            "DTI", "sMRI", "DTI+sMRI")):
        raise _not_ported(f"task {cfg.task!r} (struct nets)", "M8")
    if task == "swinfusion" or (task == "test"
                                and cfg.dataset_name == "struct"):
        raise _not_ported(f"task {cfg.task!r} (SwinFusionNet)", "M9")
    raise NotImplementedError(f"task {cfg.task} / dataset {cfg.dataset_name}")


@torch.no_grad()
def init_random_weights(model: nn.Module,
                        generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``model`` from ``generator``: Linear and Conv
    layers get torch's default init (kaiming-uniform(a=sqrt(5)) weights,
    U(+-1/sqrt(fan_in)) biases), LayerNorms 1 + N(0, 0.1) scales and
    N(0, 0.1) shifts, embeddings N(0, 0.02), and every other tensor
    (logit scales, q/v biases, bias tables: constants at construction)
    N(0, 0.02) around its constant. The LayerNorm jitter keeps SwinV2's
    zero-initialised res-post-norms from silencing whole blocks."""

    def uniform(t, bound):
        t.copy_(torch.rand(t.shape, generator=generator) * 2 * bound - bound)

    def normal(t, std):
        return torch.randn(t.shape, generator=generator) * std

    done = set()
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            # kaiming_uniform(a=sqrt(5)) has bound sqrt(6 / ((1 + 5) fan_in))
            uniform(mod.weight, bound)
            if mod.bias is not None:
                uniform(mod.bias, bound)
        elif isinstance(mod, LayerNorm):
            mod.weight.copy_(1.0 + normal(mod.weight, 0.1))
            mod.bias.copy_(normal(mod.bias, 0.1))
        elif isinstance(mod, nn.Embedding):
            mod.weight.copy_(normal(mod.weight, 0.02))
        else:
            continue
        done.update(id(p) for p in mod.parameters(recurse=False))
    for p in model.parameters():
        if id(p) not in done:
            p.add_(normal(p, 0.02))
    return model
