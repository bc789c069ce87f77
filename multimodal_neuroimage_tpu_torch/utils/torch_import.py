"""Import the reference's ``.pth`` checkpoints (torch state dicts) into the
port's modules (counterpart of multimodal_neuroimage_tpu/utils/torch_import.py).

Inside a module the port keeps the reference's parameter names and torch
layouts (ROADMAP "Weights cross by name"): ``patch_embed.* / layers.{i}
.blocks.{j}.* / norm / head`` of the SwinV2 encoder, ``attn.qkv`` of a
fusion block, ``fc1 ... fc6`` of the MLP VAE, Conv1d time projections
``(T_out, T_in, 1)``, ``ConvTranspose2d`` kernels ``(in, out, kh, kw)``.
So the port's module says what to take, and no layout changes:
``reference_state(sd, module, prefix)`` reads each key of
``module.state_dict()`` from ``sd`` at ``prefix`` + its reference name, as
a float32 copy. The reference name is the port's, but for a model's
top-level members, which the reference holds elsewhere (``_TOP``: the
flagship's BERTs and SwinFusion backbone at the reference model's top
level, its classifier under ``swin.``). Two things differ:

* each HF BERT inside (nn/bert.BertEncoder) is read by utils/hf_import.py,
  which keeps row 0 of the token-type table;
* a fusion block the reference built without ``qkv`` (``q`` / ``kv``)
  bias gets zero ones, the port's block always having them (JAX's
  mappers' ``qkv_bias=False``).

What the JAX mappers leave out stays out, since the port's modules do not
hold it: buffers the port computes itself (the SwinV2 ``relative_coords_
table`` / ``relative_position_index`` / ``attn_mask``, the fusion blocks'
``relative_position_index``, BERT's ``position_ids``), BatchNorm's running
statistics (the UNet's norm uses its batch's statistics), the reference's
dead members (an RSTB's ``conv`` / ``patch_embed``, a CRSTB's ``conv_A`` /
``conv_B``, the SwinFusion ``conv_first*_B`` stems, BERT's
``word_embeddings``) and the encoders of a MulT branch the configuration
does not build. A tensor the module holds and ``sd`` lacks raises
``KeyError``.

JAX's mappers and the port modules that stand for them here:
``swin_encoder_tree`` / ``swin_block_tree`` (nn/swin2d
``SwinTransformerV2`` / ``SwinTransformerBlock``), ``vae_tree``
(models/struct_nets ``MlpVae``), ``fusion_block_tree`` and
``cross_fusion_block_tree`` (nn/swinfusion ``FusionBlock`` /
``CrossFusionBlock``), ``rstb_tree`` / ``crstb_tree`` (``RSTB`` /
``CRSTB``), ``swinfusion_backbone_tree`` / ``swinfusion_net_tree``
(models/swinfusion_net ``SwinFusionBackbone`` / ``SwinFusionNet``),
``time_proj_tree``, ``mult_encoder_tree`` and
``transformer_net_cross_attention_tree`` (models/fmri_nets ``TimeProj``,
nn/crossmodal ``MultTransformerEncoder``, ``TransformerNetCrossAttention``),
``unet_tree`` / ``swin_unet_classifier_tree`` (nn/unet ``UNet2D``,
``SwinClassifierUNet``) and the model-level ones (``SwinClassifierVAE``,
``TransformerNet``, ``TransformerNetTwoChannels``, ``FuncStructAdd`` /
``FuncStructTransfer``, the flagship ``FuncStructCross``).
``reference_model_state(sd, cfg)`` maps the whole model of a config.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch
from torch import nn

from multimodal_neuroimage_tpu_torch.nn.bert import BertEncoder
from multimodal_neuroimage_tpu_torch.utils.hf_import import (
    bert_state_from_hf, tensor)

SD = Mapping[str, Any]
State = Dict[str, torch.Tensor]

# a model's top-level members -> where the reference holds them, by the
# port model's class (reference model.py: the SwinFusion backbone, the
# dual BERTs, the UNet and the VAE at the model's top level beside the
# SwinV2 members; the SwinFusion classifier under ``swin.``)
_TOP = {
    "SwinClassifier": {"swin.": ""},
    "SwinClassifierVAE": {"vae.": "", "swin.": ""},
    "SwinClassifierUNet": {"unet.": "", "swin.": ""},
    "SwinFusionNet": {"fusion.": "", "swin.": "swin."},
    "FuncStructAdd": {"fmri_embed.": "", "swin.": ""},
    "FuncStructTransfer": {"fmri_embed.": "", "swin.": ""},
    "FuncStructCross": {"fmri_embed.": "", "fusion.": "", "swin.": "swin."},
}
# the projection biases a reference fusion block may have been built
# without
_QKV_BIAS = re.compile(r"attn(_[AB])?\.(qkv|q|kv)\.bias$")


def _reference_name(module: nn.Module, key: str) -> str:
    for port, ref in _TOP.get(type(module).__name__, {}).items():
        if key.startswith(port):
            return ref + key[len(port):]
    return key


def reference_state(sd: SD, module: nn.Module, prefix: str = "") -> State:
    """``module``'s state (every key of its ``state_dict``) from the
    reference's state dict ``sd``, where ``module`` sits under ``prefix``;
    for ``module.load_state_dict``."""
    out: State = {}
    for path, m in module.named_modules():
        if isinstance(m, BertEncoder):
            path = path + "." if path else ""
            out.update({path + k: v for k, v in bert_state_from_hf(
                sd, len(m.encoder["layer"]),
                prefix + _reference_name(module, path)).items()})
    for key, held in module.state_dict().items():
        name = prefix + _reference_name(module, key)
        if key in out:
            continue
        if name in sd:
            out[key] = tensor(sd[name])
        elif _QKV_BIAS.search(key):
            out[key] = torch.zeros(held.shape)
        else:
            raise KeyError(f"{name}: not in the reference's state dict")
    return out


def reference_model_state(sd: SD, cfg, prefix: str = "") -> State:
    """The state of ``cfg``'s whole model (models/registry
    ``create_model``) from the reference's state dict ``sd``."""
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    return reference_state(sd, create_model(cfg), prefix)
