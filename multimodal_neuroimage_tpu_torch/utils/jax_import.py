"""Carry the JAX package's flax parameters into the port's state dict.

``jax_params_to_state_dict(tree)`` takes a Func+Struct combiner's
(``FuncStructCross``, ``FuncStructAdd``, ``FuncStructTransfer``,
``FuncStructUNetAdd``, ``FuncStructUNetCross``, ``FuncStructUNetCrossPRS``),
``TransformerNet``, ``TransformerNetTwoChannels``,
``TransformerNetCrossAttention``, ``SwinClassifier`` (and its VAE and UNet
variants) or ``SwinFusionNet`` parameter tree (nested dicts of arrays, as
``model.init`` returns under "params") and returns the port model's
``state_dict``: flax Dense ``(in, out)`` kernels become torch ``(out, in)``
weights, HWIO convs become OIHW, a ``TimeProj`` kernel ``(T_in, T_out)``
becomes the Conv1d weight ``(T_out, T_in, 1)``, a flax ``ConvTranspose`` kernel
``(kh, kw, in, out)`` becomes torch's ``(in, out, kh, kw)`` flipped in both
spatial axes (lax applies it as a fractionally strided correlation, torch as
the adjoint of a convolution), ``(1, C)`` rows become vectors, and scan-stacked
subtrees (BERT ``layers/layer``, the ``pairs/block_0|block_1`` of even-depth
fusion and SwinV2 stages) are unstacked into numbered blocks. The per-module
converters are public so a test can carry one block across. Imports neither jax
nor flax.

The fusion layout (``FUSION_LAYOUT`` std or bp) changes no parameter: the
bp blocks (K7, ops/fusion_block_bp.py) take the same 12 (self) and 16
(cross) tensors in the same torch layout as K2/K3, so one converter serves
both layouts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

Tree = Mapping[str, Any]
State = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C", copy=True))


def _vec(x) -> torch.Tensor:
    return _t(np.asarray(x).reshape(-1))


def _dense(tree: Tree, name: str) -> State:
    out = {f"{name}.weight": _t(np.asarray(tree["kernel"]).T)}
    if "bias" in tree:
        out[f"{name}.bias"] = _vec(tree["bias"])
    return out


def _ln(tree: Tree, name: str) -> State:
    return {f"{name}.weight": _vec(tree["scale"]),
            f"{name}.bias": _vec(tree["bias"])}


def _conv(tree: Tree, name: str) -> State:
    conv = tree.get("conv", tree)          # TorchConv wraps an nn.Conv
    return {f"{name}.weight": _t(np.asarray(conv["kernel"])
                                 .transpose(3, 2, 0, 1)),
            f"{name}.bias": _vec(conv["bias"])}


def _prefixed(prefix: str, state: State) -> State:
    return {prefix + k: v for k, v in state.items()}


def _unstack(tree: Tree, n: int) -> List[Tree]:
    """Split a subtree whose leaves carry a leading axis of length n."""
    def take(t, i):
        if isinstance(t, Mapping):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]
    return [take(tree, i) for i in range(n)]


def _leading(tree: Tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


def _stack_blocks(tree: Tree) -> List[Tree]:
    """Block subtrees of a stage in order: scanned ``pairs`` (block_0,
    block_1 per pair) or unrolled ``block_{j}``."""
    if "pairs" in tree:
        pairs = tree["pairs"]
        n = _leading(pairs)
        firsts = _unstack(pairs["block_0"], n)
        seconds = _unstack(pairs["block_1"], n)
        return [b for pair in zip(firsts, seconds) for b in pair]
    count = sum(1 for k in tree if k.startswith("block_"))
    return [tree[f"block_{j}"] for j in range(count)]


# ---- BERT ------------------------------------------------------------------

def bert_layer_state(tree: Tree) -> State:
    """nn/bert.BertLayer flat params -> HF-named BertLayer state."""
    names = {"query": "attention.self.query", "key": "attention.self.key",
             "value": "attention.self.value",
             "attn_output": "attention.output.dense",
             "intermediate": "intermediate.dense", "output": "output.dense"}
    out: State = {}
    for j, t in names.items():
        out[f"{t}.weight"] = _t(np.asarray(tree[f"{j}_kernel"]).T)
        out[f"{t}.bias"] = _vec(tree[f"{j}_bias"])
    for j, t in (("attn_ln", "attention.output.LayerNorm"),
                 ("output_ln", "output.LayerNorm")):
        out[f"{t}.weight"] = _vec(tree[f"{j}_scale"])
        out[f"{t}.bias"] = _vec(tree[f"{j}_bias"])
    return out


def bert_encoder_state(tree: Tree) -> State:
    out: State = {
        "embeddings.position_embeddings.weight": _t(
            tree["position_embeddings"]),
        "embeddings.token_type_embeddings.weight": _t(
            tree["token_type_embeddings"]),
        **_ln(tree["embeddings_ln"], "embeddings.LayerNorm"),
        **_dense(tree["pooler_dense"], "pooler.dense")}
    if "layers" in tree:
        stacked = tree["layers"]["layer"]
        layers = _unstack(stacked, _leading(stacked))
    else:
        count = sum(1 for k in tree if k.startswith("layer_"))
        layers = [tree[f"layer_{i}"] for i in range(count)]
    for i, layer in enumerate(layers):
        out.update(_prefixed(f"encoder.layer.{i}.", bert_layer_state(layer)))
    return out


def temporal_bert_state(tree: Tree) -> State:
    return {**_dense(tree["cls_embedding"], "cls_embedding.0"),
            **_prefixed("bert.", bert_encoder_state(tree["bert"]))}


# ---- SwinFusion ------------------------------------------------------------

def fusion_block_state(tree: Tree) -> State:
    """nn/swinfusion.FusionBlock flat params -> FusionBlock state."""
    out: State = {
        "norm1.weight": _vec(tree["norm1_scale"]),
        "norm1.bias": _vec(tree["norm1_bias"]),
        "attn.qkv.weight": _t(np.asarray(tree["qkv_kernel"]).T),
        "attn.qkv.bias": _vec(tree["qkv_bias"]),
        "attn.proj.weight": _t(np.asarray(tree["proj_kernel"]).T),
        "attn.proj.bias": _vec(tree["proj_bias"]),
        "attn.relative_position_bias_table": _t(
            tree["relative_position_bias_table"]),
        "norm2.weight": _vec(tree["norm2_scale"]),
        "norm2.bias": _vec(tree["norm2_bias"]),
        "mlp.fc1.weight": _t(np.asarray(tree["fc1_kernel"]).T),
        "mlp.fc1.bias": _vec(tree["fc1_bias"]),
        "mlp.fc2.weight": _t(np.asarray(tree["fc2_kernel"]).T),
        "mlp.fc2.bias": _vec(tree["fc2_bias"])}
    return out


def cross_fusion_block_state(tree: Tree) -> State:
    """nn/swinfusion.CrossFusionBlock per-stream params -> state."""
    out: State = {}
    for s in ("A", "B"):
        for j in ("norm1", "norm2"):
            out[f"{j}_{s}.weight"] = _vec(tree[f"{j}_{s}_scale"])
            out[f"{j}_{s}.bias"] = _vec(tree[f"{j}_{s}_bias"])
        for j, t in (("q", f"attn_{s}.q"), ("kv", f"attn_{s}.kv"),
                     ("proj", f"attn_{s}.proj"), ("fc1", f"mlp_{s}.fc1"),
                     ("fc2", f"mlp_{s}.fc2")):
            out[f"{t}.weight"] = _t(np.asarray(tree[f"{j}_{s}_kernel"]).T)
            out[f"{t}.bias"] = _vec(tree[f"{j}_{s}_bias"])
        out[f"attn_{s}.relative_position_bias_table"] = _t(
            tree[f"relative_position_bias_table_{s}"])
    return out


def _stack_state(tree: Tree, block_fn) -> State:
    out: State = {}
    for j, block in enumerate(_stack_blocks(tree)):
        out.update(_prefixed(f"blocks.{j}.", block_fn(block)))
    return out


def rstb_state(tree: Tree) -> State:
    return _prefixed("residual_group.",
                     _stack_state(tree["residual_group"], fusion_block_state))


def crstb_state(tree: Tree) -> State:
    return {
        **_prefixed("residual_group_A.", _stack_state(
            tree["residual_group_A"], fusion_block_state)),
        **_prefixed("residual_group_B.", _stack_state(
            tree["residual_group_B"], fusion_block_state)),
        **_prefixed("residual_group.", _stack_state(
            tree["residual_group"], cross_fusion_block_state))}


def _numbered(tree: Tree, stem: str) -> List[Tree]:
    count = sum(1 for k in tree if k.startswith(stem)
                and k[len(stem):].isdigit())
    return [tree[f"{stem}{i}"] for i in range(count)]


def swinfusion_backbone_state(tree: Tree) -> State:
    out: State = {"patch_embed.norm.weight": _vec(tree["patch_norm"]["scale"]),
                  "patch_embed.norm.bias": _vec(tree["patch_norm"]["bias"])}
    for name in ("conv_first1_A", "conv_first2_A", "conv_after_body_Fusion",
                 "conv_last1", "conv_last2", "conv_last3"):
        out.update(_conv(tree[name], name))
    for name in ("norm_Ex_A", "norm_Ex_B", "norm_Fusion_A", "norm_Fusion_B",
                 "norm_Re"):
        out.update(_ln(tree[name], name))
    for stem, dst, fn in (("Ex_A_", "layers_Ex_A", rstb_state),
                          ("Ex_B_", "layers_Ex_B", rstb_state),
                          ("Fusion_", "layers_Fusion", crstb_state),
                          ("Re_", "layers_Re", rstb_state)):
        for i, sub in enumerate(_numbered(tree, stem)):
            out.update(_prefixed(f"{dst}.{i}.", fn(sub)))
    return out


# ---- SwinV2 ----------------------------------------------------------------

def swin_block_state(tree: Tree) -> State:
    a = tree["attn"]
    return {
        "attn.qkv.weight": _t(np.asarray(a["qkv_kernel"]).T),
        "attn.q_bias": _vec(a["q_bias"]), "attn.v_bias": _vec(a["v_bias"]),
        "attn.logit_scale": _t(a["logit_scale"]),
        **_dense(a["cpb_fc1"], "attn.cpb_mlp.0"),
        **_dense(a["cpb_fc2"], "attn.cpb_mlp.2"),
        **_dense(a["proj"], "attn.proj"),
        **_ln(tree["norm1"], "norm1"), **_ln(tree["norm2"], "norm2"),
        **_dense(tree["mlp"]["Dense_0"], "mlp.fc1"),
        **_dense(tree["mlp"]["Dense_1"], "mlp.fc2")}


def swin_state(tree: Tree) -> State:
    pe = tree["patch_embed"]
    out: State = {**_conv(pe["proj"], "patch_embed.proj"),
                  **_ln(pe["norm"], "patch_embed.norm"),
                  **_ln(tree["norm"], "norm"), **_dense(tree["head"], "head")}
    for i, stage in enumerate(_numbered(tree, "stage_")):
        out.update(_prefixed(f"layers.{i}.",
                             _stack_state(stage, swin_block_state)))
        if "downsample" in stage:
            ds = stage["downsample"]
            out.update(_dense(ds["reduction"],
                              f"layers.{i}.downsample.reduction"))
            out.update(_ln(ds["norm"], f"layers.{i}.downsample.norm"))
    return out


# ---- the struct nets' fronts -------------------------------------------------

def mlp_vae_state(tree: Tree) -> State:
    """MlpVae ``enc*/mu/logvar/dec*`` -> the reference's ``fc1 ... fc6``,
    ``fc31`` / ``fc32``."""
    out: State = {}
    for src, dst in (("enc1", "fc1"), ("enc2", "fc2"), ("mu", "fc31"),
                     ("logvar", "fc32"), ("dec1", "fc4"), ("dec2", "fc5"),
                     ("dec3", "fc6")):
        out.update(_dense(tree[src], dst))
    return out


def _double_conv_state(tree: Tree) -> State:
    """DoubleConv ``conv1/bn1/conv2/bn2`` -> ``double_conv.{0,1,3,4}``."""
    out: State = {}
    for conv, norm, i in (("conv1", "bn1", 0), ("conv2", "bn2", 3)):
        out[f"double_conv.{i}.weight"] = _t(
            np.asarray(tree[conv]["kernel"]).transpose(3, 2, 0, 1))
        out.update(_ln(tree[norm], f"double_conv.{i + 1}"))
    return out


def conv_transpose_state(tree: Tree, name: str) -> State:
    """A flax ``ConvTranspose`` -> torch ``ConvTranspose2d``: the kernel
    flipped in both spatial axes, ``(kh, kw, in, out)`` -> ``(in, out, kh,
    kw)``."""
    kernel = np.asarray(tree["kernel"])[::-1, ::-1]
    return {f"{name}.weight": _t(kernel.transpose(2, 3, 0, 1)),
            f"{name}.bias": _vec(tree["bias"])}


def unet_state(tree: Tree) -> State:
    """UNet2D -> ``inc.``, ``down{i}.maxpool_conv.1.``, ``up{i}.up`` (the
    transposed conv, flipped back) and ``up{i}.conv.``."""
    out = _prefixed("inc.", _double_conv_state(tree["inc"]))
    for i in range(1, 5):
        out.update(_prefixed(f"down{i}.maxpool_conv.1.",
                             _double_conv_state(tree[f"down{i}"])))
        up = tree[f"up{i}"]
        out.update(conv_transpose_state(up["up"], f"up{i}.up"))
        out.update(_prefixed(f"up{i}.conv.",
                             _double_conv_state(up["conv"])))
    return out


# ---- phase 2's fMRI nets ----------------------------------------------------

def time_proj_state(tree: Tree, name: str) -> State:
    """TimeProj ``kernel`` (T_in, T_out) -> the reference's Conv1d
    ``{name}.weight`` (T_out, T_in, 1)."""
    return {f"{name}.weight": _t(np.asarray(tree["kernel"]).T[:, :, None])}


def mult_encoder_state(tree: Tree) -> State:
    """MultTransformerEncoder ``layer_{i}`` (``ln0``, ``ln1``,
    ``self_attn``, ``fc1``, ``fc2``) and ``final_ln`` -> the reference's
    ``layers.{i}.layer_norms.{0,1}``, ``self_attn.in_proj_weight`` /
    ``in_proj_bias`` / ``out_proj``, ``fc1``, ``fc2`` and ``layer_norm``."""
    out = _ln(tree["final_ln"], "layer_norm")
    for i, layer in enumerate(_numbered(tree, "layer_")):
        attn = layer["self_attn"]
        out.update(_prefixed(f"layers.{i}.", {
            **_ln(layer["ln0"], "layer_norms.0"),
            **_ln(layer["ln1"], "layer_norms.1"),
            "self_attn.in_proj_weight": _t(attn["in_proj_weight"]),
            "self_attn.in_proj_bias": _vec(attn["in_proj_bias"]),
            **_dense(attn["out_proj"], "self_attn.out_proj"),
            **_dense(layer["fc1"], "fc1"), **_dense(layer["fc2"], "fc2")}))
    return out


MULT_ENCODERS = ("trans_l_with_u", "trans_u_with_l", "trans_mem",
                 "trans_l_mem", "trans_u_mem")


def transformer_net_cross_attention_state(tree: Tree) -> State:
    """TransformerNetCrossAttention -> state: the time projections and
    encoders that the configured branch builds (those the tree holds, as
    JAX's mapper maps only those), ``out_layer1`` under concat mixing,
    ``out_layer2``."""
    out: State = {}
    for name in ("proj_l", "proj_u", "deconv"):
        if name in tree:
            out.update(time_proj_state(tree[name], name))
    for name in MULT_ENCODERS:
        if name in tree:
            out.update(_prefixed(f"{name}.", mult_encoder_state(tree[name])))
    for name in ("out_layer1", "out_layer2"):
        if name in tree:
            out.update(_dense(tree[name], name))
    return out


def _dual_bert_state(tree: Tree) -> State:
    """The two-band front shared by TransformerNetTwoChannels and
    FmriDiagEmbed: ``transformer_raw`` / ``_low`` / ``_ultralow``,
    ``proj_u`` and ``proj_layer``, where present."""
    out: State = {}
    for name in ("transformer_raw", "transformer_low", "transformer_ultralow"):
        if name in tree:
            out.update(_prefixed(f"{name}.", temporal_bert_state(tree[name])))
    if "proj_u" in tree:
        out.update(time_proj_state(tree["proj_u"], "proj_u"))
    if "proj_layer" in tree:
        out.update(_dense(tree["proj_layer"], "proj_layer"))
    return out


def transformer_net_two_channels_state(tree: Tree) -> State:
    return {**_dual_bert_state(tree),
            **_dense(tree["regression_head"], "regression_head")}


# ---- the models ------------------------------------------------------------

def transformer_net_state(tree: Tree) -> State:
    """TransformerNet flax params -> the port's TransformerNet state."""
    return {**_prefixed("transformer.",
                        temporal_bert_state(tree["transformer"])),
            **_dense(tree["regression_head"], "regression_head")}


def jax_params_to_state_dict(tree: Tree) -> State:
    """A model's flax params -> the port model's state, the model told by
    its top-level modules: ``transformer`` (TransformerNet),
    ``trans_l_with_u`` (TransformerNetCrossAttention), ``transformer_low``
    (TransformerNetTwoChannels: no ``swin``), ``fmri_embed`` (a
    Func+Struct combiner: with ``fusion`` where it fuses, ``unet`` where
    its UNet is called, ``conv_prs`` and ``up_prs*`` for the PRS latent),
    ``fusion`` + ``swin`` (SwinFusionNet), ``vae`` + ``swin``
    (SwinClassifierVAE), ``unet`` + ``swin`` (SwinClassifierUNet), ``swin``
    alone (SwinClassifier)."""
    if "transformer" in tree:
        return transformer_net_state(tree)
    if "trans_l_with_u" in tree:
        return transformer_net_cross_attention_state(tree)
    if "transformer_low" in tree:
        return transformer_net_two_channels_state(tree)
    if "fmri_embed" not in tree:
        fronts = {"fusion": swinfusion_backbone_state, "vae": mlp_vae_state,
                  "unet": unet_state}
        out = _prefixed("swin.", swin_state(tree["swin"]))
        for name, fn in fronts.items():
            if name in tree:
                out.update(_prefixed(f"{name}.", fn(tree[name])))
        return out
    out = _prefixed("fmri_embed.", _dual_bert_state(tree["fmri_embed"]))
    if "unet" in tree:
        out.update(_prefixed("unet.", unet_state(tree["unet"])))
    if "conv_prs" in tree:
        out.update(conv_transpose_state(tree["conv_prs"], "conv_prs"))
    for name in sorted(k for k in tree if k.startswith("up_prs")):
        out.update(_conv(tree[name], name))
    if "fusion" in tree:
        out.update(_prefixed("fusion.",
                             swinfusion_backbone_state(tree["fusion"])))
    out.update(_prefixed("swin.", swin_state(tree["swin"])))
    return out
