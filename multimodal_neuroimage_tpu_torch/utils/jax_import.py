"""Carry the JAX package's flax parameters into the port's state dict.

``jax_params_to_state_dict(tree)`` takes a ``FuncStructCross`` parameter
tree (nested dicts of arrays, as ``model.init`` returns under "params") and
returns the port model's ``state_dict``: flax Dense ``(in, out)`` kernels
become torch ``(out, in)`` weights, HWIO convs become OIHW, ``(1, C)`` rows
become vectors, and scan-stacked subtrees (BERT ``layers/layer``, the
``pairs/block_0|block_1`` of even-depth fusion and SwinV2 stages) are
unstacked into numbered blocks. The per-module converters are public so a
test can carry one block across. Imports neither jax nor flax.
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


# ---- the flagship ------------------------------------------------------------

def jax_params_to_state_dict(tree: Tree) -> State:
    """FuncStructCross flax params -> the port's FuncStructCross state."""
    fe = tree["fmri_embed"]
    out: State = {}
    for name in ("transformer_raw", "transformer_low", "transformer_ultralow"):
        if name in fe:
            out.update(_prefixed(f"fmri_embed.{name}.",
                                 temporal_bert_state(fe[name])))
    if "proj_layer" in fe:
        out.update(_dense(fe["proj_layer"], "fmri_embed.proj_layer"))
    out.update(_prefixed("fusion.", swinfusion_backbone_state(tree["fusion"])))
    out.update(_prefixed("swin.", swin_state(tree["swin"])))
    return out
