"""The port's weight import (utils/hf_import.py, utils/torch_import.py)
against the JAX package's mappers on the CPU.

* ``bert_state_from_hf`` on a random ``transformers.BertModel`` built from
  a config (nothing downloaded; skipped where ``transformers`` is missing):
  the port's ``BertEncoder`` carrying it against the HF model's sequence
  and pooled outputs, and the state equal to JAX's ``bert_params_from_hf``
  carried by ``jax_params_to_state_dict``.
* ``torch_import`` on a random state dict with the reference's names: a
  model's JAX parameters carried into the port
  (``jax_params_to_state_dict``), renamed to the reference's top-level
  layout and given what the reference's ``.pth`` holds beside them
  (buffers, BatchNorm statistics, dead members, BERT's word embeddings and
  second token type). ``reference_model_state`` gives back exactly the
  port's state; JAX's mapper followed by ``jax_params_to_state_dict``
  gives the same tensors; ``reference_state`` on each block's module
  equals JAX's mapper of that block; a missing ``qkv`` bias maps to zeros
  and any other missing tensor raises; and the JAX model on JAX's mapped tree against the port model on the port's
  mapped state (both on their plain paths).

Tolerance: outputs float32 at the goldens' rtol 2e-4 / atol 1e-4; the
mapped tensors exactly.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

import combiner_cases as cc
from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.utils import hf_import as jhf
from multimodal_neuroimage_tpu.utils import torch_import as jti
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.nn.bert import BertEncoder
from multimodal_neuroimage_tpu_torch.utils import hf_import, torch_import
from multimodal_neuroimage_tpu_torch.utils import jax_import

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(want[k])), k


# ---- HF BERT ----------------------------------------------------------------------

def test_hf_bert_state_against_transformers():
    transformers = pytest.importorskip("transformers")
    H, layers, heads, T = 24, 2, 4, 12
    conf = transformers.BertConfig(
        hidden_size=H, num_hidden_layers=layers, num_attention_heads=heads,
        intermediate_size=64, max_position_embeddings=T, vocab_size=7,
        hidden_act="gelu", hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, layer_norm_eps=1e-12)
    torch.manual_seed(0)
    hf = transformers.BertModel(conf).eval()
    with torch.no_grad():
        for p in hf.parameters():
            p.add_(0.05 * torch.randn_like(p))
    sd = {f"bert.{k}": v for k, v in hf.state_dict().items()}
    state = hf_import.bert_state_from_hf(sd, layers, prefix="bert.")
    assert state["embeddings.token_type_embeddings.weight"].shape == (1, H)
    _same(state, jax_import.bert_encoder_state(
        jhf.bert_params_from_hf(sd, layers, prefix="bert.")))
    port = BertEncoder(H, layers, heads, T, intermediate=64).eval()
    port.load_state_dict(state)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, T, H)).astype(np.float32))
    with torch.no_grad():
        want = hf(inputs_embeds=x)
        seq, pooled = port(x)
    np.testing.assert_allclose(seq.numpy(), want.last_hidden_state.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), want.pooler_output.numpy(),
                               rtol=RTOL, atol=ATOL)


# ---- the reference's layout of each model ----------------------------------------

def _reference_sd(state, top_level, rng):
    """The reference's ``.pth`` of a port state: the members under each of
    ``top_level`` moved to the top, plus what the reference holds beside
    them."""
    sd = {}
    for k, v in state.items():
        for p in top_level:
            if k.startswith(p):
                k = k[len(p):]
                break
        sd[k] = v.clone()

    def extra(name, shape):
        sd[name] = torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    for k in list(sd):
        if k.endswith("bert.embeddings.token_type_embeddings.weight"):
            row = sd[k]
            sd[k] = torch.cat([row, torch.randn(1, row.shape[1])])
            base = k[:-len("token_type_embeddings.weight")]
            extra(base + "word_embeddings.weight", (7, row.shape[1]))
            sd[base + "position_ids"] = torch.arange(4)[None]
        elif k.endswith("attn.logit_scale"):            # a SwinV2 block
            base = k[:-len("logit_scale")]
            extra(base + "relative_coords_table", (1, 5, 5, 2))
            sd[base + "relative_position_index"] = torch.arange(9)
            extra(k[:-len("attn.logit_scale")] + "attn_mask", (4, 9, 9))
        elif k.endswith("relative_position_bias_table"):  # a fusion block
            sd[k.replace("bias_table", "index")] = torch.arange(36)
        elif re.search(r"double_conv\.[14]\.weight$", k):
            base = k[:-len("weight")]
            extra(base + "running_mean", sd[k].shape)
            extra(base + "running_var", sd[k].shape)
            sd[base + "num_batches_tracked"] = torch.tensor(3)
        m = re.match(r"(.*layers_(Ex_A|Ex_B|Re)\.\d+\.)residual_group\.blocks"
                     r"\.0\.norm1\.weight$", k)
        if m:
            extra(m.group(1) + "conv.weight", (4, 4, 3, 3))
        m = re.match(r"(.*layers_Fusion\.\d+\.)residual_group\.blocks\.0"
                     r"\.norm1_A\.weight$", k)
        if m:
            extra(m.group(1) + "conv_A.weight", (4, 4, 3, 3))
            extra(m.group(1) + "conv_B.weight", (4, 4, 3, 3))
    extra("conv_first1_B.weight", (4, 1, 3, 3))
    return sd


def _depths(state, stage):
    """Blocks a stage, by ``stage``'s index, from a state's names."""
    found = {}
    for k in state:
        m = re.match(stage + r"\.(\d+)\.(?:residual_group\.)?blocks\.(\d+)\.",
                     k)
        if m:
            i, j = int(m.group(1)), int(m.group(2))
            found[i] = max(found.get(i, 0), j + 1)
    return tuple(found[i] for i in sorted(found))


def _struct(task, dataset, **kw):
    from multimodal_neuroimage_tpu.config import Config as JConfig
    cfg = Config(task=task, dataset_name=dataset, compute_dtype="float32",
                 **kw).validate()
    jmodel = jcreate(JConfig(**dataclasses.asdict(cfg)).validate())
    rng = np.random.default_rng(1)
    keys = {"struct": ("smri", "dti"), "DTI": ("dti",)}.get(
        dataset, ("struct",))
    batch = {k: rng.normal(size=(2, 84, 84)).astype(np.float32)
             for k in keys}
    params = cc.random_params(jmodel, batch)
    return cfg, jmodel, params, batch


def _flagship():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), batch_size=2,
                               compute_dtype="float32", preprocess="host",
                               **cc.NO_DROPOUT).validate()
    batch = _example_batch(2, t=32, r=jcfg.intermediate_vec)
    jmodel = jcreate(jcfg)
    return (Config(**dataclasses.asdict(jcfg)), jmodel,
            cc.random_params(jmodel, batch), batch)


def _add():
    cfg, jmodel, params, _, batch = cc.setup("add")
    return cfg, jmodel, params, batch


def _mult():
    cfg, jmodel, params, _, batch = cc.setup_fmri()
    return cfg, jmodel, params, batch


def _two_channels():
    cfg, jmodel, params, _, batch = cc.setup_fmri(
        fmri_multimodality_type="two_channels")
    return cfg, jmodel, params, batch


# name: (setup, reference top-level prefixes, JAX mapper); the JAX mapper
# is called as fn(sd, state) with the model's structure read from its port
# state, the port's as torch_import.reference_model_state(sd, cfg)
MODELS = {
    "swinfusion_net": (
        lambda: _struct("SwinFusion", "struct", fusion_ex_depths=(2,),
                        fusion_depths=(1,), fusion_re_depths=(1,),
                        fusion_ex_heads=(2,), fusion_heads=(2,),
                        fusion_re_heads=(2,)),
        ("fusion.",),
        lambda sd, s: jti.swinfusion_net_tree(
            sd, _depths(s, "fusion.layers_Ex_A"),
            _depths(s, "fusion.layers_Fusion"), _depths(s, "fusion.layers_Re"),
            _depths(s, "swin.layers"))),
    "swin_unet_classifier": (
        lambda: _struct("test", "DTI+sMRI", use_unet=True),
        ("unet.", "swin."),
        lambda sd, s: jti.swin_unet_classifier_tree(
            sd, _depths(s, "swin.layers"))),
    "swin_vae_classifier": (
        lambda: _struct("VIT", "DTI", use_vae=True),
        ("vae.", "swin."),
        lambda sd, s: {"vae": jti.vae_tree(sd), "swin": jti.swin_encoder_tree(
            sd, _depths(s, "swin.layers"))}),
    "funcstruct_cross": (
        _flagship, ("fmri_embed.", "fusion."),
        lambda sd, s: jti.funcstruct_cross_tree(
            sd, 2, _depths(s, "fusion.layers_Ex_A"),
            _depths(s, "fusion.layers_Fusion"), _depths(s, "fusion.layers_Re"),
            _depths(s, "swin.layers"))),
    "funcstruct_add": (
        _add, ("fmri_embed.", "swin."),
        lambda sd, s: jti.funcstruct_add_tree(sd, 2,
                                              _depths(s, "swin.layers"))),
    "transformer_net_cross_attention": (
        _mult, (),
        lambda sd, s: jti.transformer_net_cross_attention_tree(sd, 2)),
    "transformer_net_two_channels": (
        _two_channels, (),
        lambda sd, s: jti.transformer_net_two_channels_tree(sd, 2)),
}


@pytest.fixture(scope="module", params=list(MODELS))
def mapped(request):
    setup, top, jax_map = MODELS[request.param]
    cfg, jmodel, params, batch = setup()
    state = jax_import.jax_params_to_state_dict(params)
    sd = _reference_sd(state, top, np.random.default_rng(2))
    return (request.param, cfg, jmodel, batch, state, sd,
            torch_import.reference_model_state(sd, cfg), jax_map(sd, state))


def test_port_mapper_gives_the_port_state(mapped):
    _, cfg, _, _, state, _, got, _ = mapped
    assert sorted(state) == sorted(create_model(cfg).state_dict())
    _same(got, state)


def test_port_mapper_equals_jax_mapper(mapped):
    *_, got, tree = mapped
    _same(got, jax_import.jax_params_to_state_dict(tree))


def test_mapped_models_match_jax(mapped):
    name, cfg, jmodel, batch, _, _, got, tree = mapped
    jatt.set_fused_attention(False)           # JAX's plain paths
    try:
        want = jax.jit(lambda p, b: jmodel.apply(
            {"params": p}, b, deterministic=True))(tree, batch)
    finally:
        jatt.set_fused_attention(None)
    port = cc.no_bert_dropout(create_model(cfg))
    port.load_state_dict(got)
    with torch.no_grad():
        out = port.eval()({k: torch.from_numpy(np.asarray(v))
                           for k, v in batch.items() if k != "target"})
    head = ("binary_classification" if "binary_classification" in out
            else "regression")
    np.testing.assert_allclose(out[head].numpy(), np.asarray(want[head]),
                               rtol=RTOL, atol=ATOL, err_msg=name)


# ---- the block-level mappers -------------------------------------------------------

def _blocks_of(state, pattern):
    """{prefix: that block's state} of the blocks whose names match."""
    found = {}
    for k in state:
        m = re.match(pattern, k)
        if m:
            found.setdefault(m.group(1), {})
    for p in found:
        found[p] = {k[len(p):]: v for k, v in state.items()
                    if k.startswith(p)}
    return found


@pytest.mark.parametrize("block", ["fusion", "cross_fusion", "rstb", "crstb",
                                   "swin_block", "mult_encoder", "time_proj",
                                   "unet", "vae"])
def test_block_mappers_equal_jax(block):
    """The port's mapper on each block of a reference-named state dict (the
    block's port module saying what to take) against JAX's mapper of that
    block followed by the port's converter of it (utils/jax_import.py)."""
    rng = np.random.default_rng(4)
    if block in ("fusion", "cross_fusion", "rstb", "crstb"):
        cfg, _, params, _ = _struct("SwinFusion", "struct")
    elif block in ("swin_block", "vae"):
        cfg, _, params, _ = _struct("VIT", "DTI", use_vae=True)
    elif block == "unet":
        cfg, _, params, _ = _struct("test", "DTI+sMRI", use_unet=True)
    else:
        cfg, _, params, _ = _mult()
    model = create_model(cfg)
    sd = _reference_sd(jax_import.jax_params_to_state_dict(params), (), rng)
    def depth(p):
        return len(model.get_submodule(p + "residual_group.blocks"))

    # block: (its prefixes in sd, JAX's state of the block at prefix p)
    cases = {
        "fusion": (r"(.*residual_group_A\.blocks\.0\.)", lambda p:
                   jax_import.fusion_block_state(
                       jti.fusion_block_tree(sd, p))),
        "cross_fusion": (r"(.*layers_Fusion\.0\.residual_group\.blocks\.0\.)",
                         lambda p: jax_import.cross_fusion_block_state(
                             jti.cross_fusion_block_tree(sd, p))),
        "rstb": (r"(.*layers_Ex_A\.0\.)", lambda p:
                 jax_import.rstb_state(jti.rstb_tree(sd, p, depth(p)))),
        "crstb": (r"(.*layers_Fusion\.0\.)", lambda p:
                  jax_import.crstb_state(jti.crstb_tree(sd, p, depth(p)))),
        "swin_block": (r"(swin\.layers\.1\.blocks\.1\.)", lambda p:
                       jax_import.swin_block_state(
                           jti.swin_block_tree(sd, p))),
        "mult_encoder": (r"(trans_mem\.)", lambda p:
                         jax_import.mult_encoder_state(
                             jti.mult_encoder_tree(sd, p, 3))),
        "time_proj": (r"(proj_l\.)weight", lambda p: {
            k[len(p):]: v for k, v in jax_import.time_proj_state(
                jti.time_proj_tree(sd, "proj_l"), "proj_l").items()}),
        "unet": (r"(unet\.)", lambda p:
                 jax_import.unet_state(jti.unet_tree(sd, p))),
        "vae": (r"(vae\.)", lambda p:
                jax_import.mlp_vae_state(jti.vae_tree(sd, p))),
    }
    pattern, want = cases[block]
    prefixes = _blocks_of(sd, pattern)
    assert prefixes, block
    for p in prefixes:
        got = torch_import.reference_state(sd, model.get_submodule(p[:-1]), p)
        _same(got, want(p))
        assert got and all(p + k in sd for k in got)


def test_reference_state_zero_qkv_bias_and_missing_tensor():
    """A reference fusion block built without ``qkv`` bias maps to zero
    biases (JAX's ``qkv_bias=False``); any other tensor the port's module
    holds and the state dict lacks raises ``KeyError``."""
    cfg, _, params, _ = _struct("SwinFusion", "struct")
    model = create_model(cfg)
    p = "fusion.layers_Ex_A.0.residual_group.blocks.0."
    block = model.get_submodule(p[:-1])
    sd = {k: v for k, v in jax_import.jax_params_to_state_dict(
        params).items() if k.startswith(p) and k != p + "attn.qkv.bias"}
    got = torch_import.reference_state(sd, block, p)
    assert torch.equal(got["attn.qkv.bias"],
                       torch.zeros(block.attn.qkv.bias.shape))
    _same({k: v for k, v in got.items() if k != "attn.qkv.bias"},
          {k[len(p):]: v for k, v in sd.items()})
    del sd[p + "norm1.weight"]
    with pytest.raises(KeyError, match="norm1.weight"):
        torch_import.reference_state(sd, block, p)
