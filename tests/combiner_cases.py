"""Shared set-up of the combiner tests (tests/test_torch_combiners*.py):
phase 5's Func+Struct combiners built by both registries from the tiny
flagship's config, the same random parameters in both, one training step
on each side.

The configs are ``_flagship_cfg(tiny=True)`` (2 BERT layers a band, FFN
128, 48 ROIs, a small SwinV2, a depth-1 fusion backbone) with dropout off;
the PRS model at 84 ROIs, where the UNet's bottleneck is the 5x5 of its PRS
latent. Parameters come from ``jax.eval_shape`` of the JAX model's init
(no compile) drawn with numpy, and reach the port through
``jax_params_to_state_dict``. At float32 the JAX side runs the plain XLA
reference of its kernels (the kernels are held against the port's in
interpret mode by tests/test_torch_flagship.py, test_torch_struct.py and
test_torch_bf16.py); at the bf16 policy it runs its kernels interpreted,
as tests/test_torch_bf16.py does. The port's wrappers take their plain
versions on the CPU.

A UNet model's gradients are held to JAX's float64 step (``jax_step64``):
a float32 run through the UNet's batch-statistics norms can land far from
it (JAX's float32 step lands up to 2.4x rtol 2e-4 / atol 1e-4 from its own
float64 step on ``FuncStructUNetAdd``; ``python tests/combiner_cases.py``
prints each side's distance), so JAX's float32 step is no witness for the
port's.
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.nn import unet as junet
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu.train import losses as jlosses
from multimodal_neuroimage_tpu.train.state import _cast_tree
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import create_model
from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.state import (batch_to_device,
                                                         bf16_weights,
                                                         forward_at,
                                                         round_grads)
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

RTOL, ATOL = 2e-4, 1e-4
# the bounds the flagship's bf16 test held its components to while JAX's
# side of it computed on a float32 batch (tests/test_torch_bf16.py)
LOGIT16 = 3e-2
GRAD16 = {"swin": 1e-2, "fusion": 0.15, "fmri_embed": 0.25}
# the bf16 policy, each gradient tensor against JAX's: within OWN16 of its
# own largest |value| plus ATOL16 (the BERTs' key biases, whose gradient is
# zero in exact arithmetic, are within ATOL16 of it; the loosest tensors are
# the bf16 SwinV2's position-bias MLP, whose gradient is ~1e-4 of the
# SwinV2's largest)
OWN16, ATOL16 = 0.35, 1e-7
NO_DROPOUT = dict(transformer_dropout_rate=0.0, bert_attn_dropout=0.0,
                  fusion_drop_rate=0.0, fusion_attn_drop_rate=0.0,
                  fusion_drop_path_rate=0.0)
CASES = {
    "add": ("FuncStructAdd", dict(multimodality_type="add")),
    "transfer": ("FuncStructTransfer", dict(multimodality_type="transfer")),
    "unet_add": ("FuncStructUNetAdd", dict(multimodality_type="add",
                                           use_unet=True)),
    "unet_cross": ("FuncStructUNetCross", dict(
        use_unet=True, use_unet_function=True, use_unet_struct=True)),
    "prs": ("FuncStructUNetCrossPRS", dict(
        use_unet=True, use_prs=True, use_unet_struct=True,
        intermediate_vec=84)),
}


def setup(case, compute_dtype="float32", **kw):
    """(port cfg, JAX model, JAX params, port model carrying them, batch)."""
    name, change = CASES[case]
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True), batch_size=2,
                               compute_dtype=compute_dtype, preprocess="host",
                               **NO_DROPOUT, **{**change, **kw}).validate()
    cfg = Config(**dataclasses.asdict(jcfg))
    jmodel = jcreate(jcfg)
    batch = _example_batch(2, t=32, r=jcfg.intermediate_vec)
    batch["target"] = np.asarray([0.0, 1.0], np.float32)
    batch["prs"] = np.random.default_rng(3).normal(size=(2, 3)).astype(
        np.float32)
    params = random_params(jmodel, batch)
    port = create_model(cfg)
    assert type(port).__name__ == type(jmodel).__name__ == name
    state = jax_params_to_state_dict(params)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    return cfg, jmodel, params, no_bert_dropout(port), batch


def random_params(jmodel, batch, seed=0):
    """Parameters of ``jmodel``'s shapes (``jax.eval_shape`` of its init)
    drawn from numpy: every norm scale 1 + N(0, 0.05), every other leaf
    N(0, 0.05)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            batch)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        base = 1.0 if name.endswith("scale") and "logit" not in name else 0.0
        return (base + 0.05 * rng.normal(size=leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bce(logits, target):
    return jnp.mean(jnp.maximum(logits, 0) - logits * target
                    + jnp.log1p(jnp.exp(-jnp.abs(logits))))


def jax_step(jmodel, params, batch, bf16: bool = False, specs=None):
    """JAX's loss_fn (at bf16, ``_cast_tree`` of parameters and of the batch
    as device arrays, the outputs widened, the kernels interpreted) under
    value_and_grad: loss, outputs, gradients as port state. The loss is the
    head's BCE, or with ``specs`` JAX's ``compute_losses`` total."""
    def f(p):
        b = jax.tree_util.tree_map(jnp.asarray, batch)
        if bf16:
            p, b = _cast_tree(p, jnp.bfloat16), _cast_tree(b, jnp.bfloat16)
        out = _cast_tree(jmodel.apply({"params": p}, b), jnp.float32)
        if specs is not None:
            return jlosses.compute_losses(out, b, specs)["total"], out
        logits = out["binary_classification"]
        return _bce(logits.squeeze(-1), jnp.asarray(batch["target"])), out

    jatt.set_fused_attention(True if bf16 else None)
    try:
        (loss, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
            params)
    finally:
        jatt.set_fused_attention(None)
    return float(loss), out, jax_params_to_state_dict(grads)


def jax_step64(jmodel, params, batch, specs=None):
    """``jax_step`` in float64 (x64, parameters and batch widened) with the
    UNet's norm widened too (its module computes the statistics in float32
    whatever its input; here its ``jnp.float32`` reads float64): the float64
    witness of a UNet model's gradients."""
    wide = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                    if not k.startswith("__")})
    wide.float32 = jnp.float64
    saved, junet.jnp = junet.jnp, wide
    try:
        with jax.enable_x64(True):
            widen = lambda a: (np.asarray(a, np.float64)
                               if np.asarray(a).dtype == np.float32 else a)
            return jax_step(jmodel, jax.tree_util.tree_map(widen, params),
                            {k: widen(v) for k, v in batch.items()},
                            specs=specs)
    finally:
        junet.jnp = saved


def port_step(cfg, port, batch, compute_dtype="float32", specs=None):
    """The port's training forward and backward at ``compute_dtype`` (the
    train step's arithmetic without K5): loss, outputs, gradients (rounded
    to bf16 under the bf16 policy). The losses are ``specs``, by default
    the task's head alone."""
    port.train()
    inputs = batch_to_device(batch, "cpu")
    port.zero_grad()
    ctx = (bf16_weights(port.parameters()) if compute_dtype == "bfloat16"
           else contextlib.nullcontext())
    with ctx:
        out = forward_at(port, inputs, compute_dtype,
                         torch.Generator().manual_seed(0))
        loss = compute_losses(out, inputs, specs or active_losses(
            cfg.task, cfg.fine_tune_task))["total"]
        loss.backward()
    # a parameter off the loss's path (the MulT net's unused stream under
    # U2L / L2U) has no gradient in torch and a zero one in JAX
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in port.named_parameters()}
    if compute_dtype == "bfloat16":
        for g in grads.values():
            round_grads(g)
    return loss.item(), out, grads


def float64_grads(port, batch, monkeypatch):
    """The port's gradients of the same step in float64 (every module,
    the struct's ``.float()`` widening kept at float64)."""
    widen = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda t, *a, **k: (
        t if t.dtype == torch.float64 else widen(t, *a, **k)))
    model = port.double().train()
    model.zero_grad()
    inputs = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    logits = model(inputs, torch.Generator().manual_seed(0))[
        "binary_classification"]
    torch.nn.functional.binary_cross_entropy_with_logits(
        logits.squeeze(-1), inputs["target"]).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    monkeypatch.undo()
    port.float()
    return grads


def close(got, want, msg, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def shares(grads, want):
    """{name: max |grad - want| / the largest |want| of its component}."""
    scale = {}
    for name, w in want.items():
        part = name.split(".")[0]
        scale[part] = max(scale.get(part, 0.0), float(w.abs().max()))
    return {n: float((g - want[n]).abs().max())
            / scale[n.split(".")[0]] for n, g in grads.items()}


def check_step(case, monkeypatch=None, **kw):
    """One float32 step of ``case`` on both sides: logits, the embedding,
    the loss and every gradient at RTOL / ATOL of JAX's float32 step, or
    for a UNet model of JAX's float64 step (``jax_step64``), which the
    port's own float64 step (``float64_grads``) also meets at RTOL / ATOL.
    Returns the port's outputs and JAX's."""
    cfg, jmodel, params, port, batch = setup(case, **kw)
    unet = hasattr(port, "unet")
    step = jax_step64 if unet else jax_step
    loss, want_out, want = step(jmodel, params, batch)
    got_loss, out, grads = port_step(cfg, port, batch)
    for key in ("binary_classification", "embedding_per_ROIs"):
        close(out[key].detach(), want_out[key], key)
    close(got_loss, loss, "loss")
    assert set(grads) == set(want)
    for name, g in grads.items():
        close(g, want[name], name)
    if unet:
        for name, g in float64_grads(port, batch, monkeypatch).items():
            close(g, want[name], f"{name} (float64)")
    return out, want_out


def check_step16(case, grad16=GRAD16, **kw):
    """One step of ``case`` at the bf16 policy on both sides: logits and
    loss within LOGIT16; every gradient tensor within OWN16 of its own
    largest |value| plus ATOL16, and each of a component of ``grad16``
    within that share of the component's largest (tests/test_torch_bf16.py's
    bound for the flagship's components)."""
    cfg, jmodel, params, port, batch = setup(case, "bfloat16", **kw)
    loss, want_out, want = jax_step(jmodel, params, batch, bf16=True)
    got_loss, out, grads = port_step(cfg, port, batch, "bfloat16")
    close(out["binary_classification"].detach(),
          want_out["binary_classification"], "logits", LOGIT16, LOGIT16)
    close(got_loss, loss, "loss", LOGIT16, LOGIT16)
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= OWN16 * float(w.abs().max()) + ATOL16, (name, err)
    for name, s in shares(grads, want).items():
        part = name.split(".")[0]
        if part in grad16:
            assert s <= grad16[part], (name, s)


# ---- phase 2's fMRI nets (tests/test_torch_crossmodal.py and others) ---

# the nets at a small size: 22 ROIs (the HCP width), 2 heads, 2 layers a
# stack, T = 16, dropout off (``no_bert_dropout`` for the rates the
# models fix)
FMRI_TINY = dict(task="lowfreqBERT", step=2, fmri_type="divided_frequency",
                 intermediate_vec=22, num_heads_mult=2, nlevels=2,
                 sequence_length=16, transformer_hidden_layers=2,
                 num_heads_2DBert=2, bert_intermediate_size=32,
                 attn_dropout=0.0, relu_dropout=0.0, res_dropout=0.0,
                 embed_dropout=0.0, transformer_dropout_rate=0.0)
UL_LENGTH = {"timeseries_and_frequency": 184}


def fmri_batch(B, T, R, ul_length=None, seed=0):
    """The bands (and ``fmri_sequence``) of B subjects drawn from numpy,
    subject 0 zero-padded at both ends (2 and 3 steps, as data/filters.py
    pads a short series), subject 1 with one step whose first feature is
    exactly 0: the MulT encoder's pad probe sees both."""
    rng = np.random.default_rng(seed)
    b = {}
    for k, t in (("fmri_sequence", T), ("fmri_lowfreq_sequence", T),
                 ("fmri_ultralowfreq_sequence", ul_length or T)):
        x = rng.normal(size=(B, t, R)).astype(np.float32)
        x[0, :2] = 0.0
        x[0, -3:] = 0.0
        x[1, 5, 0] = 0.0
        b[k] = x
    b["target"] = (np.arange(B) % 2).astype(np.float32)
    return b


def no_bert_dropout(port):
    """The port's BERTs with dropout off (the JAX side runs deterministic,
    and neither package exposes the rates it fixes: the two-channel BERTs'
    attention dropout 0.1, the ``different`` ultralow BERT's hidden dropout
    0.2, or 0.1 in the combiners)."""
    from multimodal_neuroimage_tpu_torch.nn.bert import BertEncoder, BertLayer
    for m in port.modules():
        if isinstance(m, BertLayer):
            m.rates = (0.0, 0.0)
        elif isinstance(m, BertEncoder):
            m.hidden_dropout = 0.0
    return port


def setup_fmri(compute_dtype="float32", **kw):
    """(port cfg, JAX model, JAX params, port model carrying them, batch)
    of a phase-2 net at FMRI_TINY with ``kw``."""
    from multimodal_neuroimage_tpu.config import Config as JConfig
    jcfg = JConfig(**{**FMRI_TINY, **kw},
                   compute_dtype=compute_dtype).validate()
    cfg = Config(**dataclasses.asdict(jcfg))
    jmodel = jcreate(jcfg)
    batch = fmri_batch(2, jcfg.sequence_length, jcfg.intermediate_vec,
                       UL_LENGTH.get(jcfg.fmri_type))
    params = random_params(jmodel, batch)
    port = create_model(cfg)
    assert type(port).__name__ == type(jmodel).__name__
    state = jax_params_to_state_dict(params)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    return cfg, jmodel, params, no_bert_dropout(port), batch


def bound_ratio(got, want):
    """The worst max |got - want| / (ATOL + RTOL |want|) over the tensors
    of ``want``: at most 1 where every tensor meets RTOL / ATOL."""
    return max(float(((got[n].double() - w.double()).abs()
                      / (ATOL + RTOL * w.double().abs())).max())
               for n, w in want.items())


if __name__ == "__main__":
    # The float64 witness of each UNet combiner's gradients: how far JAX's
    # float32 step and the port's float32 and float64 steps land from
    # JAX's float64 step, in multiples of RTOL / ATOL.
    # JAX_PLATFORMS=cpu python tests/combiner_cases.py, with the repo's
    # root on PYTHONPATH
    import pytest

    jax.config.update("jax_platforms", "cpu")
    for case in ("unet_add", "unet_cross", "prs"):
        cfg, jmodel, params, port, batch = setup(case)
        want = jax_step64(jmodel, params, batch)[2]
        jax32 = jax_step(jmodel, params, batch)[2]
        port32 = port_step(cfg, port, batch)[2]
        patch = pytest.MonkeyPatch()
        port64 = float64_grads(port, batch, patch)
        print(f"{CASES[case][0]}: worst |err| / (atol + rtol |want|) "
              f"against JAX's float64 gradients: JAX float32 "
              f"{bound_ratio(jax32, want):.4f}, port float32 "
              f"{bound_ratio(port32, want):.4f}, port float64 "
              f"{bound_ratio(port64, want):.4f}")
