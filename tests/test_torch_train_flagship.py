"""The port's flagship training step against the JAX package, on the CPU.

* Every kernel wrapper is an autograd Function (its output's ``grad_fn``),
  and a training forward of the tiny flagship with dropout on gives every
  parameter a finite, nonzero gradient (on the card the same is checked in
  tests/test_torch_cuda.py).
* The tiny flagship (``_flagship_cfg(tiny=True)``, float32, every dropout
  and DropPath rate 0 because jax.random streams cannot be reproduced) has
  the JAX loss and gradients: ``jax.value_and_grad`` of the JAX BCE loss
  with the fused kernels (``set_fused_attention(True)``, interpret mode)
  against the port's training forward and backward on the weights carried
  by ``jax_params_to_state_dict``. The per-op files hold the kernels with
  dropout on.
* One CPU training step runs through K5 and moves every parameter.

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance) for the
loss and every gradient.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.models.registry import create_model as jcreate
from multimodal_neuroimage_tpu.train.losses import bce_with_logits as jbce
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.train.losses import (active_losses,
                                                          compute_losses)
from multimodal_neuroimage_tpu_torch.train.state import (batch_to_device,
                                                         create_optimizer,
                                                         make_train_step)
from multimodal_neuroimage_tpu_torch.utils.jax_import import (
    jax_params_to_state_dict)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
NO_DROPOUT = dict(transformer_dropout_rate=0.0, bert_attn_dropout=0.0,
                  fusion_drop_rate=0.0, fusion_attn_drop_rate=0.0,
                  fusion_drop_path_rate=0.0)


def _tiny(**change):
    """The tiny flagship as the port's own Config."""
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2, **change).validate()
    return Config(**dataclasses.asdict(jcfg))


def _batch(cfg, seed=0):
    batch = _example_batch(2, t=32, r=cfg.intermediate_vec)
    batch["target"] = np.asarray([0.0, 1.0], np.float32)
    return batch


def test_every_wrapper_output_carries_its_function():
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl
    from multimodal_neuroimage_tpu_torch.ops import fusion_block as fb
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g).requires_grad_()

    H, F = 8, 32
    bp = [r(H, H), r(H)] * 4 + [r(H), r(H), r(F, H), r(F), r(H, F), r(H),
                                r(H), r(H)]
    assert type(bl.bert_layer_call(r(1, 9, H), bp, 2, 9).grad_fn
                ).__name__ == "_BertLayerFunctionBackward"
    C, N = 4, 4
    sp = [r(C), r(C), r(3 * C, C), r(3 * C), r(C, C), r(C), r(C), r(C),
          r(16, C), r(16), r(C, 16), r(C)]
    cp = [r(C), r(C), r(C), r(C), r(C, C), r(C), r(2 * C, C), r(2 * C),
          r(C, C), r(C), r(C), r(C), r(16, C), r(16), r(C, 16), r(C)]
    x, y, bias = r(1, 1, N, C), r(1, 1, N, C), r(2, N, N)
    for out in (fb.fused_fusion_block(x, sp, bias),
                fb.fused_cross_fusion_block(x, y, cp, bias)):
        assert type(out.grad_fn).__name__ == "_FusionBlockFunctionBackward"
    q = r(1, 1, 2, N, 2)
    assert type(att.fused_window_attention(q, q, q, bias).grad_fn
                ).__name__ == "_WindowAttentionFunctionBackward"


def test_every_parameter_gets_a_gradient_with_dropout_on():
    cfg = _tiny()
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1)).train()
    inputs = batch_to_device(_batch(cfg), "cpu")
    out = model(inputs, generator=torch.Generator().manual_seed(2))
    loss = compute_losses(out, inputs, active_losses(
        cfg.task, cfg.fine_tune_task))["total"]
    loss.backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or p.grad.abs().max() == 0]
    assert not missing, missing
    with pytest.raises(ValueError, match="generator"):
        model(inputs)


def test_training_forward_draws_only_from_the_generator():
    cfg = _tiny()
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(1)).train()
    inputs = batch_to_device(_batch(cfg), "cpu")
    with torch.no_grad():
        a = model(inputs, generator=torch.Generator().manual_seed(3))
        b = model(inputs, generator=torch.Generator().manual_seed(3))
        c = model(inputs, generator=torch.Generator().manual_seed(4))
        d = model.eval()(inputs)
    key = "binary_classification"
    assert torch.equal(a[key], b[key])
    assert not torch.equal(a[key], c[key]) and not torch.equal(a[key], d[key])


@pytest.fixture(scope="module")
def jax_flagship():
    cfg = _tiny(**NO_DROPOUT)
    model = jcreate(cfg)
    batch = _batch(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch)["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=np.shape(p))
        .astype(np.float32), params)
    return cfg, model, params, batch


def test_tiny_flagship_loss_and_gradients_match_jax(jax_flagship):
    from multimodal_neuroimage_tpu.ops.attention import set_fused_attention
    cfg, model, params, batch = jax_flagship

    def loss_fn(p):
        out = model.apply({"params": p}, batch, deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1),
                                "droppath": jax.random.PRNGKey(2)})
        return jbce(out["binary_classification"].squeeze(-1),
                    jnp.asarray(batch["target"]))

    set_fused_attention(True)        # K1-K4 forward and backward, interpreted
    try:
        want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    finally:
        set_fused_attention(None)

    port = create_model(cfg)
    port.load_state_dict(jax_params_to_state_dict(params))
    port.train()
    inputs = batch_to_device(batch, "cpu")
    out = port(inputs, generator=torch.Generator().manual_seed(0))
    loss = compute_losses(out, inputs, active_losses(
        cfg.task, cfg.fine_tune_task))["total"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=RTOL,
                               atol=ATOL)
    want = jax_params_to_state_dict(want_grads)
    grads = dict(port.named_parameters())
    assert set(want) == set(grads)
    for name, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_one_cpu_training_step_updates_every_parameter():
    cfg = _tiny()
    model = init_random_weights(create_model(cfg),
                                torch.Generator().manual_seed(5))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3, 1e-5)
    step = make_train_step(model, active_losses(cfg.task,
                                                cfg.fine_tune_task), opt,
                           "float32", "cpu")
    losses, preds, _ = step(_batch(cfg), torch.Generator().manual_seed(0))
    assert torch.isfinite(losses["total"]) and preds[
        "binary_classification"].shape == (2, 1)
    assert opt.count == 1
    frozen = [n for n, p in model.named_parameters()
              if torch.equal(p.detach(), before[n])]
    assert not frozen, frozen


@pytest.mark.parametrize("change,match", [
    ({"optim": "SGD"}, "unknown optimizer"),
    pytest.param({"accumulation_steps": 2}, None, id="change1-M5"),
])
def test_optimizer_refuses_what_it_does_not_run(change, match):
    """An optimizer other than Adam / AdamW raises; gradient accumulation,
    once refused (M5), builds K5 applied every k micro-steps
    (tests/test_torch_chain.py holds it against JAX's MultiSteps)."""
    cfg = _tiny()

    def build():
        return create_optimizer(change.get("optim", cfg.optim),
                                torch.nn.Linear(2, 2).parameters(),
                                lambda t: 0.1, 0.0,
                                accumulation_steps=change.get(
                                    "accumulation_steps", 1))

    if match is None:
        assert build().k == change["accumulation_steps"]
        return
    with pytest.raises((ValueError, NotImplementedError), match=match):
        build()


def test_train_step_refuses_bf16():
    """The bf16 policy runs (the flagship: tests/test_torch_bf16.py; HCP's
    K6 route: test_train_step_runs_hcp_at_bf16); a compute dtype other than
    float32 and bfloat16, here float16, refuses when the step is built."""
    with pytest.raises(ValueError, match="float16"):
        make_train_step(torch.nn.Linear(2, 2), {}, None, "float16", "cpu")


def test_train_step_runs_hcp_at_bf16(monkeypatch):
    """The HCP step at the bf16 policy, which refused before K6 had its bf16
    form: a bf16 stream reaches K6 (its plain version on the CPU), the loss
    is finite and every gradient of the float32 masters holds bf16 values."""
    from multimodal_neuroimage_tpu_torch.models.registry import create_model
    from multimodal_neuroimage_tpu_torch.ops import attention as att
    hcp = Config(step=1, task="2DBERT", dataset_name="hcp", target="sex",
                 compute_dtype="bfloat16", transformer_hidden_layers=1,
                 bert_intermediate_size=32, sequence_length=648,
                 batch_size=2).validate()
    model = create_model(hcp)
    opt = create_optimizer("adam", model.parameters(), lambda t: 1e-3, 0.0)
    step = make_train_step(model, active_losses(hcp.task,
                                                hcp.fine_tune_task),
                           opt, "bfloat16", "cpu")
    batch = {"fmri_sequence": np.random.default_rng(0).normal(
        size=(2, 648, 22)).astype(np.float32),
        "target": np.asarray([0.0, 1.0], np.float32)}
    seen = []
    real = att._MhaFunction.apply
    monkeypatch.setattr(att._MhaFunction, "apply", staticmethod(
        lambda q, *a: seen.append(q.dtype) or real(q, *a)))
    losses, _, _ = step(batch, torch.Generator().manual_seed(0))
    assert seen == [torch.bfloat16]
    assert torch.isfinite(losses["total"])
    for p in model.parameters():
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float())
