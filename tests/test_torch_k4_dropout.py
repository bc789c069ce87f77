"""K4 (window attention) with attention-probability dropout, on the CPU.

* At rate 0 the port's K4 (on CPU tensors its plain version) has the JAX
  kernel's output and gradients, ``fused_window_attention`` run with
  ``interpret=True`` as the JAX package's own tests run it.
* At rate 0.1 the JAX kernel draws from the TPU's PRNG, so there is no JAX
  counterpart: the hash mask repeats for one seed, differs across seeds and
  keeps about 0.9 of the probabilities, and the gradients autograd takes
  through the plain version are the closed form the CUDA backward computes
  (dP = keep o (dout v^T), ds = p (dP - rowsum(dout o out)), dv = (p o
  keep)^T dout). The card holds the kernel against the plain version on the
  same masks (tests/test_torch_cuda.py, chip_smoke.py).
* A tiny flagship training step runs with the SwinV2 head's attention
  dropout at 0.1 (the flagship's config, like the JAX package's, gives its
  head rate 0, so the test sets the head's rate on the modules).

Tolerance: float32, rtol 2e-4 / atol 1e-4 (the goldens' tolerance).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _example_batch, _flagship_cfg
from multimodal_neuroimage_tpu.nn.swin2d import shift_attn_mask
from multimodal_neuroimage_tpu.ops import attention as jatt
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.models.registry import (
    create_model, init_random_weights)
from multimodal_neuroimage_tpu_torch.nn.swin2d import WindowAttentionV2
from multimodal_neuroimage_tpu_torch.ops import attention as tatt
from multimodal_neuroimage_tpu_torch.train.losses import active_losses
from multimodal_neuroimage_tpu_torch.train.state import (create_optimizer,
                                                         make_train_step)

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
CASES = [(36, 4, 3, 12), (36, 1, 6, 0), (9, 1, 12, 0)]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _inputs(N, nW, H, shift_res, seed=0):
    rng = np.random.default_rng(seed + N + nW + H)
    B, D = 2, 4
    ws = int(np.sqrt(N))
    q, k, v, g = (rng.normal(size=(B, nW, H, N, D)).astype(np.float32)
                  for _ in range(4))
    bias = (16 / (1 + np.exp(-rng.normal(size=(H, N, N))))).astype(np.float32)
    mask = (shift_attn_mask(shift_res, shift_res, ws, ws // 2)
            if shift_res else None)
    return 3 * q, k, v, g, bias, mask


@pytest.mark.parametrize("N,nW,H,shift_res", CASES)
def test_rate0_forward_and_gradients_match_jax(N, nW, H, shift_res):
    q, k, v, g, bias, mask = _inputs(N, nW, H, shift_res)

    def jfn(q_, k_, v_, b_):
        return jatt.fused_window_attention(q_, k_, v_, b_, mask,
                                           interpret=True)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(t) for t in (q, k, v, bias)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    out = tatt.fused_window_attention(
        *ts, None if mask is None else torch.from_numpy(mask), 1234, 0.0)
    out.backward(torch.from_numpy(g))
    _close(out.detach(), want)
    for t, w in zip(ts, want_grads):
        _close(t.grad, w)


def test_mask_repeats_for_a_seed_differs_across_seeds_keeps_0_9():
    a = tatt.window_attention_keep(4, 4, 3, 36, 7, 0.1)
    b = tatt.window_attention_keep(4, 4, 3, 36, 7, 0.1)
    c = tatt.window_attention_keep(4, 4, 3, 36, 8, 0.1)
    assert a.shape == (4, 4, 3, 36, 36)
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a > 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01, kept
    assert torch.all((a == 0) | (a == torch.tensor(1 / 0.9)))
    # rows are distinct across (b, w, h, i): no two heads share a mask
    assert not torch.equal(a[0, 0, 0], a[0, 0, 1])
    assert not torch.equal(a[0, 0, 0], a[1, 0, 0])


@pytest.mark.parametrize("N,nW,H,shift_res", CASES)
def test_rate_0_1_plain_version_and_closed_form_backward(N, nW, H,
                                                         shift_res):
    q, k, v, g, bias, mask = (torch.from_numpy(t) if t is not None else None
                              for t in _inputs(N, nW, H, shift_res, seed=1))
    seed, rate = 99, 0.1
    ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = tatt.fused_window_attention(*ts, mask, seed, rate)
    out.backward(g)
    assert not torch.allclose(out, tatt.attention_reference(q, k, v, bias,
                                                            mask))
    # the closed form of csrc/window_attention.cu's backward
    s = torch.einsum("bwhnd,bwhmd->bwhnm", q, k) + bias[None, None]
    if mask is not None:
        s = s + mask[None, :, None]
    p = torch.softmax(s, -1)
    keep = tatt.window_attention_keep(*q.shape[:4], seed, rate)
    _close(out.detach(), torch.einsum("bwhnm,bwhmd->bwhnd", p * keep, v))
    delta = (g * out.detach()).sum(-1, keepdim=True)
    ds = p * (keep * torch.einsum("bwhnd,bwhmd->bwhnm", g, v) - delta)
    want = (torch.einsum("bwhnm,bwhmd->bwhnd", ds, k),
            torch.einsum("bwhnm,bwhnd->bwhmd", ds, q),
            torch.einsum("bwhnm,bwhnd->bwhmd", p * keep, g),
            ds.sum((0, 1)))
    for t, w in zip(ts, want):
        _close(t.grad, w)


def test_tiny_flagship_trains_with_swinv2_attention_dropout():
    jcfg = dataclasses.replace(_flagship_cfg(tiny=True),
                               compute_dtype="float32", preprocess="host",
                               batch_size=2).validate()
    cfg = Config(**dataclasses.asdict(jcfg))
    batch = _example_batch(2, t=32, r=cfg.intermediate_vec)
    batch["target"] = np.asarray([0.0, 1.0], np.float32)
    losses = {}
    for rate in (0.0, 0.1):
        model = init_random_weights(create_model(cfg),
                                    torch.Generator().manual_seed(3))
        heads = [m for m in model.swin.modules()
                 if isinstance(m, WindowAttentionV2)]
        assert heads
        for m in heads:
            m.attn_drop = rate
        opt = create_optimizer("AdamW", model.parameters(), lambda t: 1e-3,
                               1e-5)
        step = make_train_step(model, active_losses(cfg.task,
                                                    cfg.fine_tune_task),
                               opt, "float32", "cpu")
        out, _ = step(batch, torch.Generator().manual_seed(4))
        assert torch.isfinite(out["total"]) and opt.count == 1
        assert all(torch.isfinite(p.grad).all() for p in model.parameters()
                   if p.grad is not None)
        losses[rate] = out["total"].item()
    assert losses[0.0] != losses[0.1]


def test_rate_out_of_range_is_refused():
    t = torch.zeros(1, 1, 1, 4, 2)
    with pytest.raises(ValueError, match="rate"):
        tatt.fused_window_attention(t, t, t, torch.zeros(1, 4, 4), None, 0,
                                    1.0)
