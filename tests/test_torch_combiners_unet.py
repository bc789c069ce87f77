"""Phase 5's UNet combiners ``FuncStructUNetAdd`` and ``FuncStructUNetCross``,
the port against the JAX package on the CPU (tests/combiner_cases.py builds
them from the tiny flagship's config with dropout off).

Logits, the embedding, the loss and every gradient of the port's float32
step within rtol 2e-4 / atol 1e-4 of JAX's float64 step, and every
gradient of the port's float64 step too: JAX's own float32 step lands up
to 2.4x that bound from its float64 step on ``FuncStructUNetAdd``
(tests/combiner_cases.py).

``FuncStructUNetCross`` with both flags calls its ONE UNet on the
embedding and on the struct (each call normalising with its own batch
statistics), and with ``use_unet_loss`` returns the UNet's inputs and
outputs as JAX's does.
"""

import os

import torch

import combiner_cases as cc

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_unet_add_matches_jax_forward_and_gradients(monkeypatch):
    cc.check_step("unet_add", monkeypatch)


def test_unet_cross_matches_jax_forward_gradients_and_unet_outputs(
        monkeypatch):
    out, want = cc.check_step("unet_cross", monkeypatch, use_unet_loss=True)
    for key in ("fMRI_input", "fMRI_output", "struct_input",
                "struct_output"):
        cc.close(out[key].detach(), want[key], key)
