"""``FuncStructUNetCrossPRS`` (phase 5's PRS combiner at 84 ROIs, where the
UNet's bottleneck is the 5x5 of its PRS latent), the port against the JAX
package on the CPU (tests/combiner_cases.py builds it from the tiny
flagship's config with dropout off).

* float32, one SAME convolution to 1024 channels (``up_prs``) added at the
  bottleneck: logits, embedding and loss within rtol 2e-4 / atol 1e-4 of
  JAX's float64 step, every gradient of the port's float32 step and of its
  float64 step within rtol 2e-4 / atol 1e-4 of JAX's float64 gradients
  (tests/combiner_cases.py says why float64);
* the bf16 policy: logits and loss within 3e-2, every gradient tensor
  within 0.35 of its own largest |value| (``cc.check_step16``);
* the two other ``prs_unsqueeze`` modes (five convolutions ``up_prs1..5``
  to 64 ... 1024 channels injected by ``hadamard``, and the 5x5 map
  repeated 1024 times): the logits.
"""

import os

import jax
import pytest
import torch

import combiner_cases as cc

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

def test_prs_matches_jax_forward_and_gradients(monkeypatch):
    cc.check_step("prs", monkeypatch)


def test_prs_matches_jax_at_bf16():
    cc.check_step16("prs")


@pytest.mark.parametrize("unsqueeze,concat", [
    ("multiple_convolution", "hadamard"), ("repeat", "add")])
def test_prs_unsqueeze_modes_match_jax(unsqueeze, concat):
    cfg, jmodel, params, port, batch = cc.setup(
        "prs", prs_unsqueeze=unsqueeze, prs_concat_method=concat)
    want = jax.jit(jmodel.apply)({"params": params}, batch)
    with torch.no_grad():
        got = port.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    cc.close(got["binary_classification"], want["binary_classification"],
             "logits")
