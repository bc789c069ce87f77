"""K1 at the head dims the HPO space gives the flagship's width (hidden 84,
``num_heads_2DBert`` 4 and 6: head dims 21 and 14), the port against the
JAX package on the CPU.

The port's kernels take every head dim ``Config.validate()`` admits (the
float32 attention above 16 in chunks of 32 dims, the mm16 form padded to
16 KS); on the CPU the wrappers run the plain versions, held here against
``bert_layer_call(..., interpret=True)`` and its VJP with dropout on at a
fixed seed, in the manner of tests/test_torch_train_kernels.py (float32,
rtol 2e-4 / atol 1e-4) and tests/test_torch_bf16.py (mm16, its bounds).
The kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 13).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.config import Config as JConfig
from multimodal_neuroimage_tpu.ops import bert_layer as jbl
from multimodal_neuroimage_tpu_torch.config import Config
from multimodal_neuroimage_tpu_torch.ops import bert_layer as tbl

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
FWD16 = 2e-3            # tests/test_torch_bf16.py's mm16 bounds
GRAD16 = 5e-3
RATES = (0.25, 0.2)
SEED = 1234567
T, H, F = 37, 84, 64


def _to_port(p):
    """JAX kernel layout (Dense (in, out), rows (1, n)) -> port layout."""
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


def _case(heads, t_valid, bf16):
    rng = np.random.default_rng(heads * 100 + t_valid)
    params = [rng.normal(size=s).astype(np.float32) * 0.15
              for s in jbl.param_shapes(H, F)]
    params[8] = np.abs(params[8]) + 0.5
    params[14] = np.abs(params[14]) + 0.5
    if bf16:
        params = [np.asarray(jnp.asarray(p, jnp.bfloat16).astype(
            jnp.float32)) for p in params]
    x = rng.normal(size=(2, T, H)).astype(np.float32)
    g = rng.normal(size=(2, T, H)).astype(np.float32)
    return params, x, g


@pytest.mark.parametrize("mm16", [False, True], ids=["f32", "mm16"])
@pytest.mark.parametrize("heads,t_valid", [(4, T), (6, 30)])
def test_k1_plain_versions_match_jax_at_wide_heads(heads, t_valid, mm16):
    """Training forward and backward, dropout on (attention 0.25, hidden
    0.2), keys masked past ``t_valid`` in the second case."""
    assert H // heads in (21, 14)
    params, x, g = _case(heads, t_valid, mm16)
    TP = jbl.round_up(T, 8)
    pad = ((0, 0), (0, TP - T), (0, 0))

    def jax_fn(x, p):
        return jbl.bert_layer_call(x, p, SEED, heads, t_valid, RATES, True,
                                   interpret=True, mm16=True if mm16 else None)

    want, vjp = jax.vjp(jax_fn, jnp.asarray(np.pad(x, pad)),
                        tuple(jnp.asarray(t) for t in params))
    jdx, jdp = vjp(jnp.asarray(np.pad(g, pad)))
    tx = torch.from_numpy(x).requires_grad_()
    tp = [_to_port(p).requires_grad_() for p in params]
    got = tbl.bert_layer_call(tx, tp, heads, t_valid, SEED, RATES, True,
                              mm16=mm16)
    got.backward(torch.from_numpy(g))
    want = np.asarray(want)[:, :T]
    if not mm16:
        np.testing.assert_allclose(got.detach().numpy(), want, RTOL, ATOL)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx)[:, :T],
                                   RTOL, ATOL)
        for i, (a, b) in enumerate(zip(tp, jdp)):
            np.testing.assert_allclose(a.grad.numpy(), _to_port(b).numpy(),
                                       RTOL, ATOL, err_msg=f"dparams[{i}]")
        return
    np.testing.assert_allclose(got.detach().numpy(), want, FWD16, FWD16)
    grads = [(tx.grad, np.asarray(jdx)[:, :T])] + [
        (a.grad, _to_port(b).numpy()) for a, b in zip(tp, jdp)]
    key_w = float(np.abs(np.asarray(jdp[2])).max())
    for i, (a, b) in enumerate(grads):
        # the key bias's gradient (index 4 here) is zero in exact
        # arithmetic: held at the key weight's gradient's scale
        scale = key_w if i == 4 else float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), b, 0.0, GRAD16 * scale + 1e-6,
                                   err_msg=f"gradient {i}")


def test_hpo_head_counts_are_what_the_config_admits(monkeypatch):
    """Every head count the HPO space draws divides hidden 84 and 48 in
    both packages' ``Config``, so K1 sees head dims 21, 14, 7 (84) and 12,
    8, 4 (48); the wrappers' host check (device checks aside) takes every
    divisor of 84, head dim 84 included, and refuses a head count that
    does not divide H."""
    for hidden in (84, 48):
        for heads in (4, 6, 12):
            kw = dict(intermediate_vec=hidden, num_heads_2DBert=heads)
            assert Config(**kw).validate().num_heads_2DBert == heads
            assert JConfig(**kw).validate().num_heads_2DBert == heads
    monkeypatch.setattr(tbl.build, "check_cuda_f32", lambda *a, **k: None)
    p = [torch.zeros(s) for s in ([H, H], [H]) * 4 + ([H], [H], [F, H], [F],
                                                      [H, F], [H], [H], [H])]
    x = torch.zeros(2, 9, H)
    for heads in (1, 2, 3, 4, 6, 7, 12, 14, 21, 28, 42, 84):
        assert tbl._check(x, p, heads, 9) == (2, 9, H, F)
    with pytest.raises(ValueError, match="heads dividing H"):
        tbl._check(x, p, 5, 9)
