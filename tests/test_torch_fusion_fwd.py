"""The arithmetic of K2/K3's CUDA forward (and K7's float32 body) on the CPU.

The kernel runs the attention's softmax online and in base 2: q scaled by
log2(e) / sqrt(hd), a key's bias + mask by log2 e, keys in steps of
four with the running max and the sums rescaled once a step, and the
dropout scale applied with 1 / l at the end (``ops/fusion_block.py``
``_attn_online``). The kernel cannot run here, so its plain model
``fusion_block_model`` is held:

- against the JAX package's ``fused_fusion_block`` /
  ``fused_cross_fusion_block`` in interpret mode, float32, rtol 2e-4 /
  atol 1e-4 (the goldens' tolerance), inference and training (dropout 0.1
  on all four draws at fixed seeds, DropPath), shifts 0 and 3;
- against float64: the model in float64 is the plain block in float64 to
  1e-12 (the online steps and the base change are exact algebra), and in
  float32 its error against that float64 truth is within 2x the float32
  plain version's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu.nn.swin2d import (relative_position_index,
                                                 shift_attn_mask)
from multimodal_neuroimage_tpu.ops import fusion_block as jfb
from multimodal_neuroimage_tpu_torch.ops import fusion_block as tfb

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
B, RES, WS, C, HEADS = 2, 12, 6, 12, 6
N = WS * WS
NP = jfb.round_up(N, 8)
NW = (RES // WS) ** 2
DP = np.asarray([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], np.float32)
RATES = (0.1, 0.1)


def _inputs(shift, cross):
    rng = np.random.default_rng(100 + 10 * shift + cross)
    shapes = jfb.param_shapes(C, 4 * C, cross)
    params = [rng.normal(size=s).astype(np.float32) * 0.3 for s in shapes]
    for i in ((0, 2, 10) if cross else (0, 6)):     # LN scales positive
        params[i] = np.abs(params[i]) + 0.5
    x, y = (rng.normal(size=(B, NW, N, C)).astype(np.float32)
            for _ in range(2))
    table = (rng.normal(size=((2 * WS - 1) ** 2, HEADS)) * 0.5).astype(
        np.float32)
    return params, x, y, table, shift_attn_mask(RES, RES, WS, shift)


def _to_port(p):
    p = np.asarray(p, np.float32)
    return torch.from_numpy(p.reshape(-1).copy() if p.shape[0] == 1
                            else p.T.copy())


def _port_args(params, x, y, table, mask, dtype=torch.float32):
    bias = tfb.bias_from_table(
        torch.from_numpy(table),
        torch.from_numpy(relative_position_index(WS, WS)), HEADS)
    return ([_to_port(p).to(dtype) for p in params],
            torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype),
            bias.to(dtype),
            None if mask is None else torch.from_numpy(mask).to(dtype),
            torch.from_numpy(DP).to(dtype))


def _pad(t):
    return jnp.asarray(np.pad(t, ((0, 0), (0, 0), (0, NP - N), (0, 0))))


@pytest.mark.parametrize("training,seed", [(False, 0), (True, 11),
                                           (True, 123457)])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shift", [0, 3])
def test_forward_model_matches_jax(shift, cross, training, seed):
    params, x, y, table, mask = _inputs(shift, cross)
    p, tx, ty, bias, tmask, dp = _port_args(params, x, y, table, mask)
    got = tfb.fusion_block_model(tx, ty if cross else None, p, bias, tmask,
                                 dp, seed, RATES, training, cross)
    packed = jfb.packed_bias_from_table(
        jnp.asarray(table), WS, HEADS, NP, relative_position_index(WS, WS))
    maskp = (None if mask is None
             else np.pad(mask, ((0, 0), (0, NP - N), (0, NP - N))))
    jp = tuple(jnp.asarray(t) for t in params)
    if cross:
        want = jfb.fused_cross_fusion_block(
            _pad(x), _pad(y), jp, packed, maskp, jnp.asarray(DP), seed, RATES,
            training, interpret=True)
    else:
        want = jfb.fused_fusion_block(_pad(x), jp, packed, maskp,
                                      jnp.asarray(DP), seed, RATES, training,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :N],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("shift", [0, 3])
def test_forward_model_against_float64(shift, cross):
    params, x, y, table, mask = _inputs(shift, cross)
    args32 = _port_args(params, x, y, table, mask)
    args64 = _port_args(params, x, y, table, mask, torch.float64)

    def run(fn, args):
        p, tx, ty, bias, tmask, dp = args
        return fn(tx, ty if cross else None, p, bias, tmask, dp, 7, RATES,
                  True, cross)

    def plain(*a):
        return tfb._block_reference(*a)
    truth = run(plain, args64)
    model64 = run(tfb.fusion_block_model, args64)
    assert (model64 - truth).abs().max().item() < 1e-12
    model_err = (run(tfb.fusion_block_model, args32).double()
                 - truth).abs().max().item()
    plain_err = (run(plain, args32).double() - truth).abs().max().item()
    assert model_err <= 2 * plain_err, (model_err, plain_err)


def test_model_step_is_the_kernels():
    """The plain model's online-softmax step is the CUDA forward's
    ``FUSION_FWD_KEYS``: the model holds the kernel's arithmetic only while
    the two agree."""
    import re
    from pathlib import Path
    cuh = (Path(tfb.__file__).resolve().parents[1] / "csrc"
           / "fusion_block.cuh").read_text()
    keys = re.findall(r"^#define FUSION_FWD_KEYS (\d+)$", cuh, re.M)
    assert keys == [str(tfb.ONLINE_STEP)]
