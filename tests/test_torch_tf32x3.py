"""The arithmetic of K1 backward's tensor-core GEMM, on the CPU.

``csrc/bert_layer.cu`` ``tc_gemm_kernel`` splits every float32 operand into
big = tf32(x) and small = tf32(x - big) (``cvt.rna.tf32.f32``: round to
nearest, ties away from zero, 10 mantissa bits) and accumulates
small_a big_b + big_a small_b + big_a big_b in float32.
``ops/bert_layer.py`` ``matmul_3xtf32`` is the plain model of that
arithmetic. At the flagship's five FFN backward products (H 84, F 3072,
M = 4 x 369 rows) it stays within the card tolerance of a float64 product,
|got - ref| <= 1e-4 + 2e-4 |ref|, and a single-pass TF32 product does not:
so the kernel's design keeps the port's float32 products before any card
run. Operands are unit normals from seeded numpy draws.
"""

import os

import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu_torch.ops import bert_layer as bl

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 2e-4
H, F, M = 84, 3072, 4 * 369
# (rows, inner, columns) of U = x1 W1^T, DU = dz W2, dW2 = dz^T GELU(U),
# dW1 = DU^T x1, dx1 = DU W1
SHAPES = {"U": (M, H, F), "DU": (M, H, F), "dW2": (H, M, F),
          "dW1": (F, M, H), "dx1": (M, F, H)}


def _operands(name):
    rows, inner, cols = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name) + 1)
    a = rng.standard_normal((rows, inner), dtype=np.float32)
    b = rng.standard_normal((inner, cols), dtype=np.float32)
    return torch.from_numpy(a), torch.from_numpy(b)


def _excess(got, ref):
    """max of |got - ref| - (ATOL + RTOL |ref|): <= 0 within tolerance."""
    excess = (got.double() - ref).abs() - (ATOL + RTOL * ref.abs())
    return excess.max().item()


def test_tf32_round_is_round_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one, one + 2 ** -11, -(one + 2 ** -11), one + 2 ** -12,
                      one + 3 * 2 ** -12, 3.14159265, 0.0, -2.5e-3])
    want = [one, one + 2 ** -10, -(one + 2 ** -10), one, one + 2 ** -10,
            3.140625, 0.0]
    got = bl.tf32_round(x)
    np.testing.assert_allclose(got[:7].tolist(), want, rtol=0, atol=0)
    # every rounded value has at most 10 explicit mantissa bits
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()
    # big + small carries 22 of float32's 24 significand bits
    big, small = bl.tf32_split(x)
    assert ((big + small - x).abs() <= 2 ** -21 * x.abs()).all()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_3xtf32_product_keeps_float32_accuracy(name):
    a, b = _operands(name)
    ref = a.double() @ b.double()
    got = bl.matmul_3xtf32(a, b)
    assert got.dtype == torch.float32
    assert _excess(got, ref) <= 0.0, name
    # single-pass TF32 (one product of the rounded operands) misses
    one_pass = bl.tf32_round(a) @ bl.tf32_round(b)
    assert _excess(one_pass, ref) > 0.0, name
