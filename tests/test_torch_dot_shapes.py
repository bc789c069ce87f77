"""K8 (the dot-shape micro-benchmark) against the JAX script, on the CPU.

The JAX kernel (scripts/bench_dot_shapes.py ``_mk``) is a Pallas TPU kernel
without an interpret mode ("Only interpret mode is supported on CPU
backend"), so the port's chain is held against the same chain written in
jnp with the script's own ``_bdot``, operand shapes and inputs (``_mk``
builds both): every variant, f32 and bf16, reps 2, one cell. The port's
``dot_chain`` on CPU tensors runs K8's plain version.

Tolerance: |port - jnp| <= REL * max|jnp|, REL 1e-5 at f32 (sums of up to
7,680 terms in another order) and 5e-3 at bf16: there a score that the two
summation orders leave on either side of a bf16 rounding boundary rounds to
neighbouring bf16 values, 2^-8 apart, before the next product (measured on
cur: 91 of 2,150,400 scores flip in the first pair, 1.4e-4 of the max after
one pair and 1.3e-3 after two).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_neuroimage_tpu_torch.ops import dot_shapes as ds

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = {"f32": 1e-5, "bf16": 5e-3}


@pytest.fixture(scope="module")
def script():
    """scripts/bench_dot_shapes.py as a module, without keeping the
    compilation-cache directory it sets at import."""
    saved = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "bench_dot_shapes", os.path.join(REPO, "scripts", "bench_dot_shapes.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    return mod


def _jnp_chain(script, variant, args, reps, dtype):
    cast = (lambda t: t.astype(dtype))
    a, b, c = args
    for _ in range(reps):
        if variant == "flat":
            dims = (((1,), (0,)), ((), ()))
            s = jax.lax.dot_general(cast(a), cast(b), dims,
                                    preferred_element_type=jnp.float32)
            a = jax.lax.dot_general(cast(s * 1e-3), cast(c), dims,
                                    preferred_element_type=jnp.float32)
        else:
            s = script._bdot(cast(a), cast(b), 2, 1)
            a = script._bdot(cast(s * 1e-3), cast(c), 2, 1)
    return np.asarray(a)


def test_geometry_matches_the_script(script):
    for name in ("B", "NW", "NP", "C", "H", "BC", "L", "LS", "WC", "NCH"):
        assert getattr(ds, name) == getattr(script, name), name
    assert ds.pair_flops("cur") == 5_780_275_200
    assert ds.pair_flops("ffold") == 4 * ds.pair_flops("cur")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ds.VARIANTS)
def test_chain_matches_the_script_chain(script, variant, dtype):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    _, args = script._mk(variant, 2, jdt)
    assert [tuple(a.shape) for a in args] == ds.shapes(variant)
    ops = ds.inputs(variant)
    for a, t in zip(args, ops):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    want = _jnp_chain(script, variant, args, 2, jdt)
    got = ds.dot_chain(variant, *ops, 2, dtype == "bf16", cells=1)
    assert got.shape == (1,) + want.shape
    ref = ds.dot_chain_reference(variant, *ops, 2, dtype == "bf16", cells=1)
    err = np.abs(got[0].numpy() - want).max()
    assert err <= REL[dtype] * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=0,
                               atol=REL[dtype] * np.abs(want).max())


def test_wrapper_broadcasts_batch_strides_and_counts_no_cpu_launch():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 5, 7, generator=g), torch.randn(3, 7, 4,
                                                          generator=g)
    before = ds.batched_matmul.launches
    out = ds.batched_matmul(a.unsqueeze(0).expand(2, 3, 5, 7),
                            b.unsqueeze(0).expand(2, 3, 7, 4), 0.5)
    assert out.shape == (2, 3, 5, 4)
    torch.testing.assert_close(out[1], 0.5 * a @ b)
    assert ds.batched_matmul.launches == before
    rounded = ds.batched_matmul(a, b, 1.0, bf16=True)
    torch.testing.assert_close(rounded, a.bfloat16().float()
                               @ b.bfloat16().float())
    with pytest.raises(ValueError, match="multiply"):
        ds.batched_matmul(a, b.transpose(1, 2))
    with pytest.raises(ValueError, match="variant"):
        ds.shapes("nope")


def _products(variant):
    """(M, N, K, batch) of a variant's scores and context products over the
    7 cells, as dot_chain hands them to the kernel."""
    a, b, c = ds.shapes(variant)
    batch = ds.NCH * int(np.prod(a[:-2]))
    M, K, N = a[-2], a[-1], b[-1]
    return [(M, N, K, batch), (M, c[-1], N, batch)]


@pytest.mark.parametrize("product", [0, 1], ids=["scores", "context"])
@pytest.mark.parametrize("variant", ds.VARIANTS)
def test_chooser_configures_every_product(variant, product):
    M, N, K, batch = _products(variant)[product]
    tile, splits = ds.choose_config(M, N, K, batch)
    bm, bn = ds.TILES[tile]
    # the least padded output: no tile wastes less of this product
    padded = -(-M // bm) * bm * -(-N // bn) * bn
    assert all(padded <= -(-M // m) * m * -(-N // n) * n for m, n in ds.TILES)
    assert M * N / padded >= 0.8, (bm, bn)
    blocks = -(-M // bm) * -(-N // bn) * batch
    # split K only where the grid is short and K long: the context products
    # of cur, ffold and flat
    assert (splits > 1) == (product == 1 and variant in ("cur", "ffold",
                                                         "flat"))
    if splits > 1:
        assert blocks < ds.SPLIT_BELOW <= 2 * blocks * splits
        assert K // splits >= ds.MIN_CHUNKS * ds.K_CHUNK


@pytest.mark.parametrize("K", [1, 29, 32, 40, 96, 240, 1920, 7680, 7681])
def test_k_slices_cover_every_k_once(K):
    nc = -(-K // ds.K_CHUNK)
    for splits in sorted({s for s in (1, 2, 3, 5, nc // 2, nc)
                          if 1 <= s <= nc}):
        cuts = ds.k_slices(K, splits)
        assert len(cuts) == splits
        covered = np.zeros(K, int)
        for k0, k1 in cuts:
            assert k0 < k1 and k0 % ds.K_CHUNK == 0
            covered[k0:k1] += 1
        assert (covered == 1).all(), (K, splits)
        assert [c[0] for c in cuts[1:]] == [c[1] for c in cuts[:-1]]


@pytest.mark.parametrize("bad", [(0, 8, 8, 1), (8, 0, 8, 1), (8, 8, 0, 1),
                                 (8, 8, 8, 0), (8, 8, 8, 65536)])
def test_chooser_raises_outside_its_domain(bad):
    with pytest.raises(ValueError, match="no K8 configuration"):
        ds.choose_config(*bad)


@pytest.mark.parametrize("K,splits", [(64, 0), (64, 3), (1, 2)])
def test_k_slices_refuse_empty_splits(K, splits):
    with pytest.raises(ValueError, match="splits"):
        ds.k_slices(K, splits)
