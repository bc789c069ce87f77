"""The auxiliary losses and the perceptual criterion, the port against the
JAX package on the CPU (train/losses.py, nn/perceptual.py).

* every auxiliary loss (MSE, contrastive, mask, UNet, intensity,
  reconstruction): its value and the gradient of each float input, with
  and without a padded ``valid`` tail, at rtol 2e-4 / atol 1e-4;
* ``intensity_voxel_mask`` element for element (JAX's quantile arithmetic:
  sorted values at floor and ceil of q (n - 1));
* ``PerceptualLoss`` on a seeded npz loaded by both packages'
  ``load_vgg16_npz``, the same slices (JAX's draw handed to the port as
  ``idx``), value and gradient;
* ``compute_losses`` for a ``transformer_reconstruction`` loss set through
  the registry, with the perceptual criterion in ``extra_fns``;
* one ``FuncStructUNetAdd`` training step with ``use_unet_loss`` against
  JAX's float64 step (tests/combiner_cases.py ``jax_step64``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import combiner_cases as cc
from multimodal_neuroimage_tpu.nn import perceptual as jperc
from multimodal_neuroimage_tpu.train import losses as jlosses
from multimodal_neuroimage_tpu_torch.nn import perceptual as tperc
from multimodal_neuroimage_tpu_torch.train import losses as tlosses

# Six xdist workers share the host's cores: one torch thread each.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
B = 3
VALID = [None, [1.0, 1.0, 0.0]]


def _inputs(name, rng):
    """(float inputs, other args) of loss ``name`` at batch B."""
    n = lambda *s, scale=1.0: (scale * rng.normal(size=s)).astype(np.float32)
    if name in ("mse", "reconstruction"):
        return [n(B, 6, 5), n(B, 6, 5)], []
    if name == "contrastive":
        # distances near the margin: the Gram form's cancellation matters
        return [n(B, 7, 8, scale=20.0)], []
    if name == "mask":
        idx = np.stack([rng.choice(9, 3, replace=False) for _ in range(B)])
        return [n(B, 9, 6, scale=30.0), n(B, 9, 6, scale=30.0)], [
            idx.astype(np.int32)]
    if name == "unet":
        return [n(B, 2, 6, 6), n(B, 2, 6, 6), n(B, 1, 6, 6),
                n(B, 1, 6, 6)], []
    if name == "intensity":
        y = np.abs(n(B, 5, 4, 3, 4)) + 0.5
        y[:, :2, :2] = 0.1                     # background at the corner
        return [n(B, 5, 4, 3, 4), y], []
    raise KeyError(name)


def _call(mod, name, xs, extra, valid):
    if name == "mse":
        return mod.mse_loss(xs[0], xs[1], valid)
    if name == "reconstruction":
        return mod.reconstruction_loss(xs[0], xs[1], valid)
    if name == "contrastive":
        return mod.contrastive_loss(xs[0], valid=valid)
    if name == "mask":
        return mod.mask_loss(xs[0], extra[0], xs[1], valid=valid)
    if name == "unet":
        return mod.unet_loss(*xs, valid=valid)
    if name == "intensity":
        return mod.intensity_loss(xs[0], xs[1], valid)
    raise KeyError(name)


@pytest.mark.parametrize("valid", VALID, ids=["all", "padded"])
@pytest.mark.parametrize("name", ["mse", "contrastive", "mask", "unet",
                                  "intensity", "reconstruction"])
def test_auxiliary_loss_and_gradient_match_jax(name, valid):
    rng = np.random.default_rng(len(name))
    xs, extra = _inputs(name, rng)
    v = None if valid is None else np.asarray(valid, np.float32)

    def jfn(*a):
        return _call(jlosses, name, a, [jnp.asarray(e) for e in extra],
                     None if v is None else jnp.asarray(v))
    want, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(xs))))(
        *[jnp.asarray(x) for x in xs])
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = _call(tlosses, name, ts, [torch.from_numpy(e) for e in extra],
                None if v is None else torch.from_numpy(v))
    got.backward()
    cc.close(got.detach(), want, f"{name} value", RTOL, ATOL)
    for i, (t, g) in enumerate(zip(ts, jgrads)):
        cc.close(t.grad, g, f"{name} gradient {i}", RTOL, ATOL)


@pytest.mark.parametrize("low_quantile", [0.9, 0.5])
def test_intensity_voxel_mask_is_jax_element_for_element(low_quantile):
    """The mask of every (batch, TR) frame equals JAX's; the elements
    within one ulp of their frame's threshold (where a last-bit difference
    of the interpolation would flip one) are counted in the message."""
    rng = np.random.default_rng(11)
    y = np.abs(rng.normal(size=(2, 7, 6, 5, 3))).astype(np.float32)
    y[:, :3, :3, :2] = 0.05
    want = np.asarray(jlosses.intensity_voxel_mask(jnp.asarray(y),
                                                   low_quantile))
    got = tlosses.intensity_voxel_mask(torch.from_numpy(y),
                                       low_quantile).numpy()
    flat = torch.from_numpy(y).permute(0, 4, 1, 2, 3).reshape(6, -1)
    v = torch.where(flat <= flat[:, :1], torch.zeros_like(flat), flat).abs()
    q = 1.0 - ((v > v[:, :1]).sum(1).float() / v.shape[1]) * (
        1.0 - low_quantile)
    thr = tlosses._row_quantile(v, q).numpy()
    near = int((np.abs(v.numpy() - thr[:, None])
                <= np.spacing(np.abs(thr))[:, None]).sum())
    assert want.dtype == got.dtype == bool
    assert np.array_equal(got, want), (
        f"{int((got != want).sum())} elements differ; {near} within an ulp "
        f"of their threshold")
    assert 0 < got.sum() < got.size


def _vgg_npz(path, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, cin, cout in tperc.CONVS:
        arrays[f"{name}/kernel"] = (rng.normal(size=(3, 3, cin, cout))
                                    * (9 * cin) ** -0.5).astype(np.float32)
        arrays[f"{name}/bias"] = (0.1 * rng.normal(size=cout)).astype(
            np.float32)
    np.savez(path, **arrays)
    return str(path)


@pytest.mark.parametrize("valid", VALID, ids=["all", "padded"])
@pytest.mark.parametrize("task,shape", [
    ("transformer_reconstruction", (B, 1, 12, 10, 3, 4)),
    ("autoencoder_reconstruction", (B, 7, 9))])
def test_perceptual_loss_matches_jax(tmp_path, task, shape, valid):
    """Both packages load one seeded npz (HWIO kernels); the port gets the
    slices JAX's permutation draws (``idx``): value and gradient."""
    npz = _vgg_npz(tmp_path / "vgg.npz")
    rng = np.random.default_rng(4)
    pred, target = (rng.normal(size=shape).astype(np.float32)
                    for _ in range(2))
    v = None if valid is None else np.asarray(valid, np.float32)
    jloss = jperc.PerceptualLoss(task=task, weights_npz=npz)
    key = jax.random.PRNGKey(7)

    def jfn(p):
        return jloss(p, jnp.asarray(target), key,
                     None if v is None else jnp.asarray(v))
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(pred))
    tloss = tperc.PerceptualLoss(task=task, weights_npz=npz, device="cpu")
    n, keep = tloss.slice_count(shape)
    idx = np.asarray(jax.random.permutation(key, n)[:keep])
    p = torch.from_numpy(pred).requires_grad_()
    got = tloss(p, torch.from_numpy(target),
                valid=None if v is None else torch.from_numpy(v),
                idx=torch.from_numpy(idx.copy()).long())
    got.backward()
    cc.close(got.detach(), want, "perceptual value", RTOL, ATOL)
    cc.close(p.grad, jgrad, "perceptual gradient", RTOL, ATOL)


def test_reconstruction_loss_set_through_the_registry(tmp_path):
    """``transformer_reconstruction`` with the contrastive and mask flags:
    the registry's five losses, weighted, and their total, with the
    perceptual criterion handed over in ``extra_fns``."""
    task = "transformer_reconstruction"
    kw = dict(use_cont_loss=True, use_mask_loss=True, intensity_factor=0.5,
              perceptual_factor=2.0, reconstruction_factor=3.0)
    jspecs = jlosses.active_losses(task, "regression", **kw)
    tspecs = tlosses.active_losses(task, "regression", **kw)
    assert list(tspecs) == list(jspecs) == [
        "perceptual", "reconstruction", "intensity", "contrastive", "mask"]
    rng = np.random.default_rng(9)
    seq = np.abs(rng.normal(size=(B, 6, 5, 4, 8))).astype(np.float32)
    rec = (seq + 0.1 * rng.normal(size=seq.shape)).astype(np.float32)
    enc = rng.normal(size=(B, 8, 6)).astype(np.float32)
    recon_seq = rng.normal(size=(B, 8, 6)).astype(np.float32)
    idx = np.stack([rng.choice(8, 2, replace=False)
                    for _ in range(B)]).astype(np.int32)
    npz = _vgg_npz(tmp_path / "vgg.npz", seed=2)
    key = jax.random.PRNGKey(3)
    n, keep = tperc.PerceptualLoss(task, npz, device="cpu").slice_count(
        seq.shape)
    jidx = torch.from_numpy(np.asarray(
        jax.random.permutation(key, n)[:keep])).long()
    tfn = tperc.PerceptualLoss(task, npz, device="cpu")
    # the reconstruction criteria read the volume, the pairwise ones the
    # (B, T, E) sequence: two calls, as the outputs hold one of each
    for out_seq, names in ((rec, ("perceptual", "reconstruction",
                                  "intensity")),
                           (recon_seq, ("contrastive", "mask"))):
        specs = {k: jspecs[k] for k in names}
        jout = {"reconstructed_fmri_sequence": jnp.asarray(out_seq),
                "encoded_inputs": jnp.asarray(enc),
                "mask_list": jnp.asarray(idx)}
        want = jlosses.compute_losses(
            jout, {"fmri_sequence": jnp.asarray(seq)}, specs,
            extra_fns={"perceptual": jperc.PerceptualLoss(task, npz)},
            rng=key)
        tout = {k: torch.from_numpy(np.asarray(a)) for k, a in jout.items()}
        got = tlosses.compute_losses(
            tout, {"fmri_sequence": torch.from_numpy(seq)},
            {k: tspecs[k] for k in names},
            extra_fns={"perceptual": lambda p, t, g, valid=None: tfn(
                p, t, g, valid, idx=jidx)})
        assert list(got) == list(names) + ["total"]
        for k in got:
            cc.close(got[k], want[k], k, RTOL, ATOL)


def test_unet_loss_step_matches_jax_float64():
    """``FuncStructUNetAdd`` with ``use_unet_loss``: the loss (head + UNet
    loss) and every gradient of one float32 step against JAX's float64
    step, at rtol 2e-4 / atol 1e-4."""
    cfg, jmodel, params, port, batch = cc.setup("unet_add",
                                                use_unet_loss=True)
    kw = dict(use_unet_loss=True)
    jspecs = jlosses.active_losses(cfg.task, cfg.fine_tune_task, **kw)
    tspecs = tlosses.active_losses(cfg.task, cfg.fine_tune_task, **kw)
    assert set(tspecs) == {"unet", "binary_classification"}
    loss, want_out, want = cc.jax_step64(jmodel, params, batch, jspecs)
    got_loss, out, grads = cc.port_step(cfg, port, batch, specs=tspecs)
    for key in ("fMRI_input", "fMRI_output", "struct_input",
                "struct_output"):
        cc.close(out[key].detach(), want_out[key], key)
    cc.close(got_loss, loss, "loss")
    unet_only = float(jlosses.unet_loss(
        *(jnp.asarray(np.asarray(want_out[k], np.float32)) for k in (
            "fMRI_input", "fMRI_output", "struct_input", "struct_output"))))
    assert unet_only > 0.0
    assert set(grads) == set(want)
    for name, g in grads.items():
        cc.close(g, want[name], name)
