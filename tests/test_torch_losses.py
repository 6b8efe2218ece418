"""Port parity: the training losses against the JAX package's, on the same
numpy inputs.  Values within 1e-6, gradients within 1e-5 (both blur with
two float32 depthwise convolutions; only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import losses as jl
from gaussian_splatting_torch.ops import losses as tl

H, W = 30, 41  # not square, not a multiple of the window


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    return img, gt


def _grad_t(fn, img, gt):
    x = torch.from_numpy(img).requires_grad_(True)
    val = fn(x, torch.from_numpy(gt))
    val.backward()
    return float(val.detach()), x.grad.numpy()


def _grad_j(fn, img, gt):
    val, g = jax.value_and_grad(fn)(jnp.asarray(img), jnp.asarray(gt))
    return float(val), np.asarray(g)


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "ssim", "fused_ssim"])
def test_loss_and_gradient_match_jax(images, name):
    img, gt = images
    tv, tg = _grad_t(getattr(tl, name), img, gt)
    jv, jg = _grad_j(getattr(jl, name), img, gt)
    assert abs(tv - jv) <= 1e-6, (tv, jv)
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=0)
    assert np.abs(tg).max() > 0


def test_fused_ssim_equals_plain_ssim_and_its_autograd(images):
    img, gt = images
    fv, fg = _grad_t(tl.fused_ssim, img, gt)
    sv, sg = _grad_t(tl.ssim, img, gt)
    assert abs(fv - sv) <= 1e-6
    np.testing.assert_allclose(fg, sg, atol=1e-6, rtol=0)


def test_photometric_and_depth_losses_match_jax(images):
    img, gt = images
    rng = np.random.default_rng(1)
    tv, tg = _grad_t(lambda a, b: tl.photometric_loss(a, b, 0.2), img, gt)
    jv, jg = _grad_j(lambda a, b: jl.photometric_loss(a, b, 0.2), img, gt)
    assert abs(tv - jv) <= 1e-6
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=0)

    invd = rng.uniform(0, 2, (H, W)).astype(np.float32)
    mono = rng.uniform(0, 2, (H, W)).astype(np.float32)
    mask = (rng.uniform(size=(H, W)) > 0.3).astype(np.float32)
    tv, tg = _grad_t(lambda a, b: tl.depth_l1_loss(a, b, torch.from_numpy(mask)), invd, mono)
    jv, jg = _grad_j(lambda a, b: jl.depth_l1_loss(a, b, jnp.asarray(mask)), invd, mono)
    assert abs(tv - jv) <= 1e-6
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["l1_loss", "photometric_loss", "depth_l1_loss"])
def test_l1_ties_take_jax_gradient(images, name):
    """Where a value equals its target (a third of the pixels here, some as
    -0.0 against +0.0), ``jnp.abs``'s gradient is +1 and ``torch.abs``'s 0;
    the port's L1 terms take JAX's."""
    img, gt = images
    gt = gt.copy()
    gt[:, ::3] = img[:, ::3]
    img = img.copy()
    img[0, 0, :] = -0.0
    gt[0, 0, :] = 0.0
    mask = np.ones((H, W), np.float32)
    fns = {"l1_loss": (tl.l1_loss, jl.l1_loss),
           "photometric_loss": (lambda a, b: tl.photometric_loss(a, b, 0.2),
                                lambda a, b: jl.photometric_loss(a, b, 0.2)),
           "depth_l1_loss": (lambda a, b: tl.depth_l1_loss(a[0], b[0], torch.from_numpy(mask)),
                             lambda a, b: jl.depth_l1_loss(a[0], b[0], jnp.asarray(mask)))}
    t_fn, j_fn = fns[name]
    tv, tg = _grad_t(t_fn, img, gt)
    jv, jg = _grad_j(j_fn, img, gt)
    assert abs(tv - jv) <= 1e-6
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=0)
    assert (tg[:, ::3] != 0).all() if name != "depth_l1_loss" else (tg[0, :, ::3] != 0).all()


def _weighted_inputs(h=24, w=20):
    rng = np.random.default_rng(2)
    img1 = rng.random((3, h, w)).astype(np.float32)
    img2 = rng.random((3, h, w)).astype(np.float32)
    weight = rng.random((h, w)).astype(np.float32)
    return img1, img2, weight


def test_fused_ssim_weighted_sum_matches_jax():
    img1, img2, weight = _weighted_inputs()
    tw = torch.from_numpy(weight)
    tv, tg = _grad_t(lambda a, b: tl.fused_ssim_weighted_sum(a, b, tw), img1, img2)
    jv, jg = _grad_j(lambda a, b: jl.fused_ssim_weighted_sum(a, b, jnp.asarray(weight)),
                     img1, img2)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_allclose(tg, jg, atol=1e-5 * np.abs(jg).max(), rtol=0)
    assert np.abs(tg).max() > 0


def test_fused_ssim_weighted_sum_equals_autograd_of_the_map():
    """The one-blur backward against autograd through the SSIM map."""
    img1, img2, weight = _weighted_inputs()
    tw = torch.from_numpy(weight)

    def plain(a, b):
        m, _ = tl._ssim_partials(a[None], b[None])
        return torch.sum(m[0] * tw[None])

    fv, fg = _grad_t(lambda a, b: tl.fused_ssim_weighted_sum(a, b, tw), img1, img2)
    pv, pg = _grad_t(plain, img1, img2)
    np.testing.assert_allclose(fv, pv, rtol=1e-6)
    np.testing.assert_allclose(fg, pg, atol=2e-5, rtol=1e-4)


def test_fused_ssim_stripe_decomposition_matches_full_image():
    """The gshard stripe-local SSIM: per-stripe weighted sums over strips with
    5-row halos reproduce the full-image ``fused_ssim``, value and gradient,
    with a ragged last stripe and zero halos at the mesh ends (JAX
    ``tests/test_losses_fused.py``'s case and tolerances)."""
    rng = np.random.default_rng(7)
    h, w, n = 30, 16, 4
    sh = -(-h // n)
    hpad = n * sh
    img1 = rng.random((3, h, w)).astype(np.float32)
    img2 = torch.from_numpy(rng.random((3, h, w)).astype(np.float32))

    def stripes(i1, i2):
        i1p = torch.nn.functional.pad(i1, (0, 0, 5, hpad - h + 5))
        i2p = torch.nn.functional.pad(i2, (0, 0, 5, hpad - h + 5))
        total = 0.0
        for d in range(n):
            y0 = d * sh
            rows_valid = ((y0 + torch.arange(sh)) < h).to(torch.float32)
            weight = (torch.nn.functional.pad(rows_valid, (5, 5))[:, None]
                      * torch.ones((1, w)) / (3.0 * h * w))
            total = total + tl.fused_ssim_weighted_sum(
                i1p[:, y0 : y0 + sh + 10], i2p[:, y0 : y0 + sh + 10], weight)
        return total

    fv, fg = _grad_t(tl.fused_ssim, img1, img2.numpy())
    sv, sg = _grad_t(stripes, img1, img2.numpy())
    np.testing.assert_allclose(sv, fv, rtol=1e-6)
    np.testing.assert_allclose(sg, fg, atol=2e-6, rtol=1e-4)
