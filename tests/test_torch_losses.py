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
