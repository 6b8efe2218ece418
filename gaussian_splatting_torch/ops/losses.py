"""Training losses: L1, L2, windowed SSIM (plain and fused), depth L1.

Counterpart of ``gaussian_splatting_tpu/ops/losses.py``.  SSIM is the
reference's: an 11x11 Gaussian window (sigma 1.5), per-channel depthwise
convolution with zero-padded SAME borders, C1 = 0.01^2, C2 = 0.03^2.  The
blur is two depthwise ``F.conv2d`` passes (a column then a row kernel), as
JAX runs two XLA convolutions; TF32 is off (package ``__init__``), so they
run in full float32.  ``fused_ssim`` has JAX's one-blur backward.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01**2
C2 = 0.03**2
WINDOW = 11
SIGMA = 1.5


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with ``jnp.abs``'s gradient: +1 at 0 (``torch.abs``'s is 0).
    An L1 term's ties (a pixel rendered exactly as its target, such as
    empty background on a black one) then pass JAX's gradient on."""
    return torch.where(x >= 0, x, -x)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(absolute(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


@functools.lru_cache(maxsize=4)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    xs = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
         for x in range(window_size)],
        np.float32,
    )
    return xs / xs.sum()


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Depthwise separable Gaussian blur with zero padding, NCHW."""
    c = img.shape[1]
    g = torch.from_numpy(_gaussian_window(WINDOW, SIGMA)).to(img.device)
    pad = WINDOW // 2
    kh = g.reshape(1, 1, WINDOW, 1).repeat(c, 1, 1, 1)
    kw = g.reshape(1, 1, 1, WINDOW).repeat(c, 1, 1, 1)
    out = F.conv2d(img, kh, padding=(pad, 0), groups=c)
    return F.conv2d(out, kw, padding=(0, pad), groups=c)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over (C, H, W) or (N, C, H, W) images in [0, 1]."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1) - mu1_sq
    sigma2_sq = _blur(img2 * img2) - mu2_sq
    sigma12 = _blur(img1 * img2) - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return torch.mean(ssim_map)


def _ssim_partials(img1: torch.Tensor, img2: torch.Tensor):
    """SSIM map and the three partials the fused backward needs (one
    5-group blur for all five moments)."""
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=1)
    blurred = _blur(stacked)
    c = img1.shape[1]
    mu1, mu2, x2, y2, xy = (blurred[:, i * c : (i + 1) * c] for i in range(5))
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = x2 - mu1_sq
    sigma2_sq = y2 - mu2_sq
    sigma12 = xy - mu1_mu2

    A1 = 2.0 * mu1_mu2 + C1
    A2 = 2.0 * sigma12 + C2
    B1 = mu1_sq + mu2_sq + C1
    B2 = sigma1_sq + sigma2_sq + C2
    inv_B1B2 = 1.0 / (B1 * B2)
    m = A1 * A2 * inv_B1B2
    dm_dmu1 = (2.0 * mu2 * A2 - 2.0 * mu1 * A1 * A2 / B1) * inv_B1B2
    dm_dsigma1_sq = -A1 * A2 * inv_B1B2 / B2
    dm_dsigma12 = 2.0 * A1 * inv_B1B2
    return m, (mu1, mu2, dm_dmu1, dm_dsigma1_sq, dm_dsigma12)


class _FusedSSIM(torch.autograd.Function):
    """Mean SSIM, differentiable in ``img1`` only, with the fused one-blur
    backward: dL/dx = blur(G1) + 2x blur(G2) - 2 blur(G2 mu1) + y blur(G3)
    - blur(G3 mu2), scaled by the mean's 1/size."""

    @staticmethod
    def forward(ctx, img1, img2):
        m, parts = _ssim_partials(img1, img2)
        ctx.save_for_backward(img1, img2, *parts)
        return torch.mean(m)

    @staticmethod
    def backward(ctx, g):
        img1, img2, mu1, mu2, G1, G2, G3 = ctx.saved_tensors
        gmap = g / img1.numel()
        blurred = _blur(torch.cat([G1, G2, G2 * mu1, G3, G3 * mu2], dim=1))
        c = img1.shape[1]
        b1, b2, b2m1, b3, b3m2 = (blurred[:, i * c : (i + 1) * c] for i in range(5))
        dimg1 = gmap * (b1 + 2.0 * img1 * b2 - 2.0 * b2m1 + img2 * b3 - b3m2)
        return dimg1, None


def fused_ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM with the fused backward (reference fused-ssim, ``train=True``
    mode): ``img2`` is the ground truth and gets no gradient."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return _FusedSSIM.apply(img1, img2)


class _FusedSSIMWeightedSum(torch.autograd.Function):
    """``sum(ssim_map * weight)``, differentiable in ``img1`` only.  A
    per-pixel cotangent does not commute with the blur, so the weight
    multiplies the G-terms before the (self-adjoint) backward blur."""

    @staticmethod
    def forward(ctx, img1, img2, weight):
        m, parts = _ssim_partials(img1[None], img2[None])
        ctx.save_for_backward(img1[None], img2[None], weight, *parts)
        return torch.sum(m[0] * weight[None])

    @staticmethod
    def backward(ctx, g):
        img1, img2, weight, mu1, mu2, G1, G2, G3 = ctx.saved_tensors
        gmap = (g * weight)[None, None]
        blurred = _blur(torch.cat(
            [gmap * G1, gmap * G2, gmap * G2 * mu1, gmap * G3, gmap * G3 * mu2], dim=1))
        c = img1.shape[1]
        b1, b2, b2m1, b3, b3m2 = (blurred[:, i * c : (i + 1) * c] for i in range(5))
        dimg1 = b1 + 2.0 * img1 * b2 - 2.0 * b2m1 + img2 * b3 - b3m2
        return dimg1[0], None, None


def fused_ssim_weighted_sum(
    img1: torch.Tensor, img2: torch.Tensor, weight: torch.Tensor
) -> torch.Tensor:
    """The stripe-local SSIM term of ``parallel.gshard``: a (C, Hext, W)
    strip extended by the blur's 5-row halo, and a (Hext, W) ``weight`` that
    selects the strip's own rows and carries the full image's 1/denominator,
    so the sum over stripes is the full-image ``fused_ssim``."""
    return _FusedSSIMWeightedSum.apply(img1, img2, weight)


def photometric_loss(image: torch.Tensor, gt: torch.Tensor, lambda_dssim: float) -> torch.Tensor:
    """(1 - lambda) L1 + lambda (1 - SSIM), with the fused SSIM."""
    return (1.0 - lambda_dssim) * l1_loss(image, gt) + lambda_dssim * (1.0 - fused_ssim(image, gt))


def depth_l1_loss(
    invdepth: torch.Tensor, mono_invdepth: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Masked mean absolute inverse-depth error."""
    return torch.mean(absolute(invdepth - mono_invdepth) * mask)
