"""Plain PyTorch reference of one training step of 3D Gaussian splatting:
render, the L1 + D-SSIM loss, gradients of the stored parameters and of the
screen-space means, Adam, and the densification statistics.

The method's published step (Kerbl et al. 2023, ``train.py``): loss
``(1 - 0.2) L1 + 0.2 (1 - SSIM)`` with an 11x11 Gaussian window (sigma
1.5, zero padding), Adam with betas 0.9 / 0.999 and eps 1e-15, per-group
learning rates, the position rate decayed log-linearly from 1.6e-4 to
1.6e-6 over 30,000 steps and scaled by the scene extent; statistics are the
norm of the screen-space mean's gradient in NDC units, the count of steps a
Gaussian was visible, and its largest radius.  The state is a dict of
tensors that this module never shares with the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import render as rr

PARAM_NAMES = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")
STAT_NAMES = ("xyz_grad_accum", "denom", "max_radii2d")
B1, B2, EPS = 0.9, 0.999, 1e-15
LAMBDA_DSSIM = 0.2
LR = {"features_dc": 0.0025, "features_rest": 0.0025 / 20.0, "opacities": 0.025,
      "scales": 0.005, "quats": 0.001}
POSITION_LR = (0.00016, 0.0000016, 30_000)


def position_lr(step: int, extent: float) -> float:
    lr0, lr1, n = POSITION_LR
    t = min(max(step / n, 0.0), 1.0)
    return math.exp(math.log(lr0) * (1.0 - t) + math.log(lr1) * t) * extent


def gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-x * x / (2.0 * sigma * sigma))
    g = (g / g.sum()).to(torch.float32)
    return g[:, None] * g[None, :]


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (3, H, W) images (one 2D window convolution per
    moment)."""
    c = img1.shape[0]
    w = gaussian_window().to(img1.device).expand(c, 1, 11, 11).contiguous()

    def blur(x):
        return F.conv2d(x[None], w, padding=5, groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def loss_fn(image: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    d = image - gt
    l1 = torch.where(d >= 0, d, -d).mean()
    return (1.0 - LAMBDA_DSSIM) * l1 + LAMBDA_DSSIM * (1.0 - ssim(image, gt))


def step(state: Dict[str, torch.Tensor], cam: rr.Camera, gt: torch.Tensor, bg: torch.Tensor,
         extent: float) -> Dict[str, object]:
    """One training step on ``state`` (parameters, ``alive``, ``mu.*``,
    ``nu.*``, ``count``, ``step`` and the statistics), updated in place.
    Returns the loss, the image and inverse depth rendered, each
    parameter's gradient, the slot demand and the work of the blend."""
    alive = state["alive"]
    leaves = {k: state[k].detach().requires_grad_(True) for k in PARAM_NAMES}
    W, H = cam.width, cam.height
    with torch.enable_grad():
        geo = rr.project(*rr.activate(leaves, alive), cam, sh_degree=3)
    bins = rr.bin_instances(geo, W, H)
    with torch.no_grad():
        color, trans, invd, work = rr.blend(geo.fields.detach(), bins, W, H, count_work=True)
    color.requires_grad_(True)
    trans.requires_grad_(True)
    with torch.enable_grad():
        image = torch.clamp(color + trans[None] * bg[:, None, None], 0.0, 1.0)
        loss = loss_fn(image, gt)
        d_color, d_trans = torch.autograd.grad(loss, (color, trans))
    d_fields = rr.blend_backward(geo.fields, bins, W, H, d_color, d_trans,
                                 torch.zeros_like(invd))
    with torch.enable_grad():
        grads = torch.autograd.grad(geo.fields, list(leaves.values()), d_fields,
                                    allow_unused=True)
    with torch.no_grad():
        grads = {k: (torch.zeros_like(leaves[k]) if g is None else g)
                 * alive.reshape((-1,) + (1,) * (leaves[k].dim() - 1))
                 for k, g in zip(leaves, grads)}
        n = int(state["step"]) + 1
        count = int(state["count"]) + 1
        c1, c2 = 1.0 - B1**count, 1.0 - B2**count
        for k, g in grads.items():
            mu = B1 * state["mu." + k] + (1.0 - B1) * g
            nu = B2 * state["nu." + k] + (1.0 - B2) * g * g
            lr = position_lr(n, extent) if k == "means3d" else LR[k]
            state[k] -= lr * (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            state["mu." + k] = mu
            state["nu." + k] = nu
        tap = d_fields[:, :2] * torch.tensor([0.5 * W, 0.5 * H], device=d_fields.device)
        visible = geo.radii > 0
        state["xyz_grad_accum"] += torch.where(visible, torch.linalg.vector_norm(tap, dim=1), 0.0)
        state["denom"] += visible.to(torch.float32)
        state["max_radii2d"] = torch.maximum(state["max_radii2d"],
                                             geo.radii.to(torch.float32) * visible)
        state["step"] = state["step"] + 1
        state["count"] = state["count"] + 1
        image = image.detach()
    return {"loss": float(loss.detach()), "image": image, "invdepth": invd, "grads": grads,
            "demand": bins.demand, "work": work, "instances": int(bins.owner.numel())}
