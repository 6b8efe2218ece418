"""Synthetic scenes for tests and chip runs.

``random_scene`` makes the same numpy draws, in the same order, as
``gaussian_splatting_tpu/utils/testing.py::random_scene``, so one seed gives
both packages the same Gaussians and camera.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.ops.camera_math import CameraParams, look_at, make_camera
from gaussian_splatting_torch.ops.sh import num_sh_coeffs, rgb_to_sh


class SyntheticScene(NamedTuple):
    means3d: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    cam: CameraParams
    bg: torch.Tensor


def random_arrays(
    num_gaussians: int,
    *,
    sh_degree: int = 0,
    seed: int = 0,
    spread: float = 1.0,
    scale_range=(0.01, 0.08),
):
    """Activated Gaussian parameters as float32 numpy arrays: (means,
    scales, unit quats, opacities, sh (P, K, 3))."""
    rng = np.random.default_rng(seed)
    P = num_gaussians
    means = rng.normal(0.0, spread / 2.0, (P, 3)).astype(np.float32)
    scales = np.exp(
        rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]), (P, 3))
    ).astype(np.float32)
    quats = rng.normal(0.0, 1.0, (P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, (P,)).astype(np.float32)
    K = num_sh_coeffs(sh_degree)
    sh = np.zeros((P, K, 3), np.float32)
    sh[:, 0, :] = rgb_to_sh(rng.uniform(0.0, 1.0, (P, 3))).astype(np.float32)
    if K > 1:
        sh[:, 1:, :] = rng.normal(0.0, 0.05, (P, K - 1, 3)).astype(np.float32)
    return means, scales, quats, opac, sh


def random_scene(
    num_gaussians: int = 1000,
    *,
    sh_degree: int = 0,
    width: int = 256,
    height: int = 256,
    seed: int = 0,
    spread: float = 1.0,
    scale_range=(0.01, 0.08),
    cam_distance: float = 4.0,
    bg=(0.0, 0.0, 0.0),
    device=None,
) -> SyntheticScene:
    """Random Gaussians in a ball around the origin, camera looking at it."""
    dev = resolve_device(device)
    arrays = random_arrays(
        num_gaussians, sh_degree=sh_degree, seed=seed, spread=spread,
        scale_range=scale_range,
    )
    R, t = look_at([0.3, -0.2, -cam_distance], [0.0, 0.0, 0.0])
    cam = make_camera(
        R, t, fovx=0.9, fovy=0.9 * height / width, width=width, height=height,
        device=dev,
    )
    means, scales, quats, opac, sh = (torch.from_numpy(a).to(dev) for a in arrays)
    return SyntheticScene(
        means3d=means, scales=scales, quats=quats, opacities=opac, sh=sh,
        cam=cam, bg=torch.tensor(bg, dtype=torch.float32, device=dev),
    )
