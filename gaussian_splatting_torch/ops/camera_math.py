"""Camera matrices with the reference's conventions.

Counterpart of ``gaussian_splatting_tpu/ops/camera_math.py``: column-vector
matrices (``p_cam = V @ p_world``), the OpenGL-style projection with
z_sign = +1, znear 0.01 / zfar 100, and NDC -> pixel ``((v + 1) S - 1) / 2``.
Matrices are built in numpy (float64, then float32) exactly as the JAX
package builds them, and only then become tensors on the chosen device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device

Z_NEAR = 0.01
Z_FAR = 100.0


def focal_to_fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def fov_to_focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=None, scale: float = 1.0) -> np.ndarray:
    """4x4 world -> camera matrix from the reader's cam-to-world ``R`` and
    world-to-cam ``t`` (``getWorld2View2``, column-vector form)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else np.asarray(translate)
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def projection_matrix(fovx: float, fovy: float, znear: float = Z_NEAR, zfar: float = Z_FAR) -> np.ndarray:
    tan_y = math.tan(fovy / 2.0)
    tan_x = math.tan(fovx / 2.0)
    top = tan_y * znear
    bottom = -top
    right = tan_x * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """What the rasterizer needs of a camera: tensors plus plain numbers."""

    viewmatrix: torch.Tensor  # (4, 4) world -> camera
    projmatrix: torch.Tensor  # (4, 4) full projection P @ V
    campos: torch.Tensor  # (3,) camera centre in world space
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    translate=None,
    scale: float = 1.0,
    *,
    device=None,
) -> CameraParams:
    dev = resolve_device(device)
    V = world_to_view(R, t, translate, scale)
    P = projection_matrix(fovx, fovy)
    full = (P @ V).astype(np.float32)
    cam_center = np.linalg.inv(V)[:3, 3].astype(np.float32)
    return CameraParams(
        viewmatrix=torch.from_numpy(V).to(dev),
        projmatrix=torch.from_numpy(full).to(dev),
        campos=torch.from_numpy(cam_center).to(dev),
        tan_fovx=float(math.tan(fovx / 2.0)),
        tan_fovy=float(math.tan(fovy / 2.0)),
        width=int(width),
        height=int(height),
    )


def ndc_to_pixel(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) in the reader convention, looking from ``eye`` at ``target``
    with +z forward (COLMAP convention)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    upv = np.asarray(up, dtype=np.float64)
    right = np.cross(upv, fwd)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    R_wc = np.stack([right, down, fwd], axis=0)
    t = -R_wc @ eye
    return R_wc.T, t
