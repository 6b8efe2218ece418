"""Runtime cameras: image loading, the resolution policy, training masks.

Counterpart of ``gaussian_splatting_tpu/data/cameras.py``.  ``-1`` caps the
long side at 1600 px (with a one-time notice), {1, 2, 4, 8} divide, other
values are a target width.  Pixels and masks stay host numpy; the camera
matrices go to the requested device.  RGBA images keep their alpha as the
training mask unless ``white_background`` composites it away, and
``train_test_exp`` masks the left half of test views.  Depth maps come with
the COLMAP reader (a later slice), so ``invdepth`` and ``depth_mask`` are
``None``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from gaussian_splatting_torch.ops.camera_math import CameraParams, make_camera
from gaussian_splatting_torch.utils.image import read_image

_warned_big = [False]


@dataclass
class CameraInfo:
    """Static description parsed from a dataset."""

    uid: int
    R: np.ndarray  # cam-to-world rotation (reader storage convention)
    T: np.ndarray  # world-to-cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    is_test: bool = False


@dataclass
class Camera:
    """A loaded camera: matrices on the device + pixels on the host."""

    info: CameraInfo
    cam: CameraParams
    image: np.ndarray  # (3, H, W) float32 in [0, 1]
    alpha_mask: Optional[np.ndarray] = None  # (H, W) float32
    invdepth: Optional[np.ndarray] = None  # (H, W) float32
    depth_mask: Optional[np.ndarray] = None  # (H, W) float32
    exposure_idx: int = 0

    @property
    def image_name(self) -> str:
        return self.info.image_name

    @property
    def width(self) -> int:
        return self.cam.width

    @property
    def height(self) -> int:
        return self.cam.height


def _resolve_size(width: int, height: int, resolution: int, resolution_scale: float = 1.0):
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
    elif resolution == -1:
        if width > 1600:
            if not _warned_big[0]:
                print(
                    "[ INFO ] Encountered quite large input images (>1.6K pixels "
                    "width), rescaling to 1.6K.\n If this is not desired, please "
                    "explicitly specify '--resolution/-r' as 1"
                )
                _warned_big[0] = True
            scale = resolution_scale * width / 1600
        else:
            scale = resolution_scale
    else:
        scale = resolution_scale * width / resolution
    return round(width / scale), round(height / scale)


def load_camera(
    info: CameraInfo,
    *,
    resolution: int = -1,
    resolution_scale: float = 1.0,
    white_background: bool = False,
    train_test_exp: bool = False,
    exposure_idx: int = 0,
    device=None,
) -> Camera:
    w, h = _resolve_size(info.width, info.height, resolution, resolution_scale)
    arr = read_image(info.image_path, size=(w, h)).astype(np.float32) / 255.0
    rgb = arr[..., :3]
    alpha = None
    if arr.shape[2] == 4:
        alpha = arr[..., 3]
        if white_background:  # Blender alpha composite
            rgb = rgb * alpha[..., None] + (1.0 - alpha[..., None])
            alpha = None
    if train_test_exp and info.is_test:  # train on the right half only
        alpha = np.ones((h, w), np.float32) if alpha is None else alpha.copy()
        alpha[:, : w // 2] = 0.0
    cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h, device=device)
    return Camera(info=info, cam=cam, image=np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                  alpha_mask=alpha, exposure_idx=exposure_idx)


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """One ``cameras.json`` entry (the viewers' camera format)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.T
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": info.height / (2 * math.tan(info.fovy / 2)),
        "fx": info.width / (2 * math.tan(info.fovx / 2)),
    }
