"""Runtime cameras: image loading and the resolution policy.

Counterpart of ``gaussian_splatting_tpu/data/cameras.py``.  ``-1`` caps the
long side at 1600 px (with a one-time notice), {1, 2, 4, 8} divide, other
values are a target width.  Pixels stay host numpy; the camera matrices go
to the requested device.  Depth maps, alpha masks and exposure indices serve
training and come with it.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    white_background: bool = False,
    device=None,
) -> Camera:
    w, h = _resolve_size(info.width, info.height, resolution)
    arr = read_image(info.image_path, size=(w, h)).astype(np.float32) / 255.0
    rgb = arr[..., :3]
    if arr.shape[2] == 4 and white_background:
        alpha = arr[..., 3:]
        rgb = rgb * alpha + (1.0 - alpha)
    cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h, device=device)
    return Camera(info=info, cam=cam, image=np.ascontiguousarray(rgb.transpose(2, 0, 1)))
