"""Runtime cameras: image loading, the resolution policy, training masks.

Counterpart of ``gaussian_splatting_tpu/data/cameras.py``.  ``-1`` caps the
long side at 1600 px (with a one-time notice), {1, 2, 4, 8} divide, other
values are a target width, all of the decoded image's size.  The pixels
are the JAX loader's, bit for bit: its native decoder's channels and its
bilinear resize (``_load_pixels``).  Pixels and masks stay host numpy; the
camera matrices go to the requested device.  RGBA images keep their alpha as
the training mask unless ``white_background`` composites it away, and
``train_test_exp`` masks the left half of test views.  A camera whose info
names a depth PNG gets ``invdepth`` and ``depth_mask`` as the JAX loader
makes them (``read_depth_png``); otherwise both are ``None``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from gaussian_splatting_torch.ops.camera_math import CameraParams, make_camera
from gaussian_splatting_torch.utils.image import native_pixels, resize_bilinear_u8

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
    depth_path: str = ""
    depth_params: Optional[dict] = None
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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types (IHDR byte 25)
_GRAY, _RGB, _PALETTE, _GRAY_ALPHA, _RGBA = 0, 2, 3, 4, 6


def read_depth_png(path: str) -> np.ndarray:
    """A depth PNG as (H, W) float32: the values of its first channel in
    OpenCV's order, which the JAX loader takes (``cv2.imread(path,
    IMREAD_UNCHANGED)[..., 0]``).  OpenCV orders colour as BGR(A), so on a
    colour map that is the blue channel; on a palette map, the blue of each
    entry.  Gray maps keep their 8- or 16-bit values unchanged (a 1-bit map
    reads as 0 / 255).  Forms PIL cannot give the same values for (16-bit
    colour or gray-alpha, 2- and 4-bit gray) raise."""
    from PIL import Image

    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"depth map {path}: not a PNG file")
    bits, ctype = head[24], head[25]
    if ctype == _GRAY and bits in (2, 4):
        raise ValueError(f"depth map {path}: {bits}-bit grayscale PNGs are not supported")
    if ctype in (_RGB, _GRAY_ALPHA, _RGBA) and bits != 8:
        kind = {_RGB: "RGB", _GRAY_ALPHA: "gray+alpha", _RGBA: "RGBA"}[ctype]
        raise ValueError(f"depth map {path}: {bits}-bit {kind} PNGs are not supported "
                         "(PIL reads them at 8 bits)")
    with Image.open(path) as im:
        if ctype == _GRAY:
            arr = np.asarray(im.convert("L") if bits == 1 else im)
        elif ctype == _GRAY_ALPHA:
            arr = np.asarray(im)[..., 0]
        else:  # RGB, RGBA, palette: OpenCV's channel 0 is blue
            arr = np.asarray(im.convert("RGB"))[..., 2]
    return arr.astype(np.float32)


def _load_depth(info: CameraInfo, w: int, h: int, is_synthetic: bool):
    """(invdepth, depth_mask) at (h, w), as JAX's ``load_camera``: the map
    over 512 (synthetic scenes) or 65536, resized NEAREST in PIL's mode F,
    a mask of ones, zeroed when the view's depth-scale fit is off by more
    than 5x from the median; the fit's scale and offset applied."""
    from PIL import Image

    raw = read_depth_png(info.depth_path) / (512.0 if is_synthetic else 65536.0)
    raw = np.array(Image.fromarray(raw).resize((w, h), Image.NEAREST), np.float32)
    depth_mask = np.ones((h, w), np.float32)
    dp = info.depth_params
    if dp is not None:
        scale, med = dp.get("scale", 0), dp.get("med_scale", 1.0)
        if scale < 0.2 * med or scale > 5 * med:
            depth_mask *= 0.0  # unreliable fit
        if scale > 0:
            raw = raw * dp["scale"] + dp["offset"]
    return raw, depth_mask


def _load_pixels(path: str, resolution: int, resolution_scale: float) -> np.ndarray:
    """(h, w, 3 or 4) uint8 at the resolved size, as JAX's loader makes them:
    ``native_pixels`` resized by ``resize_bilinear_u8`` when the size
    changes; for modes its native decoder refuses, its PIL path (PIL's
    bilinear resize, then RGB)."""
    from PIL import Image

    with Image.open(path) as im:
        pixels = native_pixels(im)
        if pixels is None:
            w, h = _resolve_size(im.width, im.height, resolution, resolution_scale)
            return np.asarray(im.resize((w, h), Image.BILINEAR).convert("RGB"))
    ih, iw = pixels.shape[:2]
    w, h = _resolve_size(iw, ih, resolution, resolution_scale)
    return pixels if (w, h) == (iw, ih) else resize_bilinear_u8(pixels, h, w)


def load_camera(
    info: CameraInfo,
    *,
    resolution: int = -1,
    resolution_scale: float = 1.0,
    white_background: bool = False,
    train_test_exp: bool = False,
    is_synthetic: bool = False,
    exposure_idx: int = 0,
    device=None,
) -> Camera:
    arr = _load_pixels(info.image_path, resolution, resolution_scale).astype(np.float32) / 255.0
    h, w = arr.shape[:2]
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
    invdepth = depth_mask = None
    if info.depth_path:
        invdepth, depth_mask = _load_depth(info, w, h, is_synthetic)
    cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h, device=device)
    return Camera(info=info, cam=cam, image=np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                  alpha_mask=alpha, invdepth=invdepth, depth_mask=depth_mask,
                  exposure_idx=exposure_idx)


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
