"""Image file I/O and image metrics.

PNG, JPEG and the other formats are decoded by PIL, which both this
repository's machines provide, into the channels the JAX package's native
decoder gives (``native_pixels``).  Training images are resized as that
package's loader resizes them, by a copy of its C function
(``resize_bilinear_u8``, ``csrc/image_resize.cpp``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

# The channels the JAX package's native decoder gives each PIL mode it reads:
# gray repeated to RGB, gray+alpha to RGBA (its loader expands both), palette
# to RGB.  Modes missing here (16-bit gray, CMYK, ...) it refuses, and its
# loader reads them through PIL instead.
_NATIVE_MODES = {"1": "RGB", "L": "RGB", "LA": "RGBA", "P": "RGB", "PA": "RGBA",
                 "RGB": "RGB", "RGBA": "RGBA"}


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without decoding the pixels."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def native_pixels(im) -> Optional[np.ndarray]:
    """An open PIL image as (H, W, 3 or 4) uint8, the pixels the JAX
    package's loader takes from its native decoder: an alpha channel, or a
    PNG's transparent colour (tRNS) as alpha, gives RGBA.  None for the modes
    that decoder refuses."""
    mode = _NATIVE_MODES.get(im.mode)
    if mode is None:
        return None
    if "transparency" in im.info:
        mode = "RGBA"
    return np.asarray(im if im.mode == mode else im.convert(mode))


def read_image(path: str) -> np.ndarray:
    """Decode to (H, W, 3 or 4) uint8 as ``native_pixels`` does; other modes
    as RGB."""
    from PIL import Image

    with Image.open(path) as im:
        pixels = native_pixels(im)
        return np.asarray(im.convert("RGB")) if pixels is None else pixels


def resize_bilinear_u8(img_u8_hwc: np.ndarray, height: int, width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, bit for bit as the JAX
    package's loader resizes a training image: two taps a side,
    ``align_corners=False``, in double, rounded half away from zero."""
    from gaussian_splatting_torch import _kernels

    img = np.ascontiguousarray(img_u8_hwc)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bilinear_u8: expected (H, W, C) uint8, got {img.dtype} "
                         f"{img.shape}")
    out = np.empty((height, width, img.shape[2]), np.uint8)
    fn = _kernels.host_library("image_resize").image_resize_bilinear_u8
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p, ll, ll, ll, ctypes.c_void_p, ll, ll]
    fn.restype = ctypes.c_int
    if fn(img.ctypes.data, *img.shape, out.ctypes.data, height, width) != 0:
        raise ValueError(f"resize_bilinear_u8: cannot resize {img.shape} to {(height, width)}")
    return out


def write_image(path: str, pixels: np.ndarray) -> None:
    """(H, W, 3 or 4) uint8 -> file (format from the extension)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(pixels)).save(path)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the JAX CLI writes PNGs."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean squared error over every value."""
    return torch.mean((img1 - img2) ** 2)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for images in [0, 1]."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))
