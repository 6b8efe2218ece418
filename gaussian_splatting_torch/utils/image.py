"""Image file I/O and image metrics.

PNG and the other formats go through PIL, which both this repository's
machines provide.  Resizing is PIL's BILINEAR, the resampling the JAX
package's loader uses.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without decoding the pixels."""
    from PIL import Image

    with Image.open(path) as im:
        return im.size


def read_image(path: str, size: Tuple[int, int] | None = None) -> np.ndarray:
    """Decode to (H, W, 3 or 4) uint8, resized to ``size`` = (w, h) if given.
    Alpha is kept (RGBA) when the file has one."""
    from PIL import Image

    with Image.open(path) as im:
        has_alpha = im.mode in ("RGBA", "LA")
        if size is not None and tuple(size) != im.size:
            im = im.resize(tuple(size), Image.BILINEAR)
        return np.asarray(im.convert("RGBA" if has_alpha else "RGB"))


def write_image(path: str, pixels: np.ndarray) -> None:
    """(H, W, 3 or 4) uint8 -> file (format from the extension)."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(pixels)).save(path)


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the JAX CLI writes PNGs."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB for images in [0, 1]."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))
