"""Port parity: training images load as the JAX package's loader loads them.

JAX's ``load_camera`` decodes with its native host library and resizes with
that library's bilinear ``image_resize_bilinear_u8``; the port decodes with
PIL into the same channels and resizes with a copy of that C function
(``csrc/image_resize.cpp``, built with the same compiler flags).  The
loaded image and alpha mask must be equal bit for bit at ``-r`` 2, 4 and 8
and at ``-r -1`` on a 1700-wide and a 4946x3286 image (its factor-1.0625 and
factor-3.09 rescales), for RGB, RGBA, gray and gray+alpha PNGs, a JPEG,
palette and transparent-colour PNGs, and a 16-bit gray PNG (which JAX's
native decoder refuses and its PIL path reads)."""

import os

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu import native
from gaussian_splatting_tpu.data.cameras import CameraInfo as JaxCameraInfo
from gaussian_splatting_tpu.data.cameras import load_camera as jax_load_camera
from gaussian_splatting_torch.data.cameras import CameraInfo, load_camera
from gaussian_splatting_torch.utils.image import resize_bilinear_u8

W, H = 128, 96


def _pixels(rng, h, w, c):
    """A smooth gradient plus noise, so both flat and busy regions resize."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 255 // max(w - 1, 1) + yy * 128 // max(h - 1, 1))[..., None]
    noise = rng.integers(-40, 41, (h, w, c))
    return np.clip(base + noise + 60 * np.arange(c), 0, 255).astype(np.uint8)


def _save(tmp_path, name, mode, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / name)
    if mode == "I;16":
        im = Image.fromarray(_pixels(rng, h, w, 1)[..., 0].astype(np.uint16) * 257)
    else:
        c = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2, "P": 3}[mode]
        px = _pixels(rng, h, w, c)
        im = Image.fromarray(px[..., 0] if c == 1 else px, "RGB" if mode == "P" else mode)
        if mode == "P":
            im = im.quantize(64)
    kw = {"quality": 90} if name.endswith(".jpg") else {"compress_level": 1}
    im.save(path, **kw)
    return path


def _both(path, resolution, **kw):
    with Image.open(path) as im:
        w, h = im.size
    common = dict(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=0.9, fovy=0.7,
                  image_path=path, image_name=os.path.basename(path), width=w, height=h)
    j = jax_load_camera(JaxCameraInfo(**common), resolution=resolution, **kw)
    t = load_camera(CameraInfo(**common), resolution=resolution, device="cpu", **kw)
    return j, t


def _assert_same(j, t):
    assert (t.width, t.height) == (j.width, j.height)
    assert t.image.dtype == j.image.dtype and t.image.shape == j.image.shape
    np.testing.assert_array_equal(t.image, j.image)
    assert (t.alpha_mask is None) == (j.alpha_mask is None)
    if j.alpha_mask is not None:
        np.testing.assert_array_equal(t.alpha_mask, j.alpha_mask)


def test_jax_side_is_the_native_loader():
    assert native.available()


@pytest.mark.parametrize("resolution", [2, 4, 8, -1])
@pytest.mark.parametrize("name, mode", [("rgb.png", "RGB"), ("rgba.png", "RGBA"),
                                        ("gray.png", "L"), ("gray_alpha.png", "LA"),
                                        ("photo.jpg", "RGB")])
def test_load_camera_matches_jax(tmp_path, name, mode, resolution):
    j, t = _both(_save(tmp_path, name, mode), resolution)
    if resolution != -1:
        assert (t.width, t.height) == (W // resolution, H // resolution)
    _assert_same(j, t)


@pytest.mark.parametrize("form", ["palette", "palette_trns", "gray_trns", "rgb_trns",
                                  "gray16"])
def test_other_png_forms_match_jax(tmp_path, form):
    """Palette maps, a transparent colour (tRNS: alpha in both loaders) and
    16-bit gray (JAX's PIL path: PIL's resize, then RGB)."""
    mode = {"palette": "P", "palette_trns": "P", "gray_trns": "L", "rgb_trns": "RGB",
            "gray16": "I;16"}[form]
    path = _save(tmp_path, f"{form}.png", mode)
    if form.endswith("_trns"):
        with Image.open(path) as im:
            im.load()
            key = 5 if im.mode in ("P", "L") else tuple(int(v) for v in np.asarray(im)[0, 0])
            im.save(path, transparency=key)
    j, t = _both(path, 2, white_background=form == "rgb_trns")
    _assert_same(j, t)


@pytest.mark.parametrize("size", [(1700, 40), (4946, 3286)])
def test_auto_rescale_of_wide_images_matches_jax(tmp_path, size):
    """``-r -1`` caps the width at 1600: factor 1.0625 and 3.09125 (JPEGs,
    which encode and decode faster than PNGs at this size)."""
    w, h = size
    j, t = _both(_save(tmp_path, "wide.jpg", "RGB", h=h, w=w, seed=w), -1)
    assert t.width == 1600 and t.height == round(h / (w / 1600))
    _assert_same(j, t)


def test_resize_equals_native_and_why_a_transcription_does_not(capsys):
    """The copied C function equals JAX's native resize on a 1080p image shrunk
    to 1600x900; a numpy transcription of the same expression in float64
    differs only by one level, only where the interpolated value lies
    within 1e-9 of a half: where g++'s fused multiply-adds round the sum
    to the other side of .5."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    ours = resize_bilinear_u8(img, 900, 1600)
    np.testing.assert_array_equal(ours, native.resize_bilinear(img, 900, 1600))

    def taps(n_in, n_out):
        f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        i0 = np.floor(f)
        lo, hi = (np.clip(i, 0, n_in - 1).astype(int) for i in (i0, i0 + 1))
        return lo, hi, f - i0

    y0, y1, wy = taps(1080, 900)
    x0, x1, wx = taps(1920, 1600)
    wy, wx = wy[:, None, None], wx[None, :, None]
    p = [img[ys][:, xs].astype(np.float64) for ys in (y0, y1) for xs in (x0, x1)]
    v = (1 - wy) * ((1 - wx) * p[0] + wx * p[1]) + wy * ((1 - wx) * p[2] + wx * p[3])
    v = np.clip(v, 0.0, 255.0)
    plain = (np.floor(v) + (v - np.floor(v) >= 0.5)).astype(np.uint8)  # lround
    diff = plain != ours
    with capsys.disabled():
        print(f"\nnumpy transcription vs the C build: {int(diff.sum())} of {diff.size} "
              "values differ")
    assert (np.abs(plain[diff].astype(int) - ours[diff]) == 1).all()
    assert (np.abs(v[diff] - np.floor(v[diff]) - 0.5) < 1e-9).all()
