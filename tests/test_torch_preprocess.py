"""Port parity: every ``ProjectedGaussians`` field against the JAX package's
preprocess on the same numpy inputs.  Integer and boolean fields (radii,
rects, tile counts, span tables, span flag, valid) match bit for bit; float
fields within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import camera_math as jcm
from gaussian_splatting_tpu.ops.preprocess import preprocess as jax_preprocess
from gaussian_splatting_torch.ops import camera_math as tcm
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians, preprocess
from gaussian_splatting_torch.ops.transforms import build_covariance
from gaussian_splatting_torch.utils.testing import random_arrays

EXACT = ("radii", "rect_min", "rect_max", "tiles_touched", "valid",
         "span_x0", "span_cum", "span_flag")
RTOL = 1e-5


def _inputs(n, sh_degree, seed, big=0):
    """numpy scene; ``big`` large Gaussians on the line from the origin to
    the camera (the last ones behind it) cover many tiles, so with small
    tiles their rects are taller than 16 rows (full-rect expansion)."""
    arrs = list(random_arrays(n, sh_degree=sh_degree, seed=seed, spread=1.5,
                              scale_range=(0.01, 0.08)))
    if big:
        s = np.linspace(0.2, 1.1, big)[:, None]
        arrs[0][:big] = s * np.array([0.3, -0.2, -4.0], np.float32)
        arrs[1][:big] = 0.15
    return arrs


def _cams(width, height):
    R, t = tcm.look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    fovy = 0.9 * height / width
    return (tcm.make_camera(R, t, 0.9, fovy, width, height, device="cpu"),
            jcm.make_camera(R, t, 0.9, fovy, width, height))


def check_projection(tp: ProjectedGaussians, jp):
    for f in ProjectedGaussians._fields:
        t = getattr(tp, f).numpy()
        j = np.asarray(getattr(jp, f))
        if f in EXACT:
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=f)
        else:
            scale = np.maximum(np.abs(j), 1e-3)
            assert np.all(np.abs(t - j) <= RTOL * scale), f


@pytest.mark.parametrize(
    "sh_degree,antialiasing,size,tile",
    [(0, False, (64, 48), 16), (1, True, (50, 35), 16), (2, False, (128, 96), 4),
     (3, True, (128, 96), 16), (4, True, (128, 96), 16)],
)
def test_preprocess_matches_jax(sh_degree, antialiasing, size, tile):
    arrs = _inputs(600, sh_degree, seed=sh_degree, big=12)
    tcam, jcam = _cams(*size)
    kw = dict(sh_degree=sh_degree, antialiasing=antialiasing, tile_w=tile, tile_h=tile)
    tp = preprocess(*(torch.from_numpy(a) for a in arrs), tcam, **kw)
    jp = jax_preprocess(*(jnp.asarray(a) for a in arrs), jcam, **kw)
    check_projection(tp, jp)
    # the scene covers span expansion and culling; with 4-pixel tiles also
    # full-rect expansion
    assert bool(tp.span_flag.any()) and bool((~tp.valid).any())
    if tile == 4:
        assert bool((tp.valid & ~tp.span_flag).any())


def test_preprocess_precomp_and_scale_modifier_match_jax():
    arrs = _inputs(400, 2, seed=9)
    tcam, jcam = _cams(64, 48)
    t_in = [torch.from_numpy(a) for a in arrs]
    cov = build_covariance(t_in[1], t_in[2], 0.8)
    tp = preprocess(*t_in, tcam, sh_degree=2, cov3d_precomp=cov)
    jp = jax_preprocess(*(jnp.asarray(a) for a in arrs), jcam, sh_degree=2,
                        scale_modifier=0.8)
    check_projection(tp, jp)
