"""Port parity: transforms, SH (degrees 0-4) and camera math against the JAX
package, on the same numpy inputs.  Tolerance 1e-6 (float32 rounding of
the same expressions); SH gradients within 3e-4 of ``jax.grad``'s, scaled;
camera matrices, built in numpy by both, are equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import camera_math as jcm
from gaussian_splatting_tpu.ops import sh as jsh
from gaussian_splatting_tpu.ops import transforms as jtf
from gaussian_splatting_torch.ops import camera_math as tcm
from gaussian_splatting_torch.ops import sh as tsh
from gaussian_splatting_torch.ops import transforms as ttf

ATOL = 1e-6


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=atol)


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q


@pytest.mark.parametrize(
    "name",
    ["normalize_quat", "quat_to_rotmat", "build_covariance", "build_scaling_rotation"],
)
def test_transforms_match_jax(name):
    rng = np.random.default_rng(1)
    q = _quats(rng)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    if name == "normalize_quat":
        _close(ttf.normalize_quat(torch.from_numpy(q)), jtf.normalize_quat(jnp.asarray(q)))
    elif name == "quat_to_rotmat":
        _close(ttf.quat_to_rotmat(torch.from_numpy(qn)), jtf.quat_to_rotmat(jnp.asarray(qn)))
    elif name == "build_covariance":
        for mod in (1.0, 0.7):
            _close(
                ttf.build_covariance(torch.from_numpy(s), torch.from_numpy(qn), mod),
                jtf.build_covariance(jnp.asarray(s), jnp.asarray(qn), mod),
            )
    else:
        _close(
            ttf.build_scaling_rotation(torch.from_numpy(s), torch.from_numpy(qn)),
            jtf.build_scaling_rotation(jnp.asarray(s), jnp.asarray(qn)),
        )


def test_affine_matches_jax():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(4, 4)).astype(np.float32)
    p = rng.normal(size=(50, 3)).astype(np.float32)
    _close(ttf.apply_affine(torch.from_numpy(M), torch.from_numpy(p)),
           jtf.apply_affine(jnp.asarray(M), jnp.asarray(p)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(10 + deg)
    K = (deg + 1) ** 2
    sh = rng.normal(0, 0.5, (80, K, 3)).astype(np.float32)
    means = rng.normal(size=(80, 3)).astype(np.float32)
    campos = np.array([0.3, -0.2, -4.0], np.float32)
    dirs = means - campos
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(tsh.eval_sh(deg, torch.from_numpy(sh), torch.from_numpy(dirs)),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)))
    col_t = tsh.sh_to_color(deg, torch.from_numpy(sh), torch.from_numpy(means),
                            torch.from_numpy(campos))
    col_j = jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos))
    _close(col_t, col_j)
    assert float(col_t.min()) >= 0.0  # the +0.5 shift then clamp at 0
    rgb = rng.uniform(0, 1, (5, 3)).astype(np.float32)
    _close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    _close(tsh.sh_to_rgb(torch.from_numpy(sh[:, 0])), jsh.sh_to_rgb(jnp.asarray(sh[:, 0])))

    # gradients of a weighted sum with respect to the coefficients and the
    # directions, against jax.grad
    w = rng.normal(size=(80, 3)).astype(np.float32)
    sh_t = torch.from_numpy(sh).requires_grad_(True)
    dirs_t = torch.from_numpy(dirs).requires_grad_(True)
    got = torch.autograd.grad((tsh.eval_sh(deg, sh_t, dirs_t) * torch.from_numpy(w)).sum(),
                              (sh_t, dirs_t), allow_unused=True)  # degree 0: no dirs
    want = jax.grad(lambda a, d: (jsh.eval_sh(deg, a, d) * w).sum(), argnums=(0, 1))(
        jnp.asarray(sh), jnp.asarray(dirs))
    for g_t, g_j, x in zip(got, want, (sh_t, dirs_t)):
        g_t = torch.zeros_like(x) if g_t is None else g_t
        g_j = np.asarray(g_j)
        scale = np.abs(g_j).max() + 1e-12
        assert np.abs(g_t.numpy() - g_j).max() <= 3e-4 * scale


@pytest.mark.parametrize("translate,scale", [(None, 1.0), ((0.5, -0.2, 1.0), 1.5)])
def test_camera_matrices_match_jax(translate, scale):
    R, t = tcm.look_at([0.3, -0.2, -4.0], [0.0, 0.1, 0.0])
    Rj, tj = jcm.look_at([0.3, -0.2, -4.0], [0.0, 0.1, 0.0])
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(
        tcm.world_to_view(R, t, translate, scale), jcm.world_to_view(R, t, translate, scale)
    )
    np.testing.assert_array_equal(tcm.projection_matrix(0.9, 0.6), jcm.projection_matrix(0.9, 0.6))
    ct = tcm.make_camera(R, t, 0.9, 0.6, 64, 48, translate, scale, device="cpu")
    cj = jcm.make_camera(R, t, 0.9, 0.6, 64, 48, translate, scale)
    for f in ("viewmatrix", "projmatrix", "campos"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)))
    for f in ("tan_fovx", "tan_fovy", "width", "height", "focal_x", "focal_y"):
        assert getattr(ct, f) == getattr(cj, f)


def test_fov_focal_and_ndc_match_jax():
    for focal, px in ((500.0, 640), (1111.1, 1920)):
        assert tcm.focal_to_fov(focal, px) == jcm.focal_to_fov(focal, px)
        fov = tcm.focal_to_fov(focal, px)
        assert tcm.fov_to_focal(fov, px) == jcm.fov_to_focal(fov, px)
        assert math.isclose(tcm.fov_to_focal(fov, px), focal, rel_tol=1e-12)
    v = np.linspace(-1.2, 1.2, 11).astype(np.float32)
    _close(tcm.ndc_to_pixel(torch.from_numpy(v), 50), jcm.ndc_to_pixel(jnp.asarray(v), 50))


def test_cameras_default_to_the_card():
    R, t = tcm.look_at([0.0, 0.0, -4.0], [0.0, 0.0, 0.0])
    if torch.cuda.is_available():
        assert tcm.make_camera(R, t, 0.9, 0.6, 8, 8).viewmatrix.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcm.make_camera(R, t, 0.9, 0.6, 8, 8)
