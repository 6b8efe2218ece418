"""Port parity: ``render(inference=True)`` against the JAX package's render.

Image, inverse depth and final T within 2e-4; radii and visibility exact.
One configuration (SH degree 3 at the non-tile-aligned 50x35, with dead
slots) is held against JAX ``render(impl="pallas")`` in interpret mode; the
rest against JAX ``render_dense``, which runs the same preprocess.  The models
come from numpy through ``model_from_jax_params``, as a JAX-trained model
would."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.config import RasterizeConfig as JaxConfig
from gaussian_splatting_tpu.ops import camera_math as jcm
from gaussian_splatting_tpu.ops.rasterize import render as jax_render
from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.interop import model_from_jax_params
from gaussian_splatting_torch.ops import camera_math as tcm
from gaussian_splatting_torch.ops.rasterize import _render, render
from gaussian_splatting_torch.utils.testing import random_arrays

ATOL = 2e-4


def _model_inputs(n, sh_degree, seed, dead=0):
    """Pre-activation numpy params for n Gaussians + ``dead`` dead slots (the
    JAX package's empty values), and the alive mask."""
    means, scales, quats, opac, sh = random_arrays(
        n, sh_degree=sh_degree, seed=seed, scale_range=(0.01, 0.06))
    pad = lambda a, v: np.concatenate([a, np.full((dead,) + a.shape[1:], v, a.dtype)])
    params = dict(
        means3d=pad(means, 0.0), features_dc=pad(sh[:, :1], 0.0),
        features_rest=pad(sh[:, 1:], 0.0),
        opacities=pad(np.log(opac / (1 - opac)), -10.0), scales=pad(np.log(scales), 0.0),
        quats=np.concatenate([quats, np.tile(np.float32([[1, 0, 0, 0]]), (dead, 1))]),
    )
    alive = np.arange(n + dead) < n
    return params, alive


def _jax_activated(params, alive):
    import jax

    sh = jnp.concatenate([params["features_dc"], params["features_rest"]], axis=1)
    q = jnp.asarray(params["quats"])
    return (
        jnp.asarray(params["means3d"]), jnp.exp(params["scales"]),
        q / jnp.linalg.norm(q, axis=-1, keepdims=True),
        jax.nn.sigmoid(params["opacities"]) * alive, sh,
    )


def _cameras(width, height):
    R, t = tcm.look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    fovy = 0.9 * height / width
    return (tcm.make_camera(R, t, 0.9, fovy, width, height, device="cpu"),
            jcm.make_camera(R, t, 0.9, fovy, width, height))


def _both(n, sh_degree, size, jax_impl, seed=0, bg=(0.0, 0.0, 0.0), dead=0, **cfg):
    params, alive = _model_inputs(n, sh_degree, seed, dead)
    model = model_from_jax_params(params, alive, max_sh_degree=sh_degree,
                                  sh_degree=sh_degree, device="cpu")
    tcam, jcam = _cameras(*size)
    tout = render(*model.activated_params(), tcam, torch.tensor(bg), sh_degree=sh_degree,
                  cfg=RasterizeConfig(**cfg), inference=True)
    jout = jax_render(*_jax_activated(params, alive), jcam, jnp.asarray(bg, jnp.float32),
                      sh_degree=sh_degree, cfg=JaxConfig(**cfg), impl=jax_impl,
                      inference=True)
    return tout, jout


def _check(tout, jout):
    for name in ("image", "invdepth", "final_T"):
        np.testing.assert_allclose(getattr(tout, name).numpy(), np.asarray(getattr(jout, name)),
                                   atol=ATOL, err_msg=name)
    np.testing.assert_array_equal(tout.radii.numpy(), np.asarray(jout.radii))
    np.testing.assert_array_equal(tout.visibility.numpy(), np.asarray(jout.visibility))
    assert not bool(tout.overflow)
    assert float(tout.image.sum()) > 1.0


def test_render_matches_jax_pallas():
    tout, jout = _both(200, 3, (50, 35), "pallas", seed=3, dead=40)
    assert tout.image.shape == (3, 35, 50)
    _check(tout, jout)
    assert int(tout.num_instances) == int(jout.num_instances)


@pytest.mark.parametrize(
    "sh_degree,antialiasing",
    [(0, True), (0, False), (1, False), (2, True), (3, False), (3, True)],
)
def test_render_matches_jax_dense(sh_degree, antialiasing):
    tout, jout = _both(300, sh_degree, (64, 48), "dense", seed=10 + sh_degree,
                       antialiasing=antialiasing)
    _check(tout, jout)


def test_background_compositing_matches_jax():
    bg = (0.1, 0.7, 0.3)
    tout, jout = _both(300, 0, (64, 48), "dense", seed=3, bg=bg)
    _check(tout, jout)
    empty = tout.final_T.numpy() > 0.999
    assert empty.any()
    np.testing.assert_allclose(tout.image.numpy()[:, empty],
                               np.broadcast_to(np.float32(bg)[:, None], (3, int(empty.sum()))),
                               atol=1e-5)


def test_precomp_flags_match_fused_path():
    params, alive = _model_inputs(300, 2, seed=21)
    model = model_from_jax_params(params, alive, max_sh_degree=2, sh_degree=2, device="cpu")
    tcam, _ = _cameras(64, 48)
    args = (*model.activated_params(), tcam, torch.zeros(3))
    base = render(*args, sh_degree=2, inference=True, scale_modifier=0.9)
    for flags in ({"convert_SHs_python": True}, {"compute_cov3D_python": True},
                  {"convert_SHs_python": True, "compute_cov3D_python": True}):
        out = render(*args, sh_degree=2, cfg=RasterizeConfig(**flags), inference=True,
                     scale_modifier=0.9)
        np.testing.assert_allclose(out.image.numpy(), base.image.numpy(), atol=1e-6,
                                   err_msg=str(flags))


def test_plain_and_dense_impls_agree_with_kernel_path():
    params, alive = _model_inputs(300, 1, seed=5)
    model = model_from_jax_params(params, alive, max_sh_degree=1, sh_degree=1, device="cpu")
    tcam, _ = _cameras(64, 48)
    args = (*model.activated_params(), tcam, torch.zeros(3))
    fast = render(*args, sh_degree=1, inference=True)
    plain = _render(*args, sh_degree=1, kernels=False)
    dense = render(*args, sh_degree=1, impl="dense", inference=True)
    assert torch.equal(fast.image, plain.image)  # on the CPU both run the twins
    np.testing.assert_allclose(fast.image.numpy(), dense.image.numpy(), atol=ATOL)
    # the JAX config's "jax" names the tiled path too
    assert torch.equal(render(*args, sh_degree=1, impl="jax", inference=True).image,
                       fast.image)
    with pytest.raises(ValueError, match="unknown rasterizer impl"):
        render(*args, sh_degree=1, impl="plain", inference=True)


def test_capacity_overflow_flag():
    params, alive = _model_inputs(500, 0, seed=6)
    model = model_from_jax_params(params, alive, max_sh_degree=0, sh_degree=0, device="cpu")
    tcam, _ = _cameras(64, 64)
    out = render(*model.activated_params(), tcam, torch.zeros(3), sh_degree=0,
                 capacity=256, inference=True)
    assert bool(out.overflow)
    assert int(out.num_instances) == 512  # capacity rounds up to the 512 chunk


def test_training_path_raises():
    """The training path (``inference=False``) renders with a graph and
    backpropagates; an inference render carries no graph, so a backward
    through it raises."""
    params, alive = _model_inputs(20, 0, seed=7)
    model = model_from_jax_params(params, alive, max_sh_degree=0, sh_degree=0, device="cpu")
    tcam, _ = _cameras(32, 32)
    out = render(*model.activated_params(), tcam, torch.zeros(3), sh_degree=0, inference=True)
    with pytest.raises(RuntimeError, match="does not require grad"):
        out.image.sum().backward()
    out = render(*model.activated_params(), tcam, torch.zeros(3), sh_degree=0)
    out.image.sum().backward()
    assert model.opacities.grad is not None and bool(model.opacities.grad.any())
    with torch.no_grad():  # nothing requires grad: the forward runs
        out = render(*model.activated_params(), tcam, torch.zeros(3), sh_degree=0)
    assert out.image.shape == (3, 32, 32)


def test_active_sh_degree_masks_higher_bands():
    params, alive = _model_inputs(100, 3, seed=8)
    full = model_from_jax_params(params, alive, max_sh_degree=3, sh_degree=3, device="cpu")
    low = model_from_jax_params(params, alive, max_sh_degree=3, sh_degree=1, device="cpu")
    sh_low = low.activated_params()[4]
    assert torch.equal(sh_low[:, :4], full.activated_params()[4][:, :4])
    assert not bool(sh_low[:, 4:].any())
