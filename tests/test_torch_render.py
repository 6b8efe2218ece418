"""Port parity: ``render(inference=True)`` against the JAX package's render.

Image, inverse depth and final T within 2e-4; radii and visibility exact.
One configuration (SH degree 3 at the non-tile-aligned 50x35, with dead
slots) is held against JAX ``render(impl="pallas")`` in interpret mode; the
rest against JAX ``render_dense``, which runs the same preprocess.  The models
come from numpy through ``model_from_jax_params``, as a JAX-trained model
would."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.config import RasterizeConfig as JaxConfig
from gaussian_splatting_tpu.ops import camera_math as jcm
from gaussian_splatting_tpu.ops.rasterize import render as jax_render
from gaussian_splatting_torch import _kernels
from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.interop import model_from_jax_params
from gaussian_splatting_torch.ops import camera_math as tcm
from gaussian_splatting_torch.ops import project as pj
from gaussian_splatting_torch.ops.instances import ProjectedTable, build_table
from gaussian_splatting_torch.ops.rasterize import (
    _render, blend_fields, project, render, render_stored,
)
from gaussian_splatting_torch.render import render_camera
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


@pytest.mark.parametrize("route", ["inference", "under_grad", "compute_cov3D_python",
                                   "convert_SHs_python"])
def test_stored_tensors_take_the_fused_stage_only_without_grad_or_hooks(route):
    """``project`` of a model's stored tensors: the fused stage's
    ``ProjectedTable`` in an inference render, the plain ``preprocess``
    under grad or with a debug hook; equal to the plain chain either way,
    and no kernel launch on the CPU."""
    params, alive = _model_inputs(200, 2, seed=23, dead=20)
    model = model_from_jax_params(params, alive, max_sh_degree=2, sh_degree=1, device="cpu")
    tcam, _ = _cameras(50, 35)
    cfg = RasterizeConfig(**({route: True} if route.endswith("_python") else {}))
    before = dict(_kernels.launches)
    with torch.set_grad_enabled(route == "under_grad"):
        proj = project(model.stored(), tcam, sh_degree=2, cfg=cfg, scale_modifier=0.9)
    with torch.no_grad():
        plain = project(model.activated_params(), tcam, sh_degree=2, cfg=cfg,
                        scale_modifier=0.9)
    assert isinstance(proj, ProjectedTable) == (route == "inference")
    if route == "inference":
        assert torch.equal(proj.fields, blend_fields(plain))
        assert torch.equal(proj.radii, plain.radii)
        table, total = build_table(plain)
        for a, b in zip(proj.table, table):
            assert torch.equal(a, b)
        assert int(proj.total) == int(total)
    else:
        for a, b in zip(proj, plain):
            assert torch.equal(a.detach(), b)
        assert proj.means2d.requires_grad == (route == "under_grad")
    assert _kernels.launches == before


@pytest.mark.parametrize("case", ["plain", "antialiasing", "scale_modifier", "dense"])
def test_stored_render_on_cpu_equals_the_render_of_activated_tensors(case):
    """``render_camera`` and ``render_stored`` hand the model's stored
    tensors over; on the CPU their render is the one of
    ``activated_params`` bit for bit (active degree below the maximum,
    dead slots), and within ``ATOL`` of JAX ``render_dense`` with the
    bands above the active degree zeroed."""
    params, alive = _model_inputs(300, 3, seed=24, dead=30)
    model = model_from_jax_params(params, alive, max_sh_degree=3, sh_degree=2, device="cpu")
    tcam, jcam = _cameras(64, 48)
    bg = torch.tensor([0.2, 0.1, 0.4])
    raster = RasterizeConfig(antialiasing=case == "antialiasing",
                             impl="dense" if case == "dense" else "auto")
    modifier = 0.8 if case == "scale_modifier" else 1.0
    *jax_inputs, sh = _jax_activated(params, alive)
    jout = jax_render(*jax_inputs, sh.at[:, 9:].set(0.0), jcam, jnp.asarray(bg.numpy()),
                      sh_degree=3, cfg=JaxConfig(antialiasing=case == "antialiasing"),
                      scale_modifier=modifier, impl="dense", inference=True)
    ref = render(*model.activated_params(), tcam, bg, sh_degree=3, cfg=raster,
                 scale_modifier=modifier, inference=True)
    if modifier == 1.0:
        image, out, retries = render_camera(model, SimpleNamespace(cam=tcam), raster, bg)
        assert retries == 0 and torch.equal(image, ref.image)
    else:
        out = render_stored(model.stored(), tcam, bg, sh_degree=3, cfg=raster,
                            scale_modifier=modifier)
    for name in ("image", "invdepth", "final_T", "radii", "visibility", "num_instances"):
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    _check(out, jout)


@pytest.mark.parametrize("P", [1, 127, 1000])
def test_fused_stage_outputs_are_aligned_disjoint_views_of_one_block(P):
    """K8's outputs but the radii share one allocation: each part has its
    shape and dtype, is contiguous, starts on a 16-byte boundary (K8's
    16-byte stores) and overlaps no other."""
    parts = pj._outputs(P, torch.device("cpu"))
    shapes = [(P + 1,), (P, 10), (P,), (P,), (P,), (P,), (P, 16), (P, 16), (P,)]
    dtypes = [torch.int64, torch.float32] + [torch.int32] * 6 + [torch.float32]
    base = parts[0].untyped_storage().data_ptr()
    spans = []
    for t, shape, dtype in zip(parts, shapes, dtypes, strict=True):
        assert t.shape == shape and t.dtype == dtype and t.is_contiguous()
        assert t.data_ptr() % 16 == 0 and t.untyped_storage().data_ptr() == base
        spans.append((t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
