"""The port against the JAX package on a late training state: the
iteration-15000 snapshot of the port's 30k run of the quality corpus's
"spheres" scene (seed 0) on the card, cut by ``tools/torch_c4_probe.py --cut``
to ``tests/data/spheres_15000_crop.npz``: the central window of the first test
view at that view's own focal lengths, the snapshot's Gaussians with a
positive radius there (SH degree 3, every coefficient trained), and the
window's ground-truth pixels.

- The render: the port's tiled path (K1-K6's plain twins on the CPU) against
  JAX's Pallas render in interpret mode: image, T and inverse depth within
  2e-4, ``radii`` and ``tiles_touched`` equal.
- The tiled path's loss gradients against JAX's Pallas render's, within
  3e-4 of each gradient's largest magnitude, the densification tap's too.
  (On this state JAX's Pallas and dense renders part; see
  ``test_loss_gradients_match_jax_pallas``.)
- One ``train_step`` through each package's dense oracle at the snapshot's
  SH degree and step count, from one state carried across by ``interop``:
  the loss within 1e-5, the densification statistics, Adam's moments and
  the parameters as in
  ``test_torch_train_loop.py::test_three_real_iterations_match_jax``.
- One ``densify_step`` with the screen-size limit of 20 px on that step's
  statistics, with JAX's split noise: the same clone, split and prune masks,
  the same counts and the same Gaussians alive after it.

JAX's Pallas render with gradients costs ~30 s a call in interpret mode, so
it runs once, and the training step runs through each package's dense
oracle (``impl="dense"``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.models.gaussians import GaussianAux, GaussianParams, empty_params
from gaussian_splatting_tpu.models.gaussians import GaussianModel as JaxModel
from gaussian_splatting_tpu.ops.camera_math import make_camera as jax_make_camera
from gaussian_splatting_tpu.ops.losses import photometric_loss as jax_photometric_loss
from gaussian_splatting_tpu.ops.preprocess import preprocess as jax_preprocess
from gaussian_splatting_tpu.ops.rasterize import render as jax_render
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_torch import interop
from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.models.gaussians import PARAM_NAMES
from gaussian_splatting_torch.ops.losses import photometric_loss
from gaussian_splatting_torch.ops.rasterize import _render, project
from gaussian_splatting_torch.train import step as tstep
from gaussian_splatting_torch.train.optim import group_lrs
from gaussian_splatting_torch.utils.testing import (read_state_crop, slot_capacity, state_crop_camera,
                                                    step_batch)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "spheres_15000_crop.npz")
CAPACITY = 4096  # slots: the fixture's <= 2000 Gaussians and room for a densify
SCREEN_LIMIT = 20  # px: the loop's limit once iteration > opacity_reset_interval
LAMBDA_DSSIM = OptimizationConfig().lambda_dssim
GRAD_NAMES = ("means3d", "scales", "quats", "opacities", "sh", "tap")


@pytest.fixture(scope="module")
def crop():
    return read_state_crop(FIXTURE)


@pytest.fixture(scope="module")
def jax_state(crop):
    """JAX's ``TrainState``: the fixture's Gaussians in the first slots of
    CAPACITY, the snapshot's SH degree and step count, fresh moments."""
    n = crop["means3d"].shape[0]
    degree = int(crop["sh_degree"])
    empty = empty_params(CAPACITY, degree)
    params = {}
    for name in PARAM_NAMES:
        a = np.array(getattr(empty, name))
        a[:n] = crop[name]
        params[name] = jnp.asarray(a)
    alive = np.zeros(CAPACITY, bool)
    alive[:n] = True
    zeros = jnp.zeros(CAPACITY, jnp.float32)
    model = JaxModel(params=GaussianParams(**params),
                     aux=GaussianAux(alive=jnp.asarray(alive), max_radii2d=zeros,
                                     xyz_grad_accum=zeros, denom=zeros),
                     spatial_lr_scale=jnp.float32(crop["extent"]),
                     sh_degree=jnp.int32(degree), max_sh_degree=degree)
    state = jstep.init_train_state(model, 1)
    return jstep.TrainState(model=model, adam=state.adam, exposures=state.exposures,
                            exp_adam=state.exp_adam, step=jnp.int32(crop["iteration"]))


def _jax_camera(crop):
    return jax_make_camera(crop["R"], crop["T"], float(crop["fovx"]), float(crop["fovy"]),
                           int(crop["width"]), int(crop["height"]))


def _jax_inputs(crop):
    """JAX's activated render inputs of the fixture's Gaussians (no padding)."""
    q = jnp.asarray(crop["quats"])
    sh = np.concatenate([crop["features_dc"], crop["features_rest"]], axis=1)
    return (jnp.asarray(crop["means3d"]), jnp.exp(jnp.asarray(crop["scales"])),
            q / jnp.linalg.norm(q, axis=-1, keepdims=True),
            jax.nn.sigmoid(jnp.asarray(crop["opacities"])), jnp.asarray(sh))


def _port_inputs(crop):
    q = torch.from_numpy(crop["quats"])
    sh = np.concatenate([crop["features_dc"], crop["features_rest"]], axis=1)
    return (torch.from_numpy(crop["means3d"]), torch.exp(torch.from_numpy(crop["scales"])),
            q / torch.sqrt((q * q).sum(dim=-1, keepdim=True)),
            torch.sigmoid(torch.from_numpy(crop["opacities"])), torch.from_numpy(sh))


def _slots(crop):
    """A slot capacity past the window's demand, the same in both packages."""
    degree = int(crop["sh_degree"])
    proj = project(_port_inputs(crop), state_crop_camera(crop, device="cpu"),
                   sh_degree=degree)
    return slot_capacity(int(proj.tiles_touched.sum()))


def test_fixture_is_a_late_state(crop):
    n = crop["means3d"].shape[0]
    assert 0 < n <= 2000 and os.path.getsize(FIXTURE) <= 512 * 1024
    assert int(crop["iteration"]) == 15000 and int(crop["sh_degree"]) == 3
    assert np.abs(crop["features_rest"]).max() > 0  # the higher degrees are trained
    assert crop["gt"].shape == (3, int(crop["height"]), int(crop["width"]))


@pytest.fixture(scope="module")
def jax_render_and_grads(crop):
    """JAX's Pallas render of the window (image, T, inverse depth, radii,
    ``tiles_touched``) and the loss gradients through it."""
    degree = int(crop["sh_degree"])
    n = crop["means3d"].shape[0]
    jcam = _jax_camera(crop)
    cap = _slots(crop)

    def loss(m, sc, q, o, sh, tap):
        r = jax_render(m, sc, q, o, sh, jcam, jnp.ones(3), sh_degree=degree, impl="pallas",
                       capacity=cap, means2d_tap=tap)
        tiles = jax_preprocess(m, sc, q, o, sh, jcam, sh_degree=degree).tiles_touched
        return (jax_photometric_loss(r.image, jnp.asarray(crop["gt"]), LAMBDA_DSSIM),
                (r.image, r.final_T, r.invdepth, r.radii, tiles, r.overflow))

    (_, aux), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True))(
        *_jax_inputs(crop), jnp.zeros((n, 2), jnp.float32))
    assert not bool(aux[-1])
    return tuple(np.asarray(a) for a in aux[:-1]) + ([np.asarray(g) for g in grads],)


@pytest.fixture(scope="module")
def port_render_and_grads(crop):
    """The port's render of the window (the tiled path) and the loss
    gradients through it."""
    n = crop["means3d"].shape[0]
    leaves = [t.clone().requires_grad_(True) for t in (*_port_inputs(crop), torch.zeros((n, 2)))]
    r = _render(*leaves[:5], state_crop_camera(crop, device="cpu"), torch.ones(3),
                sh_degree=int(crop["sh_degree"]), capacity=_slots(crop), means2d_tap=leaves[5])
    assert not bool(r.overflow)
    grads = torch.autograd.grad(photometric_loss(r.image, torch.from_numpy(crop["gt"]),
                                                 LAMBDA_DSSIM), leaves)
    return r, [g.numpy() for g in grads]


def test_render_matches_jax_pallas(crop, jax_render_and_grads, port_render_and_grads):
    image, final_t, invdepth, radii, tiles, _ = jax_render_and_grads
    out, _ = port_render_and_grads
    for name, ref in (("image", image), ("final_T", final_t), ("invdepth", invdepth)):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(), ref, atol=2e-4,
                                   rtol=0, err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(), radii)
    proj = project(_port_inputs(crop), state_crop_camera(crop, device="cpu"),
                   sh_degree=int(crop["sh_degree"]))
    np.testing.assert_array_equal(proj.tiles_touched.numpy(), tiles)
    assert (out.radii > 0).all()  # the cut kept the Gaussians the window sees
    assert int(out.radii.max()) > SCREEN_LIMIT  # the screen-size limit has work here


def test_loss_gradients_match_jax_pallas(jax_render_and_grads, port_render_and_grads):
    """The tiled path's gradients against JAX's Pallas render's.  The dense
    oracles' are held to each other through the training step's first
    moments (``test_train_step_matches_jax``): on this state JAX's Pallas
    and dense renders part by up to 3.4e-3 of the largest gradient, because
    its tile cull clips each Gaussian's tiles to the 3-sigma circle, so a
    pixel in a corner of the 3-sigma rect whose alpha still reaches 1/255
    is blended by the dense oracle and by neither tiled path."""
    for name, g, j in zip(GRAD_NAMES, port_render_and_grads[1], jax_render_and_grads[-1]):
        scale = np.abs(j).max()
        assert scale > 0, name
        np.testing.assert_allclose(g / scale, j / scale, atol=3e-4, err_msg=name)


@pytest.fixture(scope="module")
def stepped(crop, jax_state):
    """One training step of each package from the same state, each through
    its dense oracle: on this state the tiled renders part from the dense
    ones (``test_loss_gradients_match_jax_pallas``), so the step is held
    renderer for renderer: Adam's first moments, one tenth of the
    gradients, hold the dense oracles' gradients to each other."""
    raster = dict(instance_slack=_slots(crop) / CAPACITY)
    gt = crop["gt"]
    h, w = gt.shape[1:]
    jbatch = jstep.StepBatch(gt_image=jnp.asarray(gt), alpha_mask=jnp.ones((1, h, w)),
                             invdepth_gt=jnp.zeros((h, w)), depth_mask=jnp.zeros((h, w)),
                             exposure_idx=jnp.int32(0), bg_color=jnp.ones(3))
    jnew, jm = jax.jit(lambda s, b: jstep.train_step(
        s, _jax_camera(crop), b, opt=JaxOpt(), raster=JaxRaster(impl="dense", **raster)))(
            jax_state, jbatch)
    state = interop.train_state_from_jax(**interop.jax_state_leaves(jax_state), device="cpu")
    batch = step_batch(gt)._replace(bg_color=torch.ones(3))
    state, m = tstep.train_step(state, state_crop_camera(crop, device="cpu"), batch,
                                opt=OptimizationConfig(), raster=RasterizeConfig(impl="dense", **raster))
    return state, m, jnew, jm


def test_train_step_matches_jax(crop, stepped):
    state, m, jnew, jm = stepped
    assert not bool(m["overflow"]) and not bool(jm["overflow"])
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert int(state.step) == int(jnew.step) == int(crop["iteration"]) + 1
    aux = jnew.model.aux
    np.testing.assert_array_equal(state.model.denom.numpy(), np.asarray(aux.denom))
    np.testing.assert_array_equal(state.model.max_radii2d.numpy(), np.asarray(aux.max_radii2d))
    accum = np.asarray(aux.xyz_grad_accum)
    np.testing.assert_allclose(state.model.xyz_grad_accum.numpy() / accum.max(),
                               accum / accum.max(), atol=3e-4)
    lrs = {k: float(v) for k, v in group_lrs(OptimizationConfig(), state.step,
                                             float(crop["extent"])).items()}
    for name in PARAM_NAMES:
        j_mu = np.asarray(getattr(jnew.adam.mu, name))
        scale = np.abs(j_mu).max()
        assert scale > 0, name
        np.testing.assert_allclose(state.adam.mu[name].numpy() / scale, j_mu / scale,
                                   atol=3e-4, err_msg=name)
        solid = np.abs(j_mu) > 1e-3 * scale
        diff = np.abs(getattr(state.model, name).detach().numpy()
                      - np.asarray(getattr(jnew.model.params, name)))
        # Adam's first step moves a coordinate by lr along its gradient's sign,
        # so a dust gradient of the other sign lands 2 lr away
        assert (diff[solid] <= 3e-4 * lrs[name]).mean() >= 0.99, name
        assert diff.max() <= 2 * lrs[name] * (1 + 1e-6), name


def _masks(params, stats, alive, extent, opt):
    """The densify decisions on one state: clone, split, and the three
    prune conditions (opacity, screen size, world size)."""
    denom = stats["denom"]
    grads = np.where(denom > 0, stats["xyz_grad_accum"] / np.maximum(denom, 1.0), 0.0)
    max_scale = np.exp(params["scales"]).max(axis=-1)
    high = alive & (grads >= opt.densify_grad_threshold)
    small = max_scale <= opt.percent_dense * extent
    return dict(clone=high & small, split=high & ~small,
                opacity=alive & (1 / (1 + np.exp(-params["opacities"])) < 0.005),
                screen=alive & (stats["max_radii2d"] > SCREEN_LIMIT),
                world=alive & (max_scale > 0.1 * extent))


def test_densify_matches_jax(crop, stepped):
    state, _, jnew, _ = stepped
    opt = OptimizationConfig()
    extent = float(crop["extent"])
    model = state.model
    ours = _masks({k: getattr(model, k).detach().numpy() for k in PARAM_NAMES},
                  {k: getattr(model, k).numpy() for k in ("denom", "xyz_grad_accum",
                                                          "max_radii2d")},
                  model.alive.numpy(), extent, opt)
    jm = jnew.model
    theirs = _masks({k: np.asarray(v) for k, v in jm.params._asdict().items()},
                    {k: np.asarray(v) for k, v in jm.aux._asdict().items()},
                    np.asarray(jm.aux.alive), extent, opt)
    for name in ours:
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)
    assert ours["screen"].sum() > 0 and (ours["clone"] | ours["split"]).sum() > 0

    key = jax.random.PRNGKey(0)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (CAPACITY, 3))))
                  for k in jax.random.split(key))
    state, stats = tstep.densify_step(state, opt=opt, max_screen_size=SCREEN_LIMIT, noise=noise)
    jdone, jstats = jax.jit(lambda s, k: jstep.densify_step(
        s, k, opt=JaxOpt(), max_screen_size=SCREEN_LIMIT))(jnew, key)
    for name in ("cloned", "split", "pruned", "dropped", "num_alive"):
        assert int(stats[name]) == int(jstats[name]), name
    np.testing.assert_array_equal(state.model.alive.numpy(), np.asarray(jdone.model.aux.alive))
