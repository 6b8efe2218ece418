"""Port parity: the training step, densification and opacity reset.

The set-up is ``tests/test_train_step.py``'s (120 points, capacity 256,
48x32, SH degree 2 at active degree 0), carried across by
``train_state_from_jax`` so both packages start from one state.  The JAX
step renders through its dense oracle (``RasterizeConfig(impl="dense")``),
whose gradients its own suite holds its Pallas path to; the port's step runs
its tiled path (the kernels' twins on the CPU), so the comparison also
covers the port's hand-written backward.  One step with the exposure and
depth terms on: loss within 1e-5, Adam moments within 3e-4 of each leaf's
largest magnitude, parameters within 3e-4 x lr wherever JAX's gradient is
not dust, and rows whose gradient is exactly zero bitwise unchanged in both.
Densification uses the noise JAX draws from the same key.  The loop's eval
render is held to the invariants of JAX's ``render_camera`` tests: the run's
antialiasing and a given exposure apply, and an overflowing render retries
until it is complete."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.models.gaussians import create_from_pcd
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.interop import train_state_from_jax
from gaussian_splatting_torch.models.gaussians import GaussianModel, grow_capacity
from gaussian_splatting_torch.ops.rasterize import render
from gaussian_splatting_torch.train import step as tstep
from gaussian_splatting_torch.utils.testing import random_scene

W, H, CAP = 48, 32, 256
PARAMS = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")


def _jax_setup(w=W, h=H):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.8, 0.8, (120, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, max_sh_degree=2, spatial_lr_scale=1.5, capacity=CAP)
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    invd = rng.uniform(0.1, 0.5, (h, w)).astype(np.float32)
    mask = (rng.uniform(size=(h, w)) > 0.2).astype(np.float32)
    return jstep.init_train_state(model, num_images=4), gt, invd, mask


def _leaves(state):
    """A JAX TrainState as ``train_state_from_jax`` keyword arguments."""
    m = state.model
    tree = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}
    return dict(
        params=tree(m.params), aux=tree(m.aux),
        adam=(np.asarray(state.adam.count), tree(state.adam.mu), tree(state.adam.nu)),
        exposures=np.asarray(state.exposures),
        exp_adam=(np.asarray(state.exp_adam.count), np.asarray(state.exp_adam.mu),
                  np.asarray(state.exp_adam.nu)),
        step=np.asarray(state.step), spatial_lr_scale=float(m.spatial_lr_scale),
        sh_degree=int(m.sh_degree), max_sh_degree=m.max_sh_degree,
    )


def _batches(gt, invd, mask):
    h, w = gt.shape[1:]
    jb = jstep.StepBatch(
        gt_image=jnp.asarray(gt), alpha_mask=jnp.ones((1, h, w)),
        invdepth_gt=jnp.asarray(invd), depth_mask=jnp.asarray(mask),
        exposure_idx=jnp.asarray(0, jnp.int32), bg_color=jnp.zeros(3),
    )
    tb = tstep.StepBatch(
        gt_image=torch.from_numpy(gt), alpha_mask=torch.ones((1, h, w)),
        invdepth_gt=torch.from_numpy(invd), depth_mask=torch.from_numpy(mask),
        exposure_idx=torch.tensor(0), bg_color=torch.zeros(3),
    )
    return jb, tb


def _cams(w=W, h=H):
    return (jax_random_scene(4, width=w, height=h, seed=1).cam,
            random_scene(4, width=w, height=h, seed=1, device="cpu").cam)


@pytest.fixture(scope="module")
def one_step():
    jstate, gt, invd, mask = _jax_setup()
    jb, tb = _batches(gt, invd, mask)
    jcam, tcam = _cams()
    fn = jax.jit(partial(jstep.train_step, opt=JaxOpt(), raster=JaxRaster(impl="dense"),
                         use_exposure=True, use_depth=True))
    jnew, jmetrics = fn(jstate, jcam, jb)
    tstate = train_state_from_jax(**_leaves(jstate), device="cpu")
    before = {k: v.detach().clone() for k, v in tstate.tensors().items()}
    tstate, tmetrics = tstep.train_step(tstate, tcam, tb, opt=OptimizationConfig(),
                                        raster=RasterizeConfig(), use_exposure=True,
                                        use_depth=True)
    return jnew, jmetrics, tstate, tmetrics, before


def test_one_step_loss_and_metrics_match_jax(one_step):
    jnew, jm, tstate, tm, _ = one_step
    for name in ("loss", "l1", "depth_loss"):
        assert abs(float(tm[name]) - float(jm[name])) <= 1e-5, name
    assert float(tm["depth_loss"]) > 0
    assert not bool(tm["overflow"])
    assert int(tm["num_alive"]) == int(jm["num_alive"]) == 120
    assert int(tstate.step) == int(jnew.step) == 1
    assert int(tstate.adam.count) == int(jnew.adam.count) == 1
    packed = tm["packed"].numpy()
    assert packed.shape == (6,) and packed[0] == float(tm["loss"]) and packed[3] == 0.0


def test_one_step_adam_and_params_match_jax(one_step):
    jnew, _, tstate, _, before = one_step
    lrs = {k: float(v) for k, v in jstep.group_lrs(JaxOpt(), 1, 1.5)._asdict().items()}
    for name in PARAMS:
        j_mu = np.asarray(getattr(jnew.adam.mu, name))
        j_nu = np.asarray(getattr(jnew.adam.nu, name))
        for t, j in ((tstate.adam.mu[name], j_mu), (tstate.adam.nu[name], j_nu)):
            scale = np.abs(j).max() + 1e-30
            np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=3e-4, err_msg=name)
        g = j_mu / 0.1  # the first step's gradient
        tp = getattr(tstate.model, name).detach().numpy()
        jp = np.asarray(getattr(jnew.model.params, name))
        p0 = before[name].numpy()
        solid = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(tp[solid], jp[solid], atol=3e-4 * lrs[name], rtol=0,
                                   err_msg=name)
        zero = (g == 0).reshape(g.shape[0], -1).all(axis=1)
        assert zero[~np.asarray(jnew.model.aux.alive)].all()  # dead slots
        np.testing.assert_array_equal(tp[zero], p0[zero], err_msg=name)
        np.testing.assert_array_equal(jp[zero], p0[zero], err_msg=name)
    # SH above the active degree gets no gradient in either package
    assert np.asarray(jnew.adam.mu.features_rest).max() == 0.0
    assert float(tstate.adam.mu["features_rest"].abs().max()) == 0.0


def test_one_step_exposure_and_stats_match_jax(one_step):
    jnew, _, tstate, _, before = one_step
    moved = np.abs(tstate.exposures.numpy() - before["exposures"].numpy()).sum(axis=(1, 2))
    assert moved[0] > 0 and (moved[1:] == 0).all()  # only image 0 had a gradient
    np.testing.assert_allclose(tstate.exposures.numpy(), np.asarray(jnew.exposures),
                               atol=3e-4 * 0.01, rtol=0)
    aux = jnew.model.aux
    np.testing.assert_array_equal(tstate.model.denom.numpy(), np.asarray(aux.denom))
    np.testing.assert_array_equal(tstate.model.max_radii2d.numpy(), np.asarray(aux.max_radii2d))
    j_acc = np.asarray(aux.xyz_grad_accum)
    np.testing.assert_allclose(tstate.model.xyz_grad_accum.numpy(), j_acc,
                               atol=5e-4 * j_acc.max(), rtol=0)


def _port_state(**kw):
    jstate, gt, invd, mask = _jax_setup(**kw)
    return train_state_from_jax(**_leaves(jstate), device="cpu"), _batches(gt, invd, mask)[1]


def test_twelve_steps_decrease_the_loss():
    state, batch = _port_state()
    _, cam = _cams()
    losses = []
    for _ in range(12):
        state, m = tstep.train_step(state, cam, batch, opt=OptimizationConfig(),
                                    raster=RasterizeConfig())
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert int(state.step) == 12
    assert all(bool(torch.isfinite(p).all()) for p in state.model.params().values())
    assert float(state.model.denom.sum()) > 0 and float(state.model.max_radii2d.max()) > 0


def test_sparse_adam_moves_only_visible_rows():
    state, batch = _port_state()
    _, cam = _cams()
    with torch.no_grad():
        visible = render(*state.model.activated_params(), cam, batch.bg_color,
                         sh_degree=2, inference=True).radii > 0
    before = {k: v.detach().clone() for k, v in state.tensors().items()}
    opt = OptimizationConfig(optimizer_type="sparse_adam")
    state, _ = tstep.train_step(state, cam, batch, opt=opt, raster=RasterizeConfig())
    moved = (state.model.means3d - before["means3d"]).abs().sum(dim=1) > 0
    assert bool(moved.any()) and not bool((moved & ~visible).any())
    for k in ("means3d", "adam.mu.means3d", "adam.nu.opacities", "scales"):
        assert torch.equal(state.tensors()[k][~visible], before[k][~visible]), k


def test_overflowed_step_leaves_the_state_bitwise_unchanged():
    """Large Gaussians at 128x96 demand far more slots than the capacity."""
    state, _ = _port_state(w=128, h=96)
    with torch.no_grad():
        state.model.scales.add_(2.0)
    _, cam = _cams(128, 96)
    batch = tstep.StepBatch(torch.rand(3, 96, 128, generator=torch.Generator().manual_seed(0)),
                            torch.ones(1, 96, 128), torch.zeros(96, 128), torch.zeros(96, 128),
                            torch.tensor(0), torch.zeros(3))
    before = {k: v.detach().clone() for k, v in state.tensors().items()}
    state, m = tstep.train_step(state, cam, batch, opt=OptimizationConfig(),
                                raster=RasterizeConfig(), use_exposure=True, use_depth=True)
    assert bool(m["overflow"]) and float(m["packed"][3]) == 1.0
    after = state.tensors()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert int(state.step) == 0


def _densify_ready(jstate):
    """Statistics that select clones, splits and prunes."""
    rng = np.random.default_rng(7)
    C = CAP
    alive = np.asarray(jstate.model.aux.alive)
    scales = np.asarray(jstate.model.params.scales).copy()
    scales[:40] = np.log(0.005)  # small: clone candidates
    op = np.asarray(jstate.model.params.opacities).copy()
    op[100:110] = -7.0  # below min_opacity: pruned
    aux = jstate.model.aux._replace(
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 0.001, C).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 3, C).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, C).astype(np.float32) * alive),
    )
    params = jstate.model.params._replace(scales=jnp.asarray(scales), opacities=jnp.asarray(op))
    return dataclasses.replace(jstate, model=dataclasses.replace(jstate.model, params=params,
                                                                 aux=aux))


@pytest.mark.parametrize("max_screen_size", [0, 20])
def test_densify_matches_jax_with_its_noise(one_step, max_screen_size):
    jstate = _densify_ready(one_step[0])
    key = jax.random.PRNGKey(0)
    jnew, jstats = jax.jit(partial(jstep.densify_step, opt=JaxOpt(),
                                   max_screen_size=max_screen_size))(jstate, key)
    k1, k2 = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (CAP, 3)))) for k in (k1, k2))
    tstate = train_state_from_jax(**_leaves(jstate), device="cpu")
    tstate, tstats = tstep.densify_step(tstate, opt=OptimizationConfig(),
                                        max_screen_size=max_screen_size, noise=noise)
    for name in ("cloned", "split", "pruned", "dropped", "num_alive"):
        assert int(tstats[name]) == int(jstats[name]), name
    assert int(tstats["cloned"]) > 0 and int(tstats["split"]) > 0 and int(tstats["pruned"]) > 0
    np.testing.assert_array_equal(tstate.model.alive.numpy(), np.asarray(jnew.model.aux.alive))
    for name in PARAMS:
        np.testing.assert_allclose(getattr(tstate.model, name).detach().numpy(),
                                   np.asarray(getattr(jnew.model.params, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
        np.testing.assert_array_equal(tstate.adam.mu[name].numpy(),
                                      np.asarray(getattr(jnew.adam.mu, name)), err_msg=name)
    assert float(tstate.model.denom.abs().sum()) == 0.0


def test_densify_draws_from_a_generator():
    state, _ = _port_state()
    with torch.no_grad():
        state.model.xyz_grad_accum.fill_(1.0)
        state.model.denom.fill_(1.0)
    a = tstep.densify_step(state, torch.Generator().manual_seed(1), opt=OptimizationConfig(),
                           max_screen_size=0)[0].model.means3d.detach().clone()
    state, _ = _port_state()
    with torch.no_grad():
        state.model.xyz_grad_accum.fill_(1.0)
        state.model.denom.fill_(1.0)
    b = tstep.densify_step(state, torch.Generator().manual_seed(1), opt=OptimizationConfig(),
                           max_screen_size=0)[0].model.means3d.detach()
    assert torch.equal(a, b)


def test_opacity_reset_matches_jax(one_step):
    jnew = one_step[0]
    jreset = jstep.opacity_reset_step(jnew)
    tstate = tstep.opacity_reset_step(train_state_from_jax(**_leaves(jnew), device="cpu"))
    np.testing.assert_allclose(tstate.model.opacities.detach().numpy(),
                               np.asarray(jreset.model.params.opacities), atol=1e-6, rtol=0)
    op = torch.sigmoid(tstate.model.opacities.detach())[tstate.model.alive]
    assert float(op.max()) <= 0.0101
    assert float(tstate.adam.mu["opacities"].abs().sum()) == 0.0
    assert float(tstate.adam.nu["opacities"].abs().sum()) == 0.0
    assert float(tstate.adam.mu["means3d"].abs().sum()) > 0  # other moments kept


def test_model_helpers():
    state, _ = _port_state()
    model = state.model
    assert int(model.num_alive()) == 120 and model.sh_degree == 0
    for _ in range(3):
        model.one_up_sh_degree()
    assert model.sh_degree == model.max_sh_degree == 2
    big = grow_capacity(model, 300)
    assert isinstance(big, GaussianModel) and big.capacity == 300
    assert torch.equal(big.means3d[:CAP], model.means3d) and not bool(big.alive[CAP:].any())
    assert float(big.opacities[CAP:].detach().max()) == -10.0 and big.spatial_lr_scale == 1.5
    assert int(big.num_alive()) == 120


def _jax_render(jstate, cam, bg, **raster):
    """JAX's eval render (``train.loop.render_camera``) through its dense
    oracle, as numpy."""
    from types import SimpleNamespace

    from gaussian_splatting_tpu.train.loop import render_camera

    camera = SimpleNamespace(cam=cam, exposure_idx=0, image_name="c0")
    image, _ = render_camera(jstate, camera, JaxRaster(impl="dense", **raster), bg)
    return np.asarray(image)


def test_render_camera_honors_raster_config_and_exposure():
    """JAX's ``test_train_step.py::test_render_camera_honors_raster_config_and_exposure``
    on the port: the loop's eval render applies the run's antialiasing, and
    a pretrained exposure given to it overrides the state's.  Both renders
    are held to JAX's on the same state."""
    from types import SimpleNamespace

    from gaussian_splatting_torch.train.loop import render_camera

    jstate = _jax_setup()[0]
    state = train_state_from_jax(**_leaves(jstate), device="cpu")
    jcam, cam = _cams()
    camera = SimpleNamespace(cam=cam, exposure_idx=0, image_name="c0")
    bg = torch.zeros(3)
    plain, _ = render_camera(state, camera, RasterizeConfig(), bg)
    aa, _ = render_camera(state, camera, RasterizeConfig(antialiasing=True), bg)
    assert float((aa - plain).abs().max()) > 1e-4
    np.testing.assert_allclose(plain.numpy(), _jax_render(jstate, jcam, jnp.zeros(3)), atol=2e-4)
    np.testing.assert_allclose(aa.numpy(), _jax_render(jstate, jcam, jnp.zeros(3),
                                                       antialiasing=True), atol=2e-4)
    exposure = torch.cat([0.5 * torch.eye(3), torch.full((3, 1), 0.1)], dim=1)
    exposed, _ = render_camera(state, camera, RasterizeConfig(), bg, exposure=exposure)
    np.testing.assert_allclose(exposed.numpy(), np.clip(0.5 * plain.numpy() + 0.1, 0.0, 1.0),
                               atol=1e-5)
    state.exposures[0] = exposure  # the trained affine, used under use_exposure
    trained, _ = render_camera(state, camera, RasterizeConfig(), bg, use_exposure=True)
    assert torch.equal(trained, exposed)


def test_eval_render_retries_on_instance_overflow():
    """JAX's ``test_train_step.py::test_eval_render_retries_on_instance_overflow``
    on the port: Gaussians that each cover many tiles overflow a render at
    the default slack; the eval render (``render.render_camera``, which the
    loop's wraps) doubles the slack until the render is complete, and returns
    what an ample slack renders and what JAX renders on the same state."""
    from types import SimpleNamespace

    from gaussian_splatting_torch.render import render_camera as render_view
    from gaussian_splatting_torch.train.loop import render_camera

    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.3, 0.3, (64, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    jmodel = create_from_pcd(pts, cols, max_sh_degree=1, spatial_lr_scale=1.5, capacity=128)
    # each Gaussian covers a large tile footprint
    jmodel = dataclasses.replace(
        jmodel, params=jmodel.params._replace(scales=jmodel.params.scales + 2.0))
    jstate = jstep.init_train_state(jmodel, num_images=1)
    state = train_state_from_jax(**_leaves(jstate), device="cpu")
    camera = SimpleNamespace(cam=random_scene(4, width=128, height=96, seed=2, device="cpu").cam,
                             image_name="x", exposure_idx=0)
    bg = torch.zeros(3)
    image, out, retries = render_view(state.model, camera, RasterizeConfig(instance_slack=2.0), bg)
    assert not bool(out.overflow) and retries > 0  # complete, after a retry at least
    ample, out_ample = render_camera(state, camera, RasterizeConfig(instance_slack=512.0), bg)
    assert not bool(out_ample.overflow)
    np.testing.assert_allclose(image.numpy(), ample.numpy(), atol=2e-5)
    jcam = jax_random_scene(4, width=128, height=96, seed=2).cam
    np.testing.assert_allclose(image.numpy(), _jax_render(jstate, jcam, jnp.zeros(3)), atol=2e-4)
