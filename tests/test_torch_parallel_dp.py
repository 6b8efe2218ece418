"""Port parity: the camera data-parallel step on gloo worlds of 2 and 4 CPU
ranks (each spawned once per module).

- At 2 ranks, 3 steps of ``dp_train_step`` against JAX's ``dp_train_step``
  (``RasterizeConfig(impl="dense")``) on a 2-device virtual mesh, with
  exposure and depth terms: losses within 1e-5 (JAX
  ``tests/test_parallel.py::test_dp_loss_matches_single_camera_mean``'s
  bound), exposures and means within Adam's step-level tolerance.
- At 4 ranks, the first step's loss against the mean of the port's
  ``train_step`` over the 4 cameras.
- At both, every rank ends with the same state, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.models.gaussians import create_from_pcd
from gaussian_splatting_tpu.ops.camera_math import CameraParams
from gaussian_splatting_tpu.parallel.dp import dp_train_step as jax_dp_train_step
from gaussian_splatting_tpu.parallel.mesh import make_mesh
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.interop import jax_state_leaves, train_state_from_jax
from gaussian_splatting_torch.train.step import train_step
from gaussian_splatting_torch.utils.testing import (
    World,
    parallel_steps_worker,
    random_scene,
    step_batch,
)

W, H, STEPS = 48, 32, 3
CAM_SEEDS = [20, 21, 22, 23]
WORLDS = (2, 4)


def _setup(n):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.8, 0.8, (64, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, max_sh_degree=1, spatial_lr_scale=1.0, capacity=128)
    state = jstep.init_train_state(model, num_images=n)
    batches = [dict(gt=rng.uniform(0, 1, (3, H, W)).astype(np.float32), exposure_idx=i,
                    invdepth=np.full((H, W), 0.5, np.float32),
                    depth_mask=np.ones((H, W), np.float32)) for i in range(n)]
    return state, batches


def _jax_dp():
    """3 steps of JAX's dp_train_step on a 2-device mesh."""
    state, batches = _setup(2)
    cams = [jax_random_scene(4, width=W, height=H, seed=s).cam for s in CAM_SEEDS[:2]]
    stacked = CameraParams(
        viewmatrix=jnp.stack([c.viewmatrix for c in cams]),
        projmatrix=jnp.stack([c.projmatrix for c in cams]),
        campos=jnp.stack([c.campos for c in cams]),
        tan_fovx=cams[0].tan_fovx, tan_fovy=cams[0].tan_fovy, width=W, height=H)
    batch = jstep.StepBatch(
        gt_image=jnp.stack([b["gt"] for b in batches]), alpha_mask=jnp.ones((2, 1, H, W)),
        invdepth_gt=jnp.stack([b["invdepth"] for b in batches]),
        depth_mask=jnp.stack([b["depth_mask"] for b in batches]),
        exposure_idx=jnp.arange(2, dtype=jnp.int32), bg_color=jnp.zeros((2, 3)))
    fn = jax.jit(lambda s: jax_dp_train_step(
        s, stacked, batch, make_mesh(2), opt=JaxOpt(), raster=JaxRaster(impl="dense"),
        use_exposure=True, use_depth=True))
    packed = []
    for _ in range(STEPS):
        state, m = fn(state)
        packed.append(np.asarray(m["packed"]))
    return np.stack(packed), state


@pytest.fixture(scope="module")
def runs():
    """Each world size's (JAX state, batches, each rank's results), and JAX's
    2-device run; the worlds run while JAX compiles."""
    worlds = {}
    for n in WORLDS:
        state, batches = _setup(n)
        worlds[n] = (state, batches, World(
            n, (parallel_steps_worker, "dp", jax_state_leaves(state), batches,
                CAM_SEEDS[:n], STEPS, True, True), timeout_s=120.0))
    jax_run = _jax_dp()
    return {n: (state, batches, [r[0] for r in world.results()])
            for n, (state, batches, world) in worlds.items()}, jax_run


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_end_with_the_same_state(runs, n):
    _, _, results = runs[0][n]
    for r in range(1, n):
        for name, value in results[0]["state"].items():
            np.testing.assert_array_equal(results[r]["state"][name], value,
                                          err_msg=f"{name} on rank {r} of {n}")
        np.testing.assert_array_equal(results[r]["packed"], results[0]["packed"])


def test_losses_match_jax_dp(runs):
    _, _, results = runs[0][2]
    packed, _ = runs[1]
    got = results[0]["packed"]
    for col, name in enumerate(("loss", "l1", "depth_loss")):
        np.testing.assert_allclose(got[:, col], packed[:, col], atol=1e-5, rtol=0,
                                   err_msg=name)
    assert (got[:, 2] > 0).all() and (got[:, 3] == 0).all()  # depth term, no overflow
    assert got[-1, 0] < got[0, 0]


def test_state_matches_jax_dp(runs):
    _, _, results = runs[0][2]
    _, jstate = runs[1]
    got = results[0]["state"]
    # exposure rows of both cameras moved, by gradients summed (not averaged)
    moved = np.abs(got["exposures"] - np.asarray(_setup(2)[0].exposures)).sum(axis=(1, 2))
    assert (moved > 0).all()
    np.testing.assert_allclose(got["exposures"], np.asarray(jstate.exposures),
                               atol=3 * 3e-4 * 0.01, rtol=0)
    np.testing.assert_array_equal(got["denom"], np.asarray(jstate.model.aux.denom))
    np.testing.assert_allclose(got["means3d"], np.asarray(jstate.model.params.means3d),
                               atol=5e-4, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_first_loss_is_the_mean_over_cameras(runs, n):
    state, batches, results = runs[0][n]
    losses = []
    for i in range(n):
        s = train_state_from_jax(**jax_state_leaves(state), device="cpu")
        cam = random_scene(4, width=W, height=H, seed=CAM_SEEDS[i], device="cpu").cam
        _, m = train_step(s, cam, step_batch(**batches[i]), opt=OptimizationConfig(),
                          raster=RasterizeConfig(), use_exposure=True, use_depth=True)
        losses.append(m["packed"].numpy())
    mean = np.mean(losses, axis=0)
    got = results[0]["packed"][0]
    np.testing.assert_allclose(got[:3], mean[:3], rtol=1e-6)
    assert got[4] == max(l[4] for l in losses)  # the slot demand is a maximum
