"""Port parity: the Gaussian/tile-sharded training step on gloo worlds of 2
and 4 CPU ranks (spawned once each, while JAX compiles).

3 steps of ``gshard_train_step`` from a state sharded with ``shard_state``
and gathered back with ``gather_state``, against 3 steps of the port's
``train_step`` and of JAX's ``train_step`` (``impl="dense"``) from the same
numpy arrays, at JAX ``tests/test_parallel.py::
test_gshard_train_step_matches_single_device``'s tolerances: losses within
2e-4 relative, ``denom`` within 1e-6, ``xyz_grad_accum`` within 2e-2
relative (1e-5 absolute), means within 5e-4.  Again with exposure and depth
terms against the port's single step.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.models.gaussians import create_from_pcd
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.interop import jax_state_leaves, train_state_from_jax
from gaussian_splatting_torch.parallel.gshard import shard_state
from gaussian_splatting_torch.train.step import train_step
from gaussian_splatting_torch.utils.testing import (
    World,
    parallel_steps_worker,
    random_scene,
    step_batch,
)

W, H, STEPS, CAM_SEED = 48, 32, 3, 20
WORLDS = (2, 4)
VARIANTS = {"plain": (False, False), "exposure_depth": (True, True)}


def _setup():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.8, 0.8, (64, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, max_sh_degree=1, spatial_lr_scale=1.0, capacity=128)
    batch = dict(gt=rng.uniform(0, 1, (3, H, W)).astype(np.float32), exposure_idx=0,
                 invdepth=rng.uniform(0.1, 0.5, (H, W)).astype(np.float32),
                 depth_mask=(rng.uniform(size=(H, W)) > 0.2).astype(np.float32))
    return jstep.init_train_state(model, num_images=2), batch


def _port_single(leaves, batch, use_exposure, use_depth):
    state = train_state_from_jax(**leaves, device="cpu")
    cam = random_scene(4, width=W, height=H, seed=CAM_SEED, device="cpu").cam
    packed = []
    for _ in range(STEPS):
        state, m = train_step(state, cam, step_batch(**batch), opt=OptimizationConfig(),
                              raster=RasterizeConfig(), use_exposure=use_exposure,
                              use_depth=use_depth)
        packed.append(m["packed"].numpy())
    return np.stack(packed), {k: v.detach().numpy() for k, v in state.tensors().items()}


def _jax_single(state, batch):
    cam = jax_random_scene(4, width=W, height=H, seed=CAM_SEED).cam
    jb = jstep.StepBatch(
        gt_image=jnp.asarray(batch["gt"]), alpha_mask=jnp.ones((1, H, W)),
        invdepth_gt=jnp.zeros((H, W)), depth_mask=jnp.zeros((H, W)),
        exposure_idx=jnp.asarray(0, jnp.int32), bg_color=jnp.zeros(3))
    fn = jax.jit(partial(jstep.train_step, opt=JaxOpt(), raster=JaxRaster(impl="dense")))
    packed = []
    for _ in range(STEPS):
        state, m = fn(state, cam, jb)
        packed.append(np.asarray(m["packed"]))
    return np.stack(packed), state


@pytest.fixture(scope="module")
def runs():
    state, batch = _setup()
    leaves = jax_state_leaves(state)
    plain = dict(batch, invdepth=None, depth_mask=None)
    worlds = {n: World(n, *[(parallel_steps_worker, "gshard", leaves,
                             [plain if v == "plain" else batch], [CAM_SEED], STEPS, *flags)
                            for v, flags in VARIANTS.items()], timeout_s=120.0)
              for n in WORLDS}
    jax_run = _jax_single(state, batch)
    single = {v: _port_single(leaves, plain if v == "plain" else batch, *flags)
              for v, flags in VARIANTS.items()}
    sharded = {n: [dict(zip(VARIANTS, r)) for r in w.results()] for n, w in worlds.items()}
    return sharded, single, jax_run, leaves


def _check_step_tolerances(got_packed, got_state, ref_packed, ref_state):
    la, lb = ref_packed[:, 0], got_packed[:, 0]
    assert (np.abs(la - lb) < 2e-4 * np.maximum(1.0, np.abs(la))).all(), (la, lb)
    np.testing.assert_allclose(got_state["denom"], ref_state["denom"], atol=1e-6)
    np.testing.assert_allclose(got_state["xyz_grad_accum"], ref_state["xyz_grad_accum"],
                               rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(got_state["means3d"], ref_state["means3d"], atol=5e-4)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_gshard_steps_match_the_port_single_step(runs, n, variant):
    sharded, single, _, _ = runs
    got = sharded[n][0][variant]
    ref_packed, ref_state = single[variant]
    _check_step_tolerances(got["packed"], got["state"], ref_packed, ref_state)
    np.testing.assert_array_equal(got["packed"][:, 3], 0)  # no overflow
    np.testing.assert_array_equal(got["packed"][:, 5], ref_packed[:, 5])  # num_alive
    if variant == "exposure_depth":
        assert (got["packed"][:, 2] > 0).all()
        np.testing.assert_allclose(got["packed"][:, 2], ref_packed[:, 2], rtol=2e-4)
        np.testing.assert_allclose(got["state"]["exposures"], ref_state["exposures"],
                                   atol=3 * 3e-4 * 0.01, rtol=0)


@pytest.mark.parametrize("n", WORLDS)
def test_gshard_steps_match_jax_single_step(runs, n):
    sharded, _, (jpacked, jstate), _ = runs
    got = sharded[n][0]["plain"]
    aux, params = jstate.model.aux, jstate.model.params
    ref = {"denom": np.asarray(aux.denom), "xyz_grad_accum": np.asarray(aux.xyz_grad_accum),
           "means3d": np.asarray(params.means3d)}
    _check_step_tolerances(got["packed"], got["state"], jpacked, ref)


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_agree_and_shards_tile_the_capacity(runs, n):
    sharded, _, _, leaves = runs
    for r in range(1, n):
        for name, value in sharded[n][0]["plain"]["state"].items():
            np.testing.assert_array_equal(sharded[n][r]["plain"]["state"][name], value,
                                          err_msg=f"{name} on rank {r} of {n}")
    full = train_state_from_jax(**leaves, device="cpu")
    shards = [shard_state(full, r, n) for r in range(n)]
    assert all(s.model.capacity == full.model.capacity // n for s in shards)
    for name, value in full.tensors().items():
        value = value.detach()
        parts = [s.tensors()[name].detach() for s in shards]
        if value.dim() and value.shape[0] == full.model.capacity:
            np.testing.assert_array_equal(np.concatenate([p.numpy() for p in parts]),
                                          value.numpy(), err_msg=name)
        else:
            assert all(np.array_equal(p.numpy(), value.numpy()) for p in parts), name
