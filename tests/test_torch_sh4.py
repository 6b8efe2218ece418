"""Port parity at SH degree 4 (25 coefficients per channel).

- The dense render of a degree-4 scene against JAX's ``impl="dense"``
  render: image within 2e-4, gradients within 3e-4 of each one's largest
  magnitude (the JAX suite's tolerances).
- One training step at active degree 4 against JAX's dense ``train_step``,
  both from one state carried across by ``interop``, at
  ``tests/test_torch_train_step.py``'s tolerances.
- ``activated_params``'s degree mask at K = 25 against JAX's, and
  ``grow_capacity`` keeping it.
- Degree-4 PLY snapshots (72 ``f_rest_*`` columns) written by either package
  and read by the other, bit for bit; a snapshot of another degree raises
  ``ValueError`` in both.
- The training CLI with ``--sh_degree 4 --device cpu``: trains, snapshots,
  resumes and renders; a resume that names another degree raises, and so
  does the CLI without ``--device cpu`` when there is no card.
"""

import dataclasses
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu import scene as jscene
from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.models.gaussians import create_from_pcd
from gaussian_splatting_tpu.ops.rasterize import render as jax_render
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_tpu.train.loop import _activated_params as jax_activated_params
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch import render as render_cli
from gaussian_splatting_torch import scene as tscene
from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.data.ply import read_ply, save_point_cloud_ply
from gaussian_splatting_torch.interop import jax_state_leaves, train_state_from_jax
from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, grow_capacity, load_model_ply
from gaussian_splatting_torch.ops.rasterize import render
from gaussian_splatting_torch.train import cli
from gaussian_splatting_torch.train import step as tstep
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset
from gaussian_splatting_torch.utils.testing import random_scene

DEG, K = 4, 25
W, H, N = 48, 32, 200
CAP = 256


def _weights():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(3, H, W)).astype(np.float32),
            (0.1 * rng.normal(size=(H, W))).astype(np.float32))


def test_dense_render_and_gradients_match_jax():
    js = jax_random_scene(N, sh_degree=DEG, width=W, height=H, seed=2)
    ts = random_scene(N, sh_degree=DEG, width=W, height=H, seed=2, device="cpu")
    assert ts.sh.shape == (N, K, 3)
    wimg, winvd = _weights()

    def jloss(*leaves):
        out = jax_render(*leaves, js.cam, js.bg, sh_degree=DEG, impl="dense")
        return jnp.sum(out.image * wimg) + jnp.sum(out.invdepth * winvd), out.image

    jleaves = (js.means3d, js.scales, js.quats, js.opacities, js.sh)
    jgrads, jimage = jax.jit(jax.grad(jloss, argnums=tuple(range(5)), has_aux=True))(*jleaves)
    leaves = [t.clone().requires_grad_(True)
              for t in (ts.means3d, ts.scales, ts.quats, ts.opacities, ts.sh)]
    out = render(*leaves, ts.cam, ts.bg, sh_degree=DEG, impl="dense")
    loss = (out.image * torch.from_numpy(wimg)).sum() + (out.invdepth * torch.from_numpy(winvd)).sum()
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(jimage), atol=2e-4, rtol=0)
    for name, t, j in zip(("means3d", "scales", "quats", "opacities", "sh"), grads, jgrads):
        j = np.asarray(j)
        scale = np.abs(j).max() + 1e-8
        assert scale > 1e-8, name
        np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=3e-4, err_msg=name)
    # the degree-4 block reaches the image: its coefficients get gradients
    assert np.abs(np.asarray(jgrads[4])[:, 16:]).max() > 0


def _jax_model(seed=3, n=120, capacity=CAP):
    """A degree-4 JAX model at active degree 4 with nonzero coefficients."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, max_sh_degree=DEG, spatial_lr_scale=1.5,
                            capacity=capacity)
    rest = np.zeros((capacity, K - 1, 3), np.float32)
    rest[:n] = rng.normal(0.0, 0.1, (n, K - 1, 3))
    params = model.params._replace(features_rest=jnp.asarray(rest))
    return dataclasses.replace(model, params=params, sh_degree=jnp.asarray(DEG, jnp.int32))


def test_one_train_step_at_degree_4_matches_jax():
    jstate = jstep.init_train_state(_jax_model(), num_images=2)
    rng = np.random.default_rng(4)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    jcam = jax_random_scene(4, width=W, height=H, seed=1).cam
    tcam = random_scene(4, width=W, height=H, seed=1, device="cpu").cam
    jb = jstep.StepBatch(gt_image=jnp.asarray(gt), alpha_mask=jnp.ones((1, H, W)),
                         invdepth_gt=jnp.zeros((H, W)), depth_mask=jnp.zeros((H, W)),
                         exposure_idx=jnp.asarray(0, jnp.int32), bg_color=jnp.zeros(3))
    tb = tstep.StepBatch(torch.from_numpy(gt), torch.ones((1, H, W)), torch.zeros((H, W)),
                         torch.zeros((H, W)), torch.tensor(0), torch.zeros(3))
    fn = jax.jit(partial(jstep.train_step, opt=JaxOpt(), raster=JaxRaster(impl="dense")))
    jnew, jm = fn(jstate, jcam, jb)
    tstate = train_state_from_jax(**jax_state_leaves(jstate), device="cpu")
    assert tstate.model.sh_degree == tstate.model.max_sh_degree == DEG
    assert tstate.model.features_rest.shape == (CAP, K - 1, 3)
    tstate, tm = tstep.train_step(tstate, tcam, tb, opt=OptimizationConfig(),
                                  raster=RasterizeConfig())
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    assert not bool(tm["overflow"])
    lrs = {k: float(v) for k, v in jstep.group_lrs(JaxOpt(), 1, 1.5)._asdict().items()}
    for name in PARAM_NAMES:
        for t, j in ((tstate.adam.mu[name], getattr(jnew.adam.mu, name)),
                     (tstate.adam.nu[name], getattr(jnew.adam.nu, name))):
            j = np.asarray(j)
            scale = np.abs(j).max() + 1e-30
            np.testing.assert_allclose(t.numpy() / scale, j / scale, atol=3e-4, err_msg=name)
        g = np.asarray(getattr(jnew.adam.mu, name)) / 0.1  # the first step's gradient
        solid = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(getattr(tstate.model, name).detach().numpy()[solid],
                                   np.asarray(getattr(jnew.model.params, name))[solid],
                                   atol=3e-4 * lrs[name], rtol=0, err_msg=name)
    # active degree 4: the degree-4 coefficients (rest indices 15..23) train
    assert float(tstate.adam.mu["features_rest"][:, 15:].abs().max()) > 0
    # and the leaves carried back agree with the ones carried across
    back = jax_state_leaves(jnew)
    assert back["params"]["features_rest"].shape == (CAP, K - 1, 3)
    assert back["sh_degree"] == back["max_sh_degree"] == DEG


@pytest.mark.parametrize("active", [0, 1, 2, 3, 4])
def test_activated_params_mask_at_25_coefficients(active):
    jmodel = dataclasses.replace(_jax_model(n=40, capacity=64),
                                 sh_degree=jnp.asarray(active, jnp.int32))
    tmodel = train_state_from_jax(**jax_state_leaves(jstep.init_train_state(jmodel, 1)),
                                  device="cpu").model
    sh_t = tmodel.activated_params()[4]
    sh_j = np.asarray(jax_activated_params(jmodel)[4])
    np.testing.assert_array_equal(sh_t.detach().numpy(), sh_j)
    kept = (sh_t[:40] != 0).any(dim=(0, 2)).numpy()
    degree = np.repeat(np.arange(DEG + 1), [1, 3, 5, 7, 9])
    np.testing.assert_array_equal(kept, degree <= active)
    grown = grow_capacity(tmodel, 96)  # empty slots of 25 coefficients
    assert grown.features_rest.shape == (96, K - 1, 3) and grown.sh_degree == active
    assert torch.equal(grown.activated_params()[4][:64], sh_t)
    assert not bool(grown.features_rest[64:].any())


def test_degree_4_ply_round_trips_between_packages(tmp_path):
    jmodel = _jax_model()
    jpath, tpath = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jscene.save_model_ply(jpath, jmodel)
    assert sum(k.startswith("f_rest_") for k in read_ply(jpath)) == 3 * (K - 1) == 72
    tmodel = load_model_ply(jpath, max_sh_degree=DEG, device="cpu")
    n = int(np.asarray(jmodel.aux.alive).sum())
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(tmodel, name).detach().numpy()[:n],
                                      np.asarray(getattr(jmodel.params, name))[:n], name)
    tscene.save_model_ply(tpath, tmodel)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()  # the port writes JAX's bytes
    back = jscene.load_model_ply(tpath, max_sh_degree=DEG)
    assert int(back.sh_degree) == tmodel.sh_degree == DEG
    for name in PARAM_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(back.params, name))[:n],
                                      getattr(tmodel, name).detach().numpy()[:n], name)

    # a snapshot of another degree is refused alike, either way round
    for deg in (3, 2):
        with pytest.raises(ValueError):
            jscene.load_model_ply(jpath, max_sh_degree=deg)
        with pytest.raises(ValueError, match="SH coefficients"):
            load_model_ply(jpath, max_sh_degree=deg, device="cpu")
    d3 = str(tmp_path / "deg3.ply")
    jscene.save_model_ply(d3, create_from_pcd(
        np.zeros((5, 3), np.float32), np.full((5, 3), 0.5, np.float32), max_sh_degree=3,
        spatial_lr_scale=1.0, capacity=8))
    with pytest.raises(ValueError):
        jscene.load_model_ply(d3, max_sh_degree=DEG)
    with pytest.raises(ValueError, match="SH coefficients"):
        load_model_ply(d3, max_sh_degree=DEG, device="cpu")


@pytest.fixture
def dataset(tmp_path):
    out = str(tmp_path / "scene")
    generate_blender_dataset(out, num_train=3, num_test=1, width=32, height=24,
                             num_gaussians=150, device="cpu")
    rng = np.random.default_rng(5)
    save_point_cloud_ply(os.path.join(out, "points3d.ply"),
                         rng.uniform(-0.8, 0.8, (200, 3)).astype(np.float32),
                         rng.integers(0, 256, (200, 3), dtype=np.uint8))
    return out


def test_cli_trains_resumes_and_renders_at_degree_4(dataset, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the no-TB path
    out = str(tmp_path / "out")

    def args(degree, model_dir=out):
        return ["-s", dataset, "-m", model_dir, "--eval", "--sh_degree", str(degree),
                "--capacity", "512", "--test_iterations", "3", "--checkpoint_iterations",
                "3", "--disable_viewer"]

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(args(DEG) + ["--iterations", "3"])
    argv = args(DEG) + ["--device", "cpu"]
    state = cli.main(argv + ["--iterations", "3"])
    assert int(state.step) == 3 and state.model.max_sh_degree == DEG
    assert state.model.features_rest.shape[1] == K - 1
    snap = os.path.join(out, "point_cloud", "iteration_3", "point_cloud.ply")
    assert sum(k.startswith("f_rest_") for k in read_ply(snap)) == 72

    ckpt = os.path.join(out, "chkpnt3.pth")
    with pytest.raises(ValueError, match="SH degree 4, not 3"):
        cli.main(args(3, str(tmp_path / "other")) + ["--device", "cpu", "--iterations", "5",
                                                     "--start_checkpoint", ckpt])
    resumed = cli.main(argv + ["--iterations", "5", "--start_checkpoint", ckpt])
    assert int(resumed.step) == 5 and resumed.model.max_sh_degree == DEG

    records = render_cli.main(["-m", out, "--device", "cpu"])
    assert [r["split"] for r in records] == ["train"] * 3 + ["test"]
    assert os.path.isdir(os.path.join(out, "test", "ours_5", "renders"))
