"""Port parity for the start of training: ``create_from_pcd`` (with the
subsample past capacity and both KNN paths), the training ``Scene`` on a
``generate_blender_dataset`` scene (camera order under one ``random.seed``,
``cameras.json``, ``input.ply``, ``cameras_extent``, the model and a saved
snapshot) and ``load_camera``'s alpha / ``train_test_exp`` masks, each
against the JAX package.  Images stay at native resolution, so no
resampler differs."""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.config import ModelConfig as JaxModelConfig
from gaussian_splatting_tpu.data.cameras import CameraInfo as JaxCameraInfo
from gaussian_splatting_tpu.data.cameras import load_camera as jax_load_camera
from gaussian_splatting_tpu.data.ply import load_gaussian_ply as jax_load_gaussian_ply
from gaussian_splatting_tpu.models.gaussians import create_from_pcd as jax_create_from_pcd
from gaussian_splatting_tpu.scene import Scene as JaxScene
from gaussian_splatting_torch.config import ModelConfig
from gaussian_splatting_torch.data.cameras import CameraInfo, load_camera
from gaussian_splatting_torch.data.ply import load_gaussian_ply
from gaussian_splatting_torch.models.gaussians import create_from_pcd
from gaussian_splatting_torch.scene import Scene
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset

PARAMS = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")


def _assert_model_matches(tm, jm):
    assert tm.capacity == jm.capacity
    np.testing.assert_array_equal(tm.alive.numpy(), np.asarray(jm.aux.alive))
    for name in PARAMS:
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(getattr(jm.params, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    assert tm.sh_degree == int(jm.sh_degree) == 0 and tm.max_sh_degree == jm.max_sh_degree
    assert tm.spatial_lr_scale == pytest.approx(float(jm.spatial_lr_scale), rel=1e-7)


@pytest.mark.parametrize("n, capacity", [(3000, None), (3000, 2048), (21000, None)])
def test_create_from_pcd_matches_jax(n, capacity):
    """Exact 3-NN, the subsample past capacity, and the window 3-NN."""
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    jm = jax_create_from_pcd(pts, cols, max_sh_degree=2, spatial_lr_scale=1.7,
                             capacity=capacity)
    tm = create_from_pcd(pts, cols, max_sh_degree=2, spatial_lr_scale=1.7, capacity=capacity,
                         device="cpu")
    assert tm.capacity == (capacity or int(n * 1.5) + 1024)
    assert int(tm.num_alive()) == min(n, tm.capacity)
    _assert_model_matches(tm, jm)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("scene"))
    generate_blender_dataset(out, num_train=6, num_test=3, width=48, height=32,
                             num_gaussians=200, device="cpu")
    return out


def test_training_scene_matches_jax(dataset, tmp_path):
    kw = dict(source_path=dataset, eval=True)
    random.seed(11)
    js = JaxScene(JaxModelConfig(model_path=str(tmp_path / "jax"), **kw), capacity=2048)
    random.seed(11)
    ts = Scene(ModelConfig(model_path=str(tmp_path / "port"), **kw), capacity=2048,
               device="cpu")

    for split in ("get_train_cameras", "get_test_cameras"):
        tc, jc = getattr(ts, split)(), getattr(js, split)()
        assert [c.image_name for c in tc] == [c.image_name for c in jc]
        for t, j in zip(tc, jc):
            np.testing.assert_array_equal(t.image, j.image)
            assert t.exposure_idx == j.exposure_idx and t.alpha_mask is None
            np.testing.assert_allclose(t.cam.projmatrix.numpy(), np.asarray(j.cam.projmatrix),
                                       rtol=0, atol=1e-6)
    assert [c.image_name for c in ts.get_train_cameras()] != [f"r_{i}.png" for i in range(6)]
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-12)

    def read(root, name):
        with open(os.path.join(root, name), "rb") as f:
            return f.read()

    assert read(tmp_path / "port", "input.ply") == read(tmp_path / "jax", "input.ply")
    tj, jj = (json.loads(read(tmp_path / d, "cameras.json")) for d in ("port", "jax"))
    assert len(tj) == len(jj) == 9
    for a, b in zip(tj, jj):
        assert a.keys() == b.keys() and a["img_name"] == b["img_name"] and a["id"] == b["id"]
        for k in ("position", "rotation", "fx", "fy"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-12, atol=1e-12)
    _assert_model_matches(ts.gaussians, js.gaussians)

    # snapshot: PLY of the alive slots + exposure.json
    import jax.numpy as jnp
    import torch

    exposures = np.tile(np.eye(3, 4, dtype=np.float32), (6, 1, 1))
    exposures[2, 0, 3] = 0.25
    ts.save(7, ts.gaussians, torch.from_numpy(exposures))
    js.save(7, js.gaussians, jnp.asarray(exposures))
    ply = os.path.join("point_cloud", "iteration_7", "point_cloud.ply")
    ours = load_gaussian_ply(os.path.join(tmp_path, "port", ply))
    theirs = jax_load_gaussian_ply(os.path.join(tmp_path, "jax", ply))
    assert ours["means3d"].shape == (2048, 3)
    for name in PARAMS:
        np.testing.assert_allclose(ours[name], theirs[name], atol=1e-6, rtol=1e-6)
    assert json.loads(read(tmp_path / "port", "exposure.json")) == json.loads(
        read(tmp_path / "jax", "exposure.json"))


@pytest.mark.parametrize("channels, white_background, train_test_exp, is_test", [
    (4, False, False, False), (4, True, False, False), (4, False, True, True),
    (4, True, True, True), (4, False, True, False), (3, False, True, True),
])
def test_load_camera_masks_match_jax(tmp_path, channels, white_background, train_test_exp,
                                     is_test):
    rng = np.random.default_rng(channels)
    path = str(tmp_path / "view.png")
    Image.fromarray(rng.integers(0, 256, (48, 64, channels), dtype=np.uint8)).save(path)
    common = dict(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=0.9, fovy=0.7,
                  image_path=path, image_name="view.png", width=64, height=48, is_test=is_test)
    kw = dict(resolution=-1, white_background=white_background, train_test_exp=train_test_exp,
              exposure_idx=3)
    j = jax_load_camera(JaxCameraInfo(**common), **kw)
    t = load_camera(CameraInfo(**common), device="cpu", **kw)
    np.testing.assert_array_equal(t.image, j.image)
    assert (t.alpha_mask is None) == (j.alpha_mask is None)
    if j.alpha_mask is not None:
        np.testing.assert_array_equal(t.alpha_mask, j.alpha_mask)
    assert t.exposure_idx == j.exposure_idx == 3
    assert t.invdepth is None and t.depth_mask is None
