"""Port parity: Blender scenes with depth maps (``-d`` / ``ModelConfig.depths``).

A 2-view Blender scene at 48x32 with a depth PNG per view: a 16-bit
single-channel map at the image's size, and an 8-bit 3-channel map whose
blue and red channels differ, at 30x20 so it goes through the NEAREST
resize.  Both packages' readers and camera loaders must give the same
``invdepth`` and ``depth_mask`` bit for bit (the JAX loader reads the PNG
with OpenCV, the port with PIL); the port's Scene must pass the depth
directory through; a train step on those maps must carry JAX's depth term;
and the training CLI with ``-d`` must train with it."""

import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import RasterizeConfig as JaxRaster
from gaussian_splatting_tpu.data.cameras import CameraInfo as JaxCameraInfo
from gaussian_splatting_tpu.data.cameras import load_camera as jax_load_camera
from gaussian_splatting_tpu.data.dataset import detect_and_load_scene as jax_detect
from gaussian_splatting_tpu.models.gaussians import create_from_pcd
from gaussian_splatting_tpu.train import step as jstep
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.data.cameras import CameraInfo, load_camera, read_depth_png
from gaussian_splatting_torch.data.dataset import detect_and_load_scene
from gaussian_splatting_torch.data.ply import save_point_cloud_ply
from gaussian_splatting_torch.interop import train_state_from_jax
from gaussian_splatting_torch.ops.camera_math import look_at
from gaussian_splatting_torch.scene import Scene
from gaussian_splatting_torch.train import cli
from gaussian_splatting_torch.train import loop as tloop
from gaussian_splatting_torch.train import step as tstep
from gaussian_splatting_torch.utils.testing import random_scene

W, H = 48, 32


def _write_scene(root):
    """Two train views (r_0, r_1) looking at the origin, their depth maps
    under ``depths/``, and a 300-point ``points3d.ply``."""
    rng = np.random.default_rng(11)
    os.makedirs(os.path.join(root, "train"))
    os.makedirs(os.path.join(root, "depths"))
    frames = []
    for i, eye in enumerate(([0.0, -0.3, -4.0], [3.0, -0.3, -2.6])):
        R, _ = look_at(eye, [0.0, 0.0, 0.0])
        c2w = np.eye(4)
        c2w[:3, :3], c2w[:3, 3] = R, eye
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, as Blender stores them
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(root, "train", f"r_{i}.png"))
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    # r_0: 16-bit gray at the image's size, inverse depth 0.1-0.6 after / 512
    Image.fromarray(rng.integers(50, 300, (H, W), dtype=np.uint16)).save(
        os.path.join(root, "depths", "r_0.png"))
    # r_1: 8-bit RGB at 30x20; OpenCV's channel 0 (blue) is the map, red is not
    rgb = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    rgb[..., 0] = 255 - rgb[..., 2]
    Image.fromarray(rgb).save(os.path.join(root, "depths", "r_1.png"))
    pts = rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32)
    save_point_cloud_ply(os.path.join(root, "points3d.ply"), pts,
                         rng.integers(0, 256, (300, 3), dtype=np.uint8))
    return root


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return _write_scene(str(tmp_path_factory.mktemp("depth_scene")))


@pytest.fixture(scope="module")
def loaded(scene_dir):
    """Each view's (JAX camera, port camera), read by each package's reader."""
    j = jax_detect(scene_dir, depths="depths", eval_split=True)
    t = detect_and_load_scene(scene_dir, images="images", depths="depths", eval_split=True)
    assert [c.image_name for c in t.train_cameras] == [c.image_name for c in j.train_cameras]
    assert t.is_nerf_synthetic and j.is_nerf_synthetic
    return [(jax_load_camera(jc, is_synthetic=True, exposure_idx=i),
             load_camera(tc, is_synthetic=True, exposure_idx=i, device="cpu"))
            for i, (jc, tc) in enumerate(zip(j.train_cameras, t.train_cameras))]


@pytest.mark.parametrize("view", [0, 1])
def test_depth_maps_match_jax_bitwise(loaded, scene_dir, view):
    jc, tc = loaded[view]
    assert tc.info.depth_path == jc.info.depth_path == os.path.join(
        scene_dir, "depths", f"r_{view}.png")
    assert tc.info.depth_params is None and jc.info.depth_params is None
    assert tc.invdepth.dtype == np.float32 and tc.invdepth.shape == (H, W)
    np.testing.assert_array_equal(tc.invdepth, jc.invdepth)
    np.testing.assert_array_equal(tc.depth_mask, jc.depth_mask)
    assert tc.depth_mask.min() == 1.0
    assert 0.0 < tc.invdepth.max() <= (255.0 if view else 300.0) / 512.0


def test_depth_params_scale_and_rejection_match_jax(scene_dir):
    """The COLMAP-side fit: scale and offset applied, the mask zeroed when
    the scale is off by more than 5x from the median."""
    common = dict(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=0.9, fovy=0.7,
                  image_path=os.path.join(scene_dir, "train", "r_1.png"), image_name="r_1.png",
                  width=W, height=H, depth_path=os.path.join(scene_dir, "depths", "r_1.png"))
    for dp in ({"scale": 1.7, "offset": 0.05, "med_scale": 1.2},
               {"scale": 9.0, "offset": -0.1, "med_scale": 1.2},
               {"scale": 0.0, "offset": 0.3, "med_scale": 1.2}):
        j = jax_load_camera(JaxCameraInfo(**common, depth_params=dict(dp)), resolution=2)
        t = load_camera(CameraInfo(**common, depth_params=dict(dp)), resolution=2, device="cpu")
        assert t.invdepth.shape == (H // 2, W // 2)
        np.testing.assert_array_equal(t.invdepth, j.invdepth)
        np.testing.assert_array_equal(t.depth_mask, j.depth_mask)


def test_depth_png_forms(tmp_path):
    """Gray+alpha and palette maps read as OpenCV's channel 0; a 16-bit
    colour map, which PIL reads at 8 bits, raises with its form named."""
    import cv2

    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    forms = {"la": Image.fromarray(px[..., :2], "LA"),
             "p": Image.fromarray(px, "RGB").quantize(16),
             "one_bit": Image.fromarray(px[..., 0] > 128)}
    for name, im in forms.items():
        path = str(tmp_path / f"{name}.png")
        im.save(path)
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32)
        np.testing.assert_array_equal(read_depth_png(path), raw[..., 0] if raw.ndim > 2 else raw)
    path = str(tmp_path / "rgb16.png")
    cv2.imwrite(path, rng.integers(0, 65536, (6, 5, 3), dtype=np.uint16))
    with pytest.raises(ValueError, match="16-bit RGB"):
        read_depth_png(path)


def test_scene_passes_depths_through(scene_dir, loaded, tmp_path):
    cfg = ModelConfig(source_path=scene_dir, model_path=str(tmp_path / "m"), depths="depths",
                      eval=True)
    scene = Scene(cfg, shuffle=False, capacity=512, device="cpu")
    for cam, (jc, _) in zip(scene.get_train_cameras(), loaded):
        np.testing.assert_array_equal(cam.invdepth, jc.invdepth)
        np.testing.assert_array_equal(cam.depth_mask, jc.depth_mask)
    no_depth = Scene(ModelConfig(source_path=scene_dir, model_path=str(tmp_path / "n")),
                     shuffle=False, capacity=512, device="cpu")
    assert all(c.invdepth is None for c in no_depth.get_train_cameras())


@pytest.mark.parametrize("view", [0, 1])
def test_train_step_depth_term_matches_jax(loaded, view):
    """One step of the port (tiled path, kernels' twins) against JAX's
    dense-render step, with the view's depth map as the target."""
    jcam_loaded, tcam_loaded = loaded[view]
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.8, 0.8, (120, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (120, 3)).astype(np.float32)
    jstate = jstep.init_train_state(
        create_from_pcd(pts, cols, max_sh_degree=2, spatial_lr_scale=1.5, capacity=256),
        num_images=2)
    gt = tcam_loaded.image
    jb = jstep.StepBatch(
        gt_image=jnp.asarray(gt), alpha_mask=jnp.ones((1, H, W)),
        invdepth_gt=jnp.asarray(jcam_loaded.invdepth),
        depth_mask=jnp.asarray(jcam_loaded.depth_mask),
        exposure_idx=jnp.asarray(view, jnp.int32), bg_color=jnp.zeros(3))
    tb = tloop.make_batch(tcam_loaded, np.zeros(3, np.float32))
    jcam = jax_random_scene(4, width=W, height=H, seed=1).cam
    tcam = random_scene(4, width=W, height=H, seed=1, device="cpu").cam
    opt = dict(depth_l1_weight_init=2.0)
    fn = jax.jit(partial(jstep.train_step, opt=JaxOpt(**opt), raster=JaxRaster(impl="dense"),
                         use_depth=True))
    _, jm = fn(jstate, jcam, jb)
    m = jstate.model
    tree = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}
    tstate = train_state_from_jax(
        params=tree(m.params), aux=tree(m.aux),
        adam=(np.asarray(jstate.adam.count), tree(jstate.adam.mu), tree(jstate.adam.nu)),
        exposures=np.asarray(jstate.exposures),
        exp_adam=(np.asarray(jstate.exp_adam.count), np.asarray(jstate.exp_adam.mu),
                  np.asarray(jstate.exp_adam.nu)),
        step=np.asarray(jstate.step), spatial_lr_scale=float(m.spatial_lr_scale),
        sh_degree=int(m.sh_degree), max_sh_degree=m.max_sh_degree, device="cpu")
    _, tm = tstep.train_step(tstate, tcam, tb, opt=OptimizationConfig(**opt),
                             raster=RasterizeConfig(), use_depth=True)
    assert float(tm["depth_loss"]) > 0
    for name in ("loss", "depth_loss"):
        assert abs(float(tm[name]) - float(jm[name])) <= 1e-5, name


def test_cli_trains_with_depth_maps(scene_dir, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the no-TB path
    seen = []
    real_step = tloop.train_step

    def train_step(state, cam, batch, **kw):
        state, metrics = real_step(state, cam, batch, **kw)
        seen.append((kw["use_depth"], float(batch.invdepth_gt.abs().sum()),
                     float(metrics["depth_loss"])))
        return state, metrics

    monkeypatch.setattr(tloop, "train_step", train_step)
    state = cli.main(["-s", scene_dir, "-m", str(tmp_path / "out"), "-d", "depths",
                      "--capacity", "512", "--disable_viewer", "--device", "cpu",
                      "--iterations", "2"])
    assert int(state.step) == 2 and len(seen) == 2
    assert all(use and gt > 0 and loss > 0 for use, gt, loss in seen), seen
