"""The port's render CLI on the CPU against the repository's root
``render.py`` (the JAX CLI) on the same 64x48, 2-view Blender scene and
model PLY: every rendered PNG within 1/255, and the ground-truth PNGs equal.

The JAX CLI runs with ``rasterizer_impl="dense"`` (its oracle, which shares
the tiled path's preprocess and agrees with it within 2e-4), so the test
stays within seconds; the port runs its tiled path."""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_torch import render as port_render
from gaussian_splatting_torch.data.ply import save_gaussian_ply, save_point_cloud_ply
from gaussian_splatting_torch.ops.camera_math import look_at
from gaussian_splatting_torch.utils.testing import random_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 48


def _write_fixture(root):
    scene = os.path.join(root, "scene")
    model = os.path.join(root, "model")
    os.makedirs(os.path.join(scene, "train"))
    rng = np.random.default_rng(0)
    frames = []
    for i, eye in enumerate(([0.3, -0.2, -4.0], [-1.0, -0.3, -3.8])):
        R, _ = look_at(eye, [0.0, 0.0, 0.0])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1  # Blender stores OpenGL axes
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(scene, "train", f"r_{i}.png"))
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
    with open(os.path.join(scene, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    save_point_cloud_ply(os.path.join(scene, "points3d.ply"),
                         rng.uniform(-1, 1, (100, 3)).astype(np.float32),
                         rng.integers(0, 256, (100, 3), dtype=np.uint8))

    means, scales, quats, opac, sh = random_arrays(150, sh_degree=1, seed=2,
                                                   scale_range=(0.02, 0.08))
    pc = os.path.join(model, "point_cloud", "iteration_7")
    os.makedirs(pc)
    save_gaussian_ply(os.path.join(pc, "point_cloud.ply"), means3d=means,
                      features_dc=sh[:, :1], features_rest=sh[:, 1:],
                      opacities=np.log(opac / (1 - opac)), scales=np.log(scales),
                      quats=quats)
    with open(os.path.join(model, "cfg_args.json"), "w") as f:
        json.dump({"sh_degree": 1, "source_path": scene, "model_path": model}, f)
    return model


def _run_jax_cli(model_dir, monkeypatch):
    spec = importlib.util.spec_from_file_location("jax_render_cli", os.path.join(REPO, "render.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(sys, "argv", ["render.py", "-m", model_dir])
    cli.main()


def _pngs(model_dir, kind):
    d = os.path.join(model_dir, "train", "ours_7", kind)
    return [np.asarray(Image.open(os.path.join(d, f)), np.int16) for f in sorted(os.listdir(d))]


def test_render_cli_matches_jax_cli(tmp_path, monkeypatch):
    port_dir = _write_fixture(str(tmp_path))
    jax_dir = str(tmp_path / "model_jax")
    shutil.copytree(port_dir, jax_dir)
    with open(os.path.join(jax_dir, "pipe_args.json"), "w") as f:
        json.dump({"rasterizer_impl": "dense"}, f)

    records = port_render.main(["-m", port_dir, "--device", "cpu"])
    _run_jax_cli(jax_dir, monkeypatch)

    assert [r["retries"] for r in records] == [0, 0]
    ours, theirs = _pngs(port_dir, "renders"), _pngs(jax_dir, "renders")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape == (H, W, 3)
        assert np.abs(a - b).max() <= 1
        assert a.max() > 20  # the views see the Gaussians
    for a, b in zip(_pngs(port_dir, "gt"), _pngs(jax_dir, "gt")):
        np.testing.assert_array_equal(a, b)


def test_render_cli_rejects_colmap_scenes(tmp_path):
    """A ``sparse/`` directory is read as a COLMAP capture, so one without a
    model is refused as JAX's reader refuses it (COLMAP captures themselves
    render: tests/test_torch_colmap.py)."""
    from gaussian_splatting_tpu.data.dataset import detect_and_load_scene as jax_detect

    model = _write_fixture(str(tmp_path))
    colmap = tmp_path / "colmap"
    (colmap / "sparse").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="cameras.txt"):
        jax_detect(str(colmap))
    with pytest.raises(FileNotFoundError, match="cameras.txt"):
        port_render.main(["-m", model, "-s", str(colmap), "--device", "cpu"])
