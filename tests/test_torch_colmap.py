"""Port parity: COLMAP captures (``data/colmap.py``, the COLMAP branch of
``data/dataset.py``, ``data/depth_scale.py``) against the JAX package.

A 10-image sparse model written with JAX's writers (``images.bin`` with 2D
observations by ``utils.testing.write_images_binary_with_tracks``), plus
its text form: one PINHOLE and one SIMPLE_PINHOLE camera, image ids out of
name order, 400 points, and per image a 16-bit inverse-depth PNG at half
resolution.  The readers, ``load_sparse_model``'s fallbacks, the writers'
bytes, ``SceneInfo`` (poses, fovs, uids, the LLFF and ``test.txt`` splits,
``depth_params`` with the median scale, normalization, the written
``points3D.ply``) and the depth-scale fits must equal JAX's bit for bit;
other camera models raise JAX's ``ValueError``; and the training and render
CLIs run on the scene on the CPU with ``-i``, ``-d``, ``--eval``, ``-r`` and
``--train_test_exp``."""

import dataclasses
import json
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from gaussian_splatting_tpu.data import colmap as jcm
from gaussian_splatting_tpu.data import dataset as jds
from gaussian_splatting_tpu.data import depth_scale as jdepth
from gaussian_splatting_torch import make_depth_scale
from gaussian_splatting_torch import render as render_cli
from gaussian_splatting_torch.data import colmap as cm
from gaussian_splatting_torch.data import dataset as ds
from gaussian_splatting_torch.data import depth_scale as depth
from gaussian_splatting_torch.ops.camera_math import look_at
from gaussian_splatting_torch.train import cli
from gaussian_splatting_torch.utils.testing import write_images_binary_with_tracks

W, H, N_IMAGES, N_POINTS = 64, 48, 10, 400


def _fmt(v):
    return repr(float(v))


def write_scene(root, seed=0, models=("PINHOLE", "SIMPLE_PINHOLE")):
    """The sparse model (binary and text), images under ``imgs/`` and depth
    maps under ``depths/``."""
    rng = np.random.default_rng(seed)
    sparse = os.path.join(root, "sparse", "0")
    for d in (sparse, os.path.join(root, "imgs"), os.path.join(root, "depths")):
        os.makedirs(d)
    params = {"PINHOLE": [70.0, 66.0, W / 2, H / 2], "SIMPLE_PINHOLE": [68.0, W / 2, H / 2],
              "OPENCV": [70.0, 66.0, W / 2, H / 2, 0.01, 0.0, 0.0, 0.0]}
    cams = {i + 1: jcm.ColmapCamera(i + 1, m, W, H, np.array(params[m]))
            for i, m in enumerate(models)}
    xyz = rng.uniform(-1.0, 1.0, (N_POINTS, 3))
    rgb = rng.integers(0, 256, (N_POINTS, 3), dtype=np.uint8)
    names = rng.permutation(N_IMAGES)
    images = {}
    for k in range(N_IMAGES):
        angle = 2 * np.pi * k / N_IMAGES
        eye = [4.0 * np.sin(angle), 0.5 * np.cos(3 * angle), -4.0 * np.cos(angle)]
        R, t = look_at(eye, [0.0, 0.0, 0.0])
        w2c = R.T
        cam = cams[1 + k % len(cams)]
        fx, fy = (cam.params[0], cam.params[1]) if cam.model != "SIMPLE_PINHOLE" else (
            cam.params[0], cam.params[0])
        pc = xyz @ w2c.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + W / 2, fy * pc[:, 1] / pc[:, 2] + H / 2], -1)
        seen = np.flatnonzero((pc[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                              & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        img_id = 100 - 7 * k  # ids out of name order
        name = f"view_{names[k]:02d}.png"
        xys = uv[seen] + rng.normal(0, 0.3, (len(seen), 2))
        images[img_id] = jcm.ColmapImage(img_id, cm.rotmat_to_qvec(w2c), np.asarray(t, float),
                                         cam.id, name, xys, seen.astype(np.int64) + 1)
        Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
            os.path.join(root, "imgs", name))
        yy, xx = np.mgrid[0:H // 2, 0:W // 2]
        mono = 9000 + 300 * xx + 200 * yy * (1 + k % 3) + rng.integers(0, 400, xx.shape)
        Image.fromarray(mono.astype(np.uint16)).save(
            os.path.join(root, "depths", os.path.splitext(name)[0] + ".png"))
    jcm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    write_images_binary_with_tracks(os.path.join(sparse, "images.bin"), images)
    jcm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cams.values():
            f.write(" ".join([str(c.id), c.model, str(W), str(H)] + [_fmt(p) for p in c.params])
                    + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in images.values():
            f.write(" ".join([str(im.id)] + [_fmt(v) for v in (*im.qvec, *im.tvec)]
                             + [str(im.camera_id), im.name]) + "\n")
            f.write(" ".join(f"{_fmt(x)} {_fmt(y)} {int(i)}"
                             for (x, y), i in zip(im.xys, im.point3d_ids)) + "\n")
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        for i in range(N_POINTS):
            f.write(" ".join([str(i + 1)] + [_fmt(v) for v in xyz[i]]
                             + [str(int(v)) for v in rgb[i]] + ["1.0"]) + "\n")
    return root


@pytest.fixture
def scene(tmp_path):
    return write_scene(str(tmp_path / "scene"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _equal(a, b):
    """Two values, dataclasses, dicts or sequences equal, arrays bit for bit."""
    if dataclasses.is_dataclass(a):
        return type(a).__name__ == type(b).__name__ and all(
            _equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def test_readers_match_jax(scene):
    sparse = os.path.join(scene, "sparse", "0")

    def p(name):
        return os.path.join(sparse, name)

    for ours, theirs, name in ((cm.read_cameras_binary, jcm.read_cameras_binary, "cameras.bin"),
                               (cm.read_cameras_text, jcm.read_cameras_text, "cameras.txt")):
        assert _equal(ours(p(name)), theirs(p(name)))
    for flag in (False, True):
        ours = cm.read_images_binary(p("images.bin"), load_points2d=flag)
        assert _equal(ours, jcm.read_images_binary(p("images.bin"), load_points2d=flag))
        assert _equal(cm.read_images_text(p("images.txt"), load_points2d=flag),
                      jcm.read_images_text(p("images.txt"), load_points2d=flag))
        assert _equal(cm.read_points3d_binary(p("points3D.bin"), return_ids=flag),
                      jcm.read_points3d_binary(p("points3D.bin"), return_ids=flag))
        assert _equal(cm.read_points3d_text(p("points3D.txt"), return_ids=flag),
                      jcm.read_points3d_text(p("points3D.txt"), return_ids=flag))
    assert sum(len(im.xys) for im in ours.values()) > 10 * N_IMAGES


@pytest.mark.parametrize("keep", ["bin", "txt", "txt_points_ply", "ply", "none"])
def test_load_sparse_model_fallbacks_match_jax(scene, keep):
    """Binary cameras and images, else text; points from .bin, .txt, .ply."""
    sparse = os.path.join(scene, "sparse", "0")
    drop = {"bin": [], "txt": ["cameras.bin", "images.bin", "points3D.bin"],
            "txt_points_ply": ["cameras.bin", "images.bin", "points3D.bin", "points3D.txt"],
            "ply": ["points3D.bin", "points3D.txt"],
            "none": ["points3D.bin", "points3D.txt"]}[keep]
    if keep in ("ply", "txt_points_ply"):
        xyz, rgb, _ = cm.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        from gaussian_splatting_torch.data.ply import save_point_cloud_ply

        save_point_cloud_ply(os.path.join(sparse, "points3D.ply"), xyz.astype(np.float32), rgb)
    for name in drop:
        os.remove(os.path.join(sparse, name))
    if keep == "none":
        for load in (cm.load_sparse_model, jcm.load_sparse_model):
            with pytest.raises(FileNotFoundError):
                load(sparse)
        return
    ours, theirs = cm.load_sparse_model(sparse), jcm.load_sparse_model(sparse)
    assert _equal(ours, theirs)
    assert (ours[2][2] is None) == keep.endswith("ply")


def test_writers_write_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    cams = {3: cm.ColmapCamera(3, "PINHOLE", 640, 480, np.array([500.0, 510.0, 320.0, 240.0])),
            7: cm.ColmapCamera(7, "OPENCV", 64, 48, rng.normal(size=8))}
    images = {i: cm.ColmapImage(i, rng.normal(size=4), rng.normal(size=3), 3, f"im_{i}.jpg")
              for i in (5, 2, 9)}
    xyz32 = rng.normal(size=(257, 3)).astype(np.float32)
    rgb_f = rng.integers(0, 256, (257, 3)).astype(np.float64)
    for name, ours, theirs, args in (
        ("cameras.bin", cm.write_cameras_binary, jcm.write_cameras_binary, (cams,)),
        ("images.bin", cm.write_images_binary, jcm.write_images_binary, (images,)),
        ("points32.bin", cm.write_points3d_binary, jcm.write_points3d_binary, (xyz32, rgb_f)),
        ("points64.bin", cm.write_points3d_binary, jcm.write_points3d_binary,
         (xyz32.astype(np.float64) * 3, rgb_f.astype(np.uint8))),
        ("empty.bin", cm.write_points3d_binary, jcm.write_points3d_binary,
         (np.zeros((0, 3)), np.zeros((0, 3), np.uint8))),
    ):
        a, b = tmp_path / f"ours_{name}", tmp_path / f"theirs_{name}"
        ours(str(a), *args)
        theirs(str(b), *args)
        assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("eval_split, test_txt, depths", [
    (False, False, ""), (True, False, ""), (True, True, "depths"), (False, False, "depths"),
])
def test_scene_info_matches_jax(scene, tmp_path, eval_split, test_txt, depths):
    sparse = os.path.join(scene, "sparse", "0")
    if test_txt:
        with open(os.path.join(sparse, "test.txt"), "w") as f:
            f.write("view_03.png\n\nview_07.png\n")
    if depths:
        jdepth.make_depth_scales(scene, os.path.join(scene, "depths"), jobs=2)
        with open(os.path.join(sparse, "depth_params.json")) as f:
            params = json.load(f)
        params["view_05"]["scale"] = 0.0  # a failed fit: left out of the median
        with open(os.path.join(sparse, "depth_params.json"), "w") as f:
            json.dump(params, f)
    copy = str(tmp_path / "copy")
    shutil.copytree(scene, copy)
    kw = dict(images="imgs", depths=depths, eval_split=eval_split)
    ours, theirs = ds.detect_and_load_scene(scene, **kw), jds.detect_and_load_scene(copy, **kw)
    for a, b in zip(ours.train_cameras + ours.test_cameras,
                    theirs.train_cameras + theirs.test_cameras):
        assert _equal(dataclasses.asdict(a), {**dataclasses.asdict(b),
                                              "image_path": b.image_path.replace(copy, scene),
                                              "depth_path": b.depth_path.replace(copy, scene)})
    assert [c.uid for c in ours.train_cameras] == [c.uid for c in theirs.train_cameras]
    n_test = {(False, False): 0, (True, False): 2, (True, True): 2}[(eval_split, test_txt)]
    assert len(ours.test_cameras) == len(theirs.test_cameras) == n_test
    if test_txt:
        assert sorted(c.image_name for c in ours.test_cameras) == ["view_03.png", "view_07.png"]
    if depths:
        dp = ours.train_cameras[0].depth_params
        assert dp is not None and dp["med_scale"] > 0
    assert _equal(ours.nerf_normalization, theirs.nerf_normalization)
    assert _equal(ours.point_cloud, theirs.point_cloud)
    assert ours.is_nerf_synthetic is theirs.is_nerf_synthetic is False
    assert _bytes(ours.ply_path) == _bytes(theirs.ply_path)


@pytest.mark.parametrize("model_ext", ["bin", "txt"])
def test_depth_scale_fits_match_jax(scene, tmp_path, model_ext):
    copy = str(tmp_path / "copy")
    shutil.copytree(scene, copy)
    os.remove(os.path.join(copy, "depths", "view_02.png"))  # a view without a map
    os.remove(os.path.join(scene, "depths", "view_02.png"))
    ours = depth.make_depth_scales(scene, os.path.join(scene, "depths"), model_ext, jobs=3)
    theirs = jdepth.make_depth_scales(copy, os.path.join(copy, "depths"), model_ext, jobs=3)
    assert _equal(ours, theirs)
    assert len(ours) == N_IMAGES - 1 and all(v["scale"] > 0 for v in ours.values())
    written = [_bytes(os.path.join(root, "sparse", "0", "depth_params.json"))
               for root in (scene, copy)]
    assert written[0] == written[1]


def test_non_pinhole_camera_raises_as_jax(tmp_path):
    root = write_scene(str(tmp_path / "scene"), models=("PINHOLE", "OPENCV"))
    messages = []
    for load in (ds.read_colmap_scene, jds.read_colmap_scene):
        with pytest.raises(ValueError) as err:
            load(root, images_dir="imgs")
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "OPENCV" in messages[0]


def test_cli_trains_and_renders_a_colmap_scene(scene, tmp_path, monkeypatch):
    """make_depth_scale, then two training iterations from the sparse points
    with ``-i imgs -d depths --eval -r 2 --train_test_exp`` and the render
    CLI, all on the CPU."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the no-TB path
    params = make_depth_scale.main(["--base_dir", scene, "--depths_dir",
                                    os.path.join(scene, "depths"), "--jobs", "2"])
    assert len(params) == N_IMAGES
    out = str(tmp_path / "out")
    state = cli.main(["-s", scene, "-m", out, "-i", "imgs", "-d", "depths", "--eval", "-r", "2",
                      "--train_test_exp", "--iterations", "2", "--capacity", "1024",
                      "--disable_viewer", "--quiet", "--device", "cpu"])
    assert int(state.step) == 2
    for name in ("cameras.json", "input.ply", "exposure.json",
                 os.path.join("point_cloud", "iteration_2", "point_cloud.ply")):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)) == N_IMAGES
    # "-i" again: both packages' render CLIs let its default override the saved value
    records = render_cli.main(["-m", out, "-i", "imgs", "--skip_train", "--device", "cpu"])
    assert [r["split"] for r in records] == ["test"] * 2
    renders = os.path.join(out, "test", "ours_2", "renders")
    with Image.open(os.path.join(renders, sorted(os.listdir(renders))[0])) as im:
        assert im.size == (W // 4, H // 2)  # -r 2; train_test_exp keeps the right half
