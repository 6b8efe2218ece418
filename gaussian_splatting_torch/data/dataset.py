"""Scene readers: COLMAP captures and Blender (NeRF-synthetic) scenes.

Counterpart of ``gaussian_splatting_tpu/data/dataset.py``: nerf++
normalization (camera centroid radius * 1.1) and, with a depth directory,
each view's depth map at ``<scene>/<depths>/<image stem>.png``.  COLMAP:
images sorted by name with their COLMAP ids as uids, PINHOLE and
SIMPLE_PINHOLE cameras only, the LLFF hold-out of every 8th image or
``sparse/0/test.txt``, the per-image depth-scale fits of
``sparse/0/depth_params.json`` with their median scale, and
``sparse/0/points3D.ply`` written from the sparse points when absent.
Blender: the OpenGL -> COLMAP axis flip and the 100k-random-point init when
the scene has no ``points3d.ply``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from gaussian_splatting_torch.data import colmap as cm
from gaussian_splatting_torch.data.cameras import CameraInfo
from gaussian_splatting_torch.data.ply import load_point_cloud_ply, save_point_cloud_ply
from gaussian_splatting_torch.ops.camera_math import focal_to_fov, fov_to_focal
from gaussian_splatting_torch.utils.image import image_size


@dataclass
class PointCloud:
    points: np.ndarray  # (N, 3)
    colors: np.ndarray  # (N, 3) in [0, 1]
    normals: np.ndarray  # (N, 3)


@dataclass
class SceneInfo:
    point_cloud: PointCloud
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str
    is_nerf_synthetic: bool = False


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = []
    for info in cam_infos:
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = info.R.T
        Rt[:3, 3] = info.T
        Rt[3, 3] = 1.0
        centers.append(np.linalg.inv(Rt)[:3, 3])
    centers = np.stack(centers, axis=0)
    center = centers.mean(axis=0)
    radius = np.linalg.norm(centers - center, axis=-1).max() * 1.1
    return {"translate": -center, "radius": float(radius)}


def read_colmap_scene(
    path: str,
    images_dir: str = "images",
    depths_dir: str = "",
    eval_split: bool = False,
    llffhold: int = 8,
) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    cams, images, (xyz, rgb, _err) = cm.load_sparse_model(sparse)

    depth_params = None
    dp_path = os.path.join(sparse, "depth_params.json")
    if depths_dir and os.path.exists(dp_path):
        with open(dp_path) as f:
            depth_params = json.load(f)
        scales = np.array([p["scale"] for p in depth_params.values()])
        med = float(np.median(scales[scales > 0])) if (scales > 0).any() else 0.0
        for p in depth_params.values():
            p["med_scale"] = med

    test_names: Optional[set] = None
    test_txt = os.path.join(sparse, "test.txt")
    if eval_split and os.path.exists(test_txt):
        with open(test_txt) as f:
            test_names = {ln.strip() for ln in f if ln.strip()}

    infos: List[CameraInfo] = []
    for idx, (img_id, im) in enumerate(sorted(images.items(), key=lambda kv: kv[1].name)):
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE) supported "
                f"(got {cam.model})"
            )
        stem = os.path.splitext(im.name)[0]
        if test_names is not None:
            is_test = im.name in test_names
        else:
            is_test = eval_split and idx % llffhold == 0
        infos.append(
            CameraInfo(
                uid=img_id,
                R=cm.qvec_to_rotmat(im.qvec).T,
                T=im.tvec,
                fovx=focal_to_fov(fx, cam.width),
                fovy=focal_to_fov(fy, cam.height),
                image_path=os.path.join(path, images_dir, im.name),
                image_name=im.name,
                width=cam.width,
                height=cam.height,
                depth_path=os.path.join(path, depths_dir, stem + ".png") if depths_dir else "",
                depth_params=depth_params.get(stem) if depth_params else None,
                is_test=is_test,
            )
        )

    train = [c for c in infos if not (eval_split and c.is_test)]
    test = [c for c in infos if c.is_test] if eval_split else []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        save_point_cloud_ply(ply_path, xyz.astype(np.float32), rgb)
    return SceneInfo(
        point_cloud=PointCloud(
            points=xyz.astype(np.float32),
            colors=rgb.astype(np.float32) / 255.0,
            normals=np.zeros_like(xyz, dtype=np.float32),
        ),
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
        is_nerf_synthetic=False,
    )


def _read_transforms(path: str, transforms_file: str, extension: str, depths_dir: str,
                     is_test: bool):
    with open(os.path.join(path, transforms_file)) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    infos = []
    for idx, frame in enumerate(meta["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        width, height = image_size(image_path)
        name = os.path.basename(file_path)
        stem = os.path.splitext(name)[0]
        infos.append(
            CameraInfo(
                uid=idx,
                R=np.transpose(w2c[:3, :3]),
                T=w2c[:3, 3],
                fovx=fovx,
                fovy=focal_to_fov(fov_to_focal(fovx, width), height),
                image_path=image_path,
                image_name=name,
                width=width,
                height=height,
                depth_path=os.path.join(path, depths_dir, stem + ".png") if depths_dir else "",
                depth_params=None,
                is_test=is_test,
            )
        )
    return infos


def read_blender_scene(
    path: str,
    white_background: bool = False,
    eval_split: bool = True,
    extension: str = ".png",
    depths_dir: str = "",
) -> SceneInfo:
    train = _read_transforms(path, "transforms_train.json", extension, depths_dir, False)
    test = (
        _read_transforms(path, "transforms_test.json", extension, depths_dir, True)
        if os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train = train + test
        test = []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        print(f"Generating random point cloud ({n})...")
        rng = np.random.default_rng(0)
        xyz = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
        colors = rng.random((n, 3)).astype(np.float32)
        save_point_cloud_ply(ply_path, xyz, (colors * 255).astype(np.uint8))
    points, colors, normals = load_point_cloud_ply(ply_path)
    return SceneInfo(
        point_cloud=PointCloud(points=points, colors=colors, normals=normals),
        train_cameras=train,
        test_cameras=test,
        nerf_normalization=get_nerfpp_norm(train),
        ply_path=ply_path,
        is_nerf_synthetic=True,
    )


def detect_and_load_scene(path: str, **kw) -> SceneInfo:
    """The scene at ``path``, as JAX's reader takes it: keywords
    ``images`` (COLMAP only), ``depths``, ``eval_split`` (default False for
    COLMAP, True for Blender) and ``white_background``."""
    if os.path.exists(os.path.join(path, "sparse")):
        return read_colmap_scene(
            path,
            images_dir=kw.get("images", "images"),
            depths_dir=kw.get("depths", ""),
            eval_split=kw.get("eval_split", False),
        )
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        print("Found transforms_train.json file, assuming Blender data set!")
        return read_blender_scene(
            path,
            white_background=kw.get("white_background", False),
            eval_split=kw.get("eval_split", True),
            depths_dir=kw.get("depths", ""),
        )
    raise ValueError(f"Could not recognize scene type for {path}")
