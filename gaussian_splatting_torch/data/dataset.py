"""Scene readers.  This slice reads Blender (NeRF-synthetic) scenes.

Counterpart of the Blender half of ``gaussian_splatting_tpu/data/
dataset.py``: the OpenGL -> COLMAP axis flip, nerf++ normalization (camera
centroid radius * 1.1), the 100k-random-point init when the scene has
no ``points3d.ply``, and with a depth directory each view's depth map at
``<scene>/<depths>/<image stem>.png``.  COLMAP scenes belong to the next
slice of the port (the COLMAP reader with depth-scale fits).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List

import numpy as np

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
    ``images`` (COLMAP only), ``depths``, ``eval_split`` and
    ``white_background``."""
    if os.path.exists(os.path.join(path, "sparse")):
        raise NotImplementedError(
            "COLMAP scenes are not ported yet: the COLMAP reader with depth maps "
            "and native decoding is the next slice of the port"
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
