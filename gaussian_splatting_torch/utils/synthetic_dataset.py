"""A synthetic Blender-format dataset: a random Gaussian scene rendered
through the port from views on an orbit.

Counterpart of ``gaussian_splatting_tpu/utils/synthetic_dataset.py::
generate_blender_dataset``: the same seeded scene, poses and file layout
(``transforms_{train,test}.json`` + PNGs), written with PIL, so the whole
train -> render stack runs without an external dataset.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.ops.camera_math import look_at, make_camera
from gaussian_splatting_torch.ops.rasterize import render
from gaussian_splatting_torch.utils.image import to_uint8, write_image
from gaussian_splatting_torch.utils.testing import random_scene


def _orbit_pose(theta: float, phi: float, radius: float):
    eye = np.array([
        radius * math.cos(phi) * math.sin(theta),
        radius * math.sin(phi),
        -radius * math.cos(phi) * math.cos(theta),
    ])
    return look_at(eye, np.zeros(3)), eye


def generate_blender_dataset(
    out_dir: str,
    *,
    num_train: int = 12,
    num_test: int = 4,
    width: int = 128,
    height: int = 128,
    num_gaussians: int = 600,
    fovx: float = 0.9,
    radius: float = 4.0,
    seed: int = 0,
    device=None,
) -> str:
    dev = resolve_device(device)
    scene = random_scene(num_gaussians, sh_degree=1, width=width, height=height, seed=seed,
                         device=dev)
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)

    def render_pose(theta, phi):
        (R, t), _ = _orbit_pose(theta, phi, radius)
        cam = make_camera(R, t, fovx=fovx, fovy=fovx, width=width, height=height, device=dev)
        out = render(scene.means3d, scene.scales, scene.quats, scene.opacities, scene.sh,
                     cam, torch.zeros(3, device=dev), sh_degree=1, inference=True)
        img = out.image.cpu().numpy().transpose(1, 2, 0)
        # camera-to-world in the OpenGL convention of transforms.json
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = R.T
        Rt[:3, 3] = t
        Rt[3, 3] = 1.0
        c2w = np.linalg.inv(Rt)
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL
        return img, c2w

    rng = np.random.default_rng(seed + 1)
    for split, count in (("train", num_train), ("test", num_test)):
        frames = []
        for i in range(count):
            theta = 2 * math.pi * (i / count) + (0.3 if split == "test" else 0.0)
            phi = float(rng.uniform(-0.5, 0.5))
            img, c2w = render_pose(theta, phi)
            write_image(os.path.join(out_dir, f"{split}/r_{i}.png"), to_uint8(img))
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return out_dir
