"""Per-image mono-depth scale and offset fits against COLMAP's sparse depth.

Counterpart of ``gaussian_splatting_tpu/data/depth_scale.py``: for each
image, project its tracked 3D points into the camera, compare their COLMAP
inverse depth with the monocular inverse-depth map sampled bilinearly at the
observed 2D locations (scaled to the map's resolution), and fit

    inv_colmap ≈ scale * inv_mono + offset

from medians and mean absolute deviations.  ``make_depth_scales`` writes
``sparse/0/depth_params.json``, which the COLMAP reader takes with ``-d``.
The 16-bit maps are read by ``data.cameras.read_depth_png``, which gives the
values OpenCV gives the JAX package.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from gaussian_splatting_torch.data import colmap as cm
from gaussian_splatting_torch.data.cameras import read_depth_png


def _bilinear_sample(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Sample img (H, W) at float (N, 2) pixel coords, border-replicate."""
    h, w = img.shape
    x = np.clip(xy[:, 0], 0.0, w - 1.0)
    y = np.clip(xy[:, 1], 0.0, h - 1.0)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _load_invdepth_png(path: str) -> Optional[np.ndarray]:
    """A 16-bit inverse-depth PNG as float32 in [0, 1); None if absent."""
    if not os.path.exists(path):
        return None
    return read_depth_png(path) / (2**16)


def fit_image_depth_scale(
    image: cm.ColmapImage,
    camera: cm.ColmapCamera,
    points3d_ordered: np.ndarray,
    depths_dir: str,
) -> Optional[dict]:
    """One image's robust (scale, offset) fit; None without a depth map."""
    pts_idx = image.point3d_ids
    mask = (pts_idx >= 0) & (pts_idx < len(points3d_ordered))
    pts_idx = pts_idx[mask]
    valid_xys = image.xys[mask]
    pts = points3d_ordered[pts_idx] if len(pts_idx) else np.zeros((1, 3))

    R = cm.qvec_to_rotmat(image.qvec)
    cam_pts = pts @ R.T + image.tvec
    inv_colmap = 1.0 / cam_pts[..., 2]

    stem = os.path.splitext(image.name)[0]
    inv_mono_map = _load_invdepth_png(os.path.join(depths_dir, stem + ".png"))
    if inv_mono_map is None:
        return None

    s = inv_mono_map.shape[0] / camera.height
    maps = (valid_xys * s).astype(np.float32)
    valid = (
        (maps[..., 0] >= 0)
        & (maps[..., 1] >= 0)
        & (maps[..., 0] < camera.width * s)
        & (maps[..., 1] < camera.height * s)
        & (inv_colmap > 0)
    )

    if valid.sum() > 10 and (inv_colmap.max() - inv_colmap.min()) > 1e-3:
        maps = maps[valid]
        ic = inv_colmap[valid]
        im = _bilinear_sample(inv_mono_map, maps)
        t_colmap = np.median(ic)
        s_colmap = np.mean(np.abs(ic - t_colmap))
        t_mono = np.median(im)
        s_mono = np.mean(np.abs(im - t_mono))
        scale = float(s_colmap / s_mono) if s_mono > 0 else 0.0
        offset = float(t_colmap - t_mono * scale)
    else:
        scale = 0.0
        offset = 0.0
    return {"image_name": stem, "scale": scale, "offset": offset}


def make_depth_scales(
    base_dir: str, depths_dir: str, model_ext: str = "bin", jobs: int = 8
) -> Dict[str, dict]:
    """Fit all images (``jobs`` threads) and write sparse/0/depth_params.json."""
    sparse = os.path.join(base_dir, "sparse", "0")
    if model_ext == "bin":
        cams = cm.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        images = cm.read_images_binary(os.path.join(sparse, "images.bin"), load_points2d=True)
        xyz, _rgb, _e, ids = cm.read_points3d_binary(
            os.path.join(sparse, "points3D.bin"), return_ids=True)
    else:
        cams = cm.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        images = cm.read_images_text(os.path.join(sparse, "images.txt"), load_points2d=True)
        xyz, _rgb, _e, ids = cm.read_points3d_text(
            os.path.join(sparse, "points3D.txt"), return_ids=True)

    ordered = np.zeros((int(ids.max()) + 1, 3)) if len(ids) else np.zeros((1, 3))
    ordered[ids] = xyz

    def one(im):
        return fit_image_depth_scale(im, cams[im.camera_id], ordered, depths_dir)

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        results = list(pool.map(one, images.values()))

    depth_params = {
        r["image_name"]: {"scale": r["scale"], "offset": r["offset"]}
        for r in results
        if r is not None
    }
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(depth_params, f, indent=2)
    return depth_params
