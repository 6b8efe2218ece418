"""COLMAP sparse-model readers (binary and text) and writers.

Counterpart of ``gaussian_splatting_tpu/data/colmap.py``, with its names:
cameras, images (with their 2D observations on request) and points
(with their ids on request) from a ``sparse/0`` directory, in COLMAP's public
binary and text formats, and the binary writers.  The JAX package parses
binary models with its native library when that builds and with its Python
readers otherwise, and both give the same arrays; these are its Python
readers.  ``write_points3d_binary`` packs all points with one numpy
structured array and writes the bytes JAX's per-point ``struct.pack`` loop
writes.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_BY_NAME = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}

# one 2D observation of images.bin: x, y, point3D id (-1: none)
OBSERVATION = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
# one point of points3D.bin as the writer packs it: id, xyz, rgb, error and
# an empty track
_POINT = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                   ("err", "<f8"), ("track_len", "<u8")])


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray = None  # (M, 2) 2D observations (when load_points2d)
    point3d_ids: np.ndarray = None  # (M,) int64, -1 = no 3D point


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> COLMAP wxyz quaternion (largest-component method)."""
    K = (
        np.array(
            [
                [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
                [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
                [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
                [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
                 R[0, 0] + R[1, 1] + R[2, 2]],
            ]
        )
        / 3.0
    )
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


# ------------------------------------------------------------------ binary


def _read(f, fmt: str):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, nparams = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{nparams}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return out


def read_images_binary(path: str, load_points2d: bool = False) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            xys = p3d = None
            if load_points2d:
                rec = np.frombuffer(f.read(OBSERVATION.itemsize * npts), dtype=OBSERVATION)
                xys = np.stack([rec["x"], rec["y"]], axis=-1)
                p3d = rec["id"].copy()
            else:
                f.seek(OBSERVATION.itemsize * npts, os.SEEK_CUR)
            out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode("utf-8"), xys, p3d)
    return out


def read_points3d_binary(path: str, return_ids: bool = False):
    """Returns (xyz (N,3) f64, rgb (N,3) u8, errors (N,)) [+ ids (N,) i64]."""
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        ids = np.empty((n,), np.int64)
        for i in range(n):
            data = _read(f, "<Q3d3Bd")
            ids[i] = data[0]
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    if return_ids:
        return xyz, rgb, err, ids
    return xyz, rgb, err


# ------------------------------------------------------------------ text


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            out[cam_id] = ColmapCamera(
                cam_id,
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return out


def read_images_text(path: str, load_points2d: bool = False) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    for meta, pts_line in zip(lines[0::2], lines[1::2]):
        parts = meta.split()
        img_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        xys = p3d = None
        if load_points2d:
            vals = np.array(pts_line.split(), np.float64).reshape(-1, 3)
            xys = vals[:, :2]
            p3d = vals[:, 2].astype(np.int64)
        out[img_id] = ColmapImage(img_id, qvec, tvec, int(parts[8]), parts[9], xys, p3d)
    return out


def read_points3d_text(path: str, return_ids: bool = False):
    xyz, rgb, err, ids = [], [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ids.append(int(parts[0]))
            xyz.append([float(p) for p in parts[1:4]])
            rgb.append([int(p) for p in parts[4:7]])
            err.append(float(parts[7]))
    out = (
        np.asarray(xyz, np.float64),
        np.asarray(rgb, np.uint8),
        np.asarray(err, np.float64),
    )
    if return_ids:
        return out + (np.asarray(ids, np.int64),)
    return out


# ------------------------------------------------------------------ writers


def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, nparams = _MODEL_BY_NAME[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{nparams}d", *cam.params))


def write_images_binary(path: str, images: Dict[int, ColmapImage]) -> None:
    """Poses and names; every image with no 2D observations."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Points with ids 1..N, error 1.0 and empty tracks."""
    rec = np.zeros(len(xyz), _POINT)
    rec["id"] = np.arange(1, len(xyz) + 1)
    rec["xyz"] = xyz
    rec["rgb"] = np.asarray(rgb).astype(np.uint8)
    rec["err"] = 1.0
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        f.write(rec.tobytes())


def load_sparse_model(sparse_dir: str):
    """(cameras, images, (xyz, rgb, errors)) of a sparse model: binary
    cameras and images, else text; points from ``points3D.bin``, else
    ``points3D.txt``, else ``points3D.ply`` (errors ``None``)."""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
    pts_bin = os.path.join(sparse_dir, "points3D.bin")
    pts_txt = os.path.join(sparse_dir, "points3D.txt")
    pts_ply = os.path.join(sparse_dir, "points3D.ply")
    if os.path.exists(pts_bin):
        xyz, rgb, err = read_points3d_binary(pts_bin)
    elif os.path.exists(pts_txt):
        xyz, rgb, err = read_points3d_text(pts_txt)
    elif os.path.exists(pts_ply):
        from gaussian_splatting_torch.data.ply import load_point_cloud_ply

        pts, colors, _ = load_point_cloud_ply(pts_ply)
        xyz, rgb, err = pts.astype(np.float64), (colors * 255).astype(np.uint8), None
    else:
        raise FileNotFoundError(f"no points3D.{{bin,txt,ply}} in {sparse_dir}")
    return cams, imgs, (xyz, rgb, err)
