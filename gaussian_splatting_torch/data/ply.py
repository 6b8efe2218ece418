"""Minimal PLY I/O (binary little-endian), byte-compatible with the 3DGS
ecosystem's model snapshots.

The port's own copy of ``gaussian_splatting_tpu/data/ply.py`` (numpy only).

The reference uses the ``plyfile`` package; this image doesn't ship it, and
the format is trivial, so we implement exactly what the framework needs:

- generic vertex-element read/write of float/uchar properties,
- the Gaussian snapshot schema of ``GaussianModel.save_ply/load_ply``
  (scene/gaussian_model.py:288-380): x,y,z, nx,ny,nz, f_dc_*, f_rest_*
  (channel-major), opacity, scale_*, rot_* — so models interchange with
  every other 3DGS tool/viewer,
- the COLMAP points3D.ply written by ``Scene.__init__``
  (scene/dataset_readers.py:205-218: x,y,z,nx,ny,nz,red,green,blue).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": np.float32,
    "float32": np.float32,
    "double": np.float64,
    "float64": np.float64,
    "uchar": np.uint8,
    "uint8": np.uint8,
    "char": np.int8,
    "short": np.int16,
    "ushort": np.uint16,
    "int": np.int32,
    "int32": np.int32,
    "uint": np.uint32,
}
_NAMES = {np.float32: "float", np.float64: "double", np.uint8: "uchar", np.int32: "int"}


def write_ply(path: str, names: List[str], columns: List[np.ndarray]) -> None:
    """Write one 'vertex' element with the given property columns."""
    n = len(columns[0])
    rec = np.rec.fromarrays([np.ascontiguousarray(c) for c in columns], names=names)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, col in zip(names, columns):
            tname = _NAMES[np.dtype(col.dtype).type]
            f.write(f"property {tname} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the first 'vertex' element into a dict of 1-D arrays."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    if "binary_little_endian" not in header[1]:
        raise ValueError(f"unsupported PLY format: {header[1]!r}")
    count = 0
    fields: List[Tuple[str, np.dtype]] = []
    in_vertex = False
    for line in header[2:]:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported")
            fields.append((parts[2], np.dtype(_DTYPES[parts[1]])))
    dt = np.dtype([(name, d) for name, d in fields])
    arr = np.frombuffer(data, dtype=dt, count=count, offset=header_end)
    return {name: np.ascontiguousarray(arr[name]) for name, _ in fields}


# ---------------------------------------------------------------- gaussians


def save_gaussian_ply(path: str, *, means3d, features_dc, features_rest, opacities, scales, quats) -> None:
    """Write the reference snapshot schema (gaussian_model.py:303-320).

    Inputs are raw (pre-activation) arrays for N live Gaussians:
    features_dc (N,1,3), features_rest (N,K-1,3), opacities logits (N,),
    scales log (N,3), quats (N,4).
    """
    n = means3d.shape[0]
    means3d = np.asarray(means3d, np.float32)
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(n, -1)
    names = ["x", "y", "z", "nx", "ny", "nz"]
    cols = [means3d[:, 0], means3d[:, 1], means3d[:, 2]]
    cols += [np.zeros(n, np.float32)] * 3
    for i in range(f_dc.shape[1]):
        names.append(f"f_dc_{i}")
        cols.append(f_dc[:, i])
    for i in range(f_rest.shape[1]):
        names.append(f"f_rest_{i}")
        cols.append(f_rest[:, i])
    names.append("opacity")
    cols.append(np.asarray(opacities, np.float32).reshape(n))
    sc = np.asarray(scales, np.float32)
    for i in range(3):
        names.append(f"scale_{i}")
        cols.append(sc[:, i])
    qt = np.asarray(quats, np.float32)
    for i in range(4):
        names.append(f"rot_{i}")
        cols.append(qt[:, i])
    write_ply(path, names, cols)


def load_gaussian_ply(path: str):
    """Inverse of save_gaussian_ply (gaussian_model.py:329-380)."""
    props = read_ply(path)
    n = len(props["x"])
    means3d = np.stack([props["x"], props["y"], props["z"]], axis=-1).astype(np.float32)
    f_dc_names = sorted(
        (k for k in props if k.startswith("f_dc_")), key=lambda s: int(s.split("_")[-1])
    )
    f_rest_names = sorted(
        (k for k in props if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    f_dc = np.stack([props[k] for k in f_dc_names], axis=-1).reshape(n, 3, 1)
    k_rest = len(f_rest_names) // 3
    f_rest = np.stack([props[k] for k in f_rest_names], axis=-1).reshape(n, 3, k_rest)
    opac = props["opacity"].astype(np.float32)
    scales = np.stack([props[f"scale_{i}"] for i in range(3)], axis=-1).astype(np.float32)
    quats = np.stack([props[f"rot_{i}"] for i in range(4)], axis=-1).astype(np.float32)
    return dict(
        means3d=means3d,
        features_dc=f_dc.transpose(0, 2, 1),
        features_rest=f_rest.transpose(0, 2, 1),
        opacities=opac,
        scales=scales,
        quats=quats,
    )


# ---------------------------------------------------------------- point clouds


def save_point_cloud_ply(path: str, points: np.ndarray, colors_u8: np.ndarray) -> None:
    """x,y,z,nx,ny,nz,red,green,blue — the reference's input.ply schema."""
    n = points.shape[0]
    pts = np.asarray(points, np.float32)
    nrm = np.zeros((n, 3), np.float32)
    col = np.asarray(colors_u8, np.uint8)
    write_ply(
        path,
        ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
        [pts[:, 0], pts[:, 1], pts[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2], col[:, 0], col[:, 1], col[:, 2]],
    )


def load_point_cloud_ply(path: str):
    props = read_ply(path)
    points = np.stack([props["x"], props["y"], props["z"]], axis=-1).astype(np.float32)
    if "red" in props:
        colors = (
            np.stack([props["red"], props["green"], props["blue"]], axis=-1).astype(np.float32)
            / 255.0
        )
    else:
        colors = np.full_like(points, 0.5)
    if "nx" in props:
        normals = np.stack([props["nx"], props["ny"], props["nz"]], axis=-1).astype(np.float32)
    else:
        normals = np.zeros_like(points)
    return points, colors, normals
