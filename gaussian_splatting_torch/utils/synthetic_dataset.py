"""Synthetic Blender-format datasets, so the whole train -> render ->
metrics stack runs without an external dataset.

Counterpart of ``gaussian_splatting_tpu/utils/synthetic_dataset.py``, with
the same seeds, poses and file layout (``transforms_{train,test}.json`` +
PNGs, written with PIL):

- ``generate_blender_dataset``: a random Gaussian scene rendered through the
  port from views on an orbit.
- ``generate_analytic_dataset``: the raytraced analytic scenes
  (``ANALYTIC_SCENES``), whose ground truth does not come from the renderer
  under test, with exact inverse-depth maps and per-image exposure jitter.
  JAX keeps a float64 numpy shader and a jitted float32 copy; here one torch
  shader, ``shade_analytic``, takes the dtype: float64 on the CPU (held to
  JAX's numpy shader), float32 on the card.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

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


# --------------------------------------------------------------------------
# Analytic ground truth: textured spheres over a checkered disk, lit by two
# shadowing lights, raytraced without any Gaussian.  The scene tables are
# drawn by numpy's default_rng with JAX's seeds, so both packages trace the
# same scene.
# --------------------------------------------------------------------------

_PALETTE = np.array(
    [
        [0.85, 0.25, 0.2], [0.2, 0.55, 0.85], [0.95, 0.75, 0.2],
        [0.3, 0.75, 0.4], [0.8, 0.4, 0.75], [0.9, 0.55, 0.3],
        [0.35, 0.8, 0.8], [0.6, 0.6, 0.9],
    ]
)
_LIGHTS = [
    (np.array([0.45, 0.8, 0.35]) / np.linalg.norm([0.45, 0.8, 0.35]), 0.75),
    (np.array([-0.6, 0.55, -0.5]) / np.linalg.norm([-0.6, 0.55, -0.5]), 0.45),
]
_AMBIENT = 0.25

# In increasing difficulty: spheres (8 textured spheres over a checkered
# disk), thicket (48 small spheres with fine textures over a fine checker),
# glossy (Blinn-Phong speculars over a cluttered two-tier layout).
ANALYTIC_SCENES = ("spheres", "thicket", "glossy")


def _analytic_scene(seed: int = 0, name: str = "spheres"):
    """(spheres, plane): a list of dicts with keys c/r/base/alt/tex/freq/
    spec/shin (spec 0 is pure Lambertian) and the disk's dict, drawn as the
    JAX package draws them."""
    rng = np.random.default_rng(seed)
    palette = _PALETTE

    def sphere(pos, r, k, freq, spec=0.0, shin=32.0):
        return {
            "c": np.asarray(pos, np.float64),
            "r": float(r),
            "base": palette[k % 8],
            "alt": palette[(k + 3) % 8] * 0.35 + 0.6,
            "tex": k % 4,  # 0 checker, 1 stripes, 2 dots, 3 gradient
            "freq": float(freq),
            "spec": float(spec),
            "shin": float(shin),
        }

    plane = {"y": -1.0, "rad": 3.4, "c1": np.array([0.92, 0.92, 0.9]),
             "c2": np.array([0.18, 0.2, 0.24]), "scale": 1.25}
    spheres = []

    if name == "spheres":
        # a ring of six and two central ones, resting near the plane
        for k in range(8):
            if k < 6:
                ang = 2 * math.pi * k / 6
                r = 0.38 + 0.12 * ((k * 2654435761) % 97) / 97.0
                pos = [1.55 * math.cos(ang), -1.0 + r, 1.55 * math.sin(ang)]
            elif k == 6:
                r = 0.75
                pos = [0.0, -1.0 + r, 0.0]
            else:
                r = 0.3
                pos = [0.0, -1.0 + 1.5 + 0.45, 0.0]
            spheres.append(sphere(pos, r, k, rng.uniform(5.0, 9.0)))
    elif name == "thicket":
        # thin structures: a grounded ring of pebbles and a floating cluster
        plane = dict(plane, scale=5.0)
        for k in range(48):
            u = rng.uniform()
            ang = 2 * math.pi * rng.uniform()
            if k % 3 == 0:
                r = rng.uniform(0.08, 0.16)
                rad = 1.1 + 1.3 * u
                pos = [rad * math.cos(ang), -1.0 + r, rad * math.sin(ang)]
            else:
                r = rng.uniform(0.06, 0.18)
                rad = 0.35 + 1.35 * u
                y = -0.75 + 1.5 * rng.uniform()
                pos = [rad * math.cos(ang), y, rad * math.sin(ang)]
            spheres.append(sphere(pos, r, k, rng.uniform(16.0, 32.0)))
    elif name == "glossy":
        # strong view dependence: a ring, a stack and glossy satellites
        for k in range(8):
            if k < 6:
                ang = 2 * math.pi * k / 6 + 0.3
                r = 0.34 + 0.14 * ((k * 40503) % 89) / 89.0
                pos = [1.5 * math.cos(ang), -1.0 + r, 1.5 * math.sin(ang)]
            elif k == 6:
                r = 0.7
                pos = [0.0, -1.0 + r, 0.0]
            else:
                r = 0.34
                pos = [0.0, -1.0 + 1.4 + 0.5, 0.0]
            spheres.append(
                sphere(pos, r, k, rng.uniform(7.0, 13.0),
                       spec=rng.uniform(0.5, 0.9),
                       shin=rng.uniform(24.0, 64.0))
            )
        for k in range(8, 18):
            ang = 2 * math.pi * rng.uniform()
            rad = 0.9 + 1.5 * rng.uniform()
            r = rng.uniform(0.1, 0.2)
            y = -1.0 + r + 1.1 * rng.uniform()
            spheres.append(
                sphere([rad * math.cos(ang), y, rad * math.sin(ang)], r, k,
                       rng.uniform(10.0, 18.0),
                       spec=rng.uniform(0.4, 0.8), shin=48.0)
            )
    else:
        raise ValueError(f"unknown analytic scene: {name}")
    return spheres, plane


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (..., 3) tensors, summed in index order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sphere_hit(orig: torch.Tensor, d: torch.Tensor, center: torch.Tensor,
                radius: float) -> torch.Tensor:
    """Ray parameter of the first hit in front of the origin, inf on a miss;
    from inside the sphere, the far hit."""
    oc = orig - center
    b = _dot(d, oc)
    c = _dot(oc, oc) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t > 1e-4, t, -b + sq)
    return torch.where((disc > 0.0) & (t > 1e-4), t, math.inf)


def _checker(u: torch.Tensor, v: torch.Tensor, scale) -> torch.Tensor:
    return (torch.floor(u * scale) + torch.floor(v * scale)) % 2.0


def shade_analytic(orig, d, spheres, plane, dtype: Optional[torch.dtype] = None):
    """Trace rays ``d`` (N, 3, unit) from ``orig`` ((3,) or (N, 3)) through
    the scene; returns (rgb (N, 3) in [0, 1], alpha (N,), t (N,)) in
    ``dtype`` on ``d``'s device.  ``t`` is the hit's ray parameter (inf on
    the background), from which the exact camera depth follows.

    ``dtype`` defaults to float64 on the CPU, where it follows JAX's numpy
    shader operation for operation, and float32 on the card.  Every ray is
    shaded with its winning surface's parameters, gathered, where JAX's
    numpy shader loops over compressed index sets; per ray the arithmetic
    is the same."""
    d = torch.as_tensor(d)
    dev = d.device
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    d = d.to(dtype)
    orig = torch.as_tensor(orig).to(device=dev, dtype=dtype)

    def table(key):
        return torch.tensor(np.array([s[key] for s in spheres]), dtype=dtype, device=dev)

    centers, bases, alts = table("c"), table("base"), table("alt")
    freqs, specs, shins = table("freq"), table("spec"), table("shin")
    texs = torch.tensor([s["tex"] for s in spheres], device=dev)
    radii = [s["r"] for s in spheres]

    n = d.shape[0]
    best_t = torch.full((n,), math.inf, dtype=dtype, device=dev)
    best_id = torch.full((n,), -1, dtype=torch.long, device=dev)  # -2: the plane
    for i, r in enumerate(radii):
        t = _sphere_hit(orig, d, centers[i], r)
        hit = t < best_t
        best_t = torch.where(hit, t, best_t)
        best_id = torch.where(hit, i, best_id)
    orig_n = orig.expand_as(d)
    denom = d[:, 1]
    tp = torch.where(denom.abs() > 1e-8, (plane["y"] - orig_n[:, 1]) / denom, math.inf)
    px = orig_n[:, 0] + tp * d[:, 0]
    pz = orig_n[:, 2] + tp * d[:, 2]
    on_disk = (tp > 1e-4) & (px * px + pz * pz < plane["rad"] ** 2)
    hit = on_disk & (tp < best_t)
    best_t = torch.where(hit, tp, best_t)
    best_id = torch.where(hit, -2, best_id)

    alpha = (best_id != -1).to(dtype)
    is_plane = best_id == -2
    p = orig + torch.where(torch.isfinite(best_t), best_t, 0.0)[:, None] * d

    # the winning sphere's parameters (sphere 0's on the plane and misses,
    # which the selects below discard)
    sid = best_id.clamp(min=0)
    radius = torch.tensor(radii, dtype=dtype, device=dev)[sid]
    nrm_s = (p - centers[sid]) / radius[:, None]
    theta = torch.arccos(torch.clamp(nrm_s[:, 1], -1.0, 1.0))
    phi = torch.atan2(nrm_s[:, 2], nrm_s[:, 0])
    f = freqs[sid]
    tex = texs[sid]
    m = torch.where(
        tex == 0, _checker(phi / (2 * math.pi) + 1.0, theta / math.pi, f),
        torch.where(
            tex == 1, (torch.sin(theta * f * 2.0) > 0).to(dtype),
            torch.where(tex == 2, ((torch.sin(phi * f) * torch.sin(theta * f)) > 0.3).to(dtype),
                        0.5 + 0.5 * torch.sin(theta * 3.0))))
    base_s = bases[sid] * (1 - m[:, None]) + alts[sid] * m[:, None]
    ck = _checker(p[:, 0], p[:, 2], plane["scale"])
    c1 = torch.tensor(plane["c1"], dtype=dtype, device=dev)
    c2 = torch.tensor(plane["c2"], dtype=dtype, device=dev)
    base_p = torch.where(ck[:, None] > 0.5, c1, c2)

    # two lights with hard shadows from every sphere; Blinn-Phong speculars
    # on the spheres that have them
    up = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=dev)
    nrm = torch.where(is_plane[:, None], up, nrm_s)
    spec = torch.where(is_plane, 0.0, specs[sid])
    shin = shins[sid]
    has_spec = any(s["spec"] > 0.0 for s in spheres)
    po = p + 1e-3 * nrm
    lit = torch.full((n,), _AMBIENT, dtype=dtype, device=dev)
    sp = torch.zeros((n,), dtype=dtype, device=dev)
    for ldir_np, lpow in _LIGHTS:
        ldir = torch.tensor(ldir_np, dtype=dtype, device=dev)
        lam = torch.clamp(_dot(nrm, ldir), min=0.0)
        shadow = torch.zeros((n,), dtype=torch.bool, device=dev)
        for i, r in enumerate(radii):
            shadow |= torch.isfinite(_sphere_hit(po, ldir, centers[i], r))
        unsh = lpow * (~shadow).to(dtype)
        lit = lit + unsh * lam
        if has_spec:
            h = ldir - d
            h = h / torch.sqrt(_dot(h, h))[:, None]
            sp = sp + unsh * spec * torch.clamp(_dot(nrm, h), min=0.0) ** shin
    rgb = torch.where(is_plane[:, None], base_p * lit[:, None],
                      base_s * lit[:, None] + sp[:, None])
    rgb = torch.where((best_id == -1)[:, None], 0.0, torch.clamp(rgb, 0.0, 1.0))
    return rgb, alpha, best_t


def generate_analytic_dataset(
    out_dir: str,
    *,
    num_train: int = 100,
    num_test: int = 12,
    width: int = 800,
    height: int = 600,
    fovx: float = 0.85,
    radius: float = 4.4,
    seed: int = 0,
    supersample: int = 2,
    scene_name: str = "spheres",
    depths: bool = False,
    exposure_jitter: float = 0.0,
    device=None,
) -> str:
    """A Blender-format dataset (transforms_{train,test}.json + RGBA PNGs)
    of one of ``ANALYTIC_SCENES``, raytraced at ``supersample``^2 rays a
    pixel and box-filtered.  Train with ``--white_background``, as the
    reference's NeRF-synthetic protocol does.

    depths: also write the exact inverse camera depth of each view to
      ``depths/<stem>.png`` as 16-bit PNGs at the Blender /512 scale, for
      the ``--use_depth`` ablation.
    exposure_jitter: if > 0, each train image gets a random per-channel gain
      and offset of that size (the test views stay clean), for the
      ``--use_expcomp`` ablation.

    Each view is shaded on ``device`` (the card unless the caller asks for
    the CPU) and moved to the host once."""
    dev = resolve_device(device)
    spheres, plane = _analytic_scene(seed, scene_name)
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)
    if depths:
        os.makedirs(os.path.join(out_dir, "depths"), exist_ok=True)

    s = supersample
    W, H = width * s, height * s
    f = 0.5 * W / math.tan(fovx / 2.0)
    jj, ii = np.meshgrid(np.arange(W), np.arange(H))
    xs = (jj.ravel() + 0.5 - W / 2) / f
    ys = (ii.ravel() + 0.5 - H / 2) / f
    d_cam = torch.from_numpy(np.stack([xs, ys, np.ones_like(xs)], axis=1)).to(dev)
    # camera z per unit ray parameter (the rays are normalised): z = t / |d_cam|
    inv_dnorm = 1.0 / torch.sqrt(_dot(d_cam, d_cam))

    rng = np.random.default_rng(seed + 1)

    def render_pose(theta, phi):
        (R, t), eye = _orbit_pose(theta, phi, radius)
        d = d_cam @ torch.from_numpy(R.T).to(dev)  # R is cam-to-world
        d = d / torch.sqrt(_dot(d, d))[:, None]
        rgb, alpha, thit = shade_analytic(torch.from_numpy(eye), d, spheres, plane)
        img = torch.cat([rgb, alpha[:, None]], dim=1).to(torch.float64)
        thit = thit.to(torch.float64)
        # the exact inverse camera depth (0 on the background); both box
        # filtered, as the renderer accumulates alpha-weighted inverse depth
        invd = torch.where(torch.isfinite(thit), inv_dnorm / torch.clamp(thit, min=1e-6), 0.0)
        planes = torch.cat([img, invd[:, None]], dim=1).reshape(height, s, width, s, 5)
        planes = planes.mean(dim=(1, 3)).cpu().numpy()
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = R.T
        Rt[:3, 3] = t
        Rt[3, 3] = 1.0
        c2w = np.linalg.inv(Rt)
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL
        return planes[..., :4], planes[..., 4], c2w

    for split, count in (("train", num_train), ("test", num_test)):
        frames = []
        for i in range(count):
            # golden-angle azimuth sweep, elevation varied deterministically
            theta = 2 * math.pi * ((i * 0.618034) % 1.0) + (0.26 if split == "test" else 0.0)
            phi = float(0.12 + 0.55 * ((i * 29) % count) / max(count - 1, 1))
            if split == "test":
                phi = float(0.15 + 0.5 * (i / max(num_test - 1, 1)))
            img, invd, c2w = render_pose(theta, phi)
            if exposure_jitter > 0.0 and split == "train":
                gain = 1.0 + rng.uniform(-exposure_jitter, exposure_jitter, (3,))
                off = rng.uniform(-0.25 * exposure_jitter, 0.25 * exposure_jitter, (3,))
                img = img.copy()
                img[..., :3] = img[..., :3] * gain + off * img[..., 3:4]
            # stems unique across splits: a depth map is looked up by stem
            k = i if split == "train" else num_train + i
            write_image(os.path.join(out_dir, f"{split}/r_{k}.png"), to_uint8(img))
            if depths:
                write_image(os.path.join(out_dir, f"depths/r_{k}.png"),
                            np.minimum(invd * 512.0, 65535.0).astype(np.uint16))
            frames.append({"file_path": f"./{split}/r_{k}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as fjs:
            json.dump({"camera_angle_x": fovx, "frames": frames}, fjs)
    return out_dir
