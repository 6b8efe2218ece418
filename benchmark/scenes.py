"""Scenes made from a seed: Gaussians at a configuration's published size,
a ring of cameras, target images, and the COLMAP capture that holds them.

Everything is drawn on the device with one ``torch.Generator`` per part,
in a few large calls, so the same seed gives the same scene and set-up
stays short.  Sizes and the spatial layout come from the configuration file
(``assumed`` holds what the source does not state); the seed changes the
values, never the sizes.
"""

from __future__ import annotations

import hashlib
import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

PARAM_NAMES = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")
STAT_NAMES = ("xyz_grad_accum", "denom", "max_radii2d")
ENCODE_THREADS = 4


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one part of the run, from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit wxyz quaternion with w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * math.sqrt(tr + 1.0)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * math.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = [0.0] * 4
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q) * (1.0 if q[0] >= 0 else -1.0)


def ring_poses(n: int, radius: float, height: float, phase: float = 0.0
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """COLMAP poses (world -> camera qvec, tvec) of ``n`` cameras evenly
    spaced on a horizontal ring about the z axis, each looking at the
    origin (x right, y down, z forward).  ``phase`` shifts the ring by that
    fraction of one spacing."""
    up = np.array([0.0, 0.0, 1.0])
    out = []
    for i in range(n):
        th = 2.0 * math.pi * (i + phase) / n
        eye = np.array([radius * math.cos(th), radius * math.sin(th), height])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        out.append((rotmat_to_qvec(R), -R @ eye))
    return out


def camera_centre(qvec: np.ndarray, tvec: np.ndarray) -> np.ndarray:
    from benchmark.reference.render import qvec_to_rotmat

    return -qvec_to_rotmat(qvec).T @ np.asarray(tvec)


def scene_extent(poses) -> float:
    """The method's scene extent: 1.1 times the largest distance of a
    camera centre from their mean."""
    c = np.stack([camera_centre(q, t) for q, t in poses])
    return float(np.linalg.norm(c - c.mean(0), axis=1).max() * 1.1)


def positions(n: int, layout: dict, g: torch.Generator, device) -> torch.Tensor:
    """``n`` points: a share in a ball about the origin (the object the
    cameras circle), the rest in a shell beyond the cameras (the
    background), uniform in direction and in the log of the radius."""
    n_obj = int(round(n * layout["object_share"]))
    d = torch.randn(n, 3, generator=g, device=device)
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    u = torch.rand(n, generator=g, device=device)
    r_obj = layout["object_radius"] * u[:n_obj] ** (1.0 / 3.0)
    lo, hi = layout["background_radius"]
    r_bg = lo * (hi / lo) ** u[n_obj:]
    return d * torch.cat([r_obj, r_bg])[:, None]


def gaussians(cfg: dict, seed: int, device, capacity: int, alive_first: bool
              ) -> Dict[str, torch.Tensor]:
    """Stored parameters of ``cfg["num_gaussians"]`` live Gaussians in
    ``capacity`` slots (pre-activation: log-scales, opacity logits, wxyz
    quaternions, SH coefficients), and ``alive``.  Dead slots hold the
    empty values (opacity logit -10, identity rotation).  Live slots come
    first with ``alive_first``, else at random places."""
    a = cfg["assumed"]
    n = cfg["num_gaussians"]
    K = (cfg["sh_degree"] + 1) ** 2
    g = generator(seed, "gaussians", device)
    means = positions(n, a["layout"], g, device)
    r = torch.linalg.vector_norm(means, dim=1, keepdim=True)
    lo, hi = (math.log(s) for s in a["scale_range"])
    # background Gaussians grow with their distance, so they cover as many
    # pixels as the object's do
    grow = torch.clamp(r / a["layout"]["object_radius"], min=1.0)
    scales = torch.rand(n, 3, generator=g, device=device) * (hi - lo) + lo + torch.log(grow)
    quats = torch.randn(n, 4, generator=g, device=device)
    mu, sd = a["opacity_logit"]
    opac = torch.randn(n, generator=g, device=device) * sd + mu
    dc = torch.randn(n, 1, 3, generator=g, device=device) * a["sh_dc_std"]
    rest = torch.randn(n, K - 1, 3, generator=g, device=device) * a["sh_rest_std"]
    if alive_first:
        slot = torch.arange(n, device=device)
    else:
        slot = torch.randperm(capacity, generator=g, device=device)[:n]
    out = {
        "means3d": torch.zeros(capacity, 3, device=device),
        "features_dc": torch.zeros(capacity, 1, 3, device=device),
        "features_rest": torch.zeros(capacity, K - 1, 3, device=device),
        "opacities": torch.full((capacity,), -10.0, device=device),
        "scales": torch.zeros(capacity, 3, device=device),
        "quats": torch.zeros(capacity, 4, device=device),
        "alive": torch.zeros(capacity, dtype=torch.bool, device=device),
    }
    out["quats"][:, 0] = 1.0
    for name, v in (("means3d", means), ("features_dc", dc), ("features_rest", rest),
                    ("opacities", opac), ("scales", scales), ("quats", quats)):
        out[name][slot] = v
    out["alive"][slot] = True
    return out


def optimizer_state(params: Dict[str, torch.Tensor], cfg: dict, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """Adam moments and densification statistics of a run at the resume
    iteration: second moments of the assumed gradient scale per group,
    first moments a fraction of their root, statistics of a hundred
    iterations since the last densification."""
    a = cfg["assumed"]["optimizer_state"]
    g = generator(seed, "optimizer", device)
    alive = params["alive"]
    out = {}
    for k in PARAM_NAMES:
        shape = params[k].shape
        rows = alive.reshape((-1,) + (1,) * (len(shape) - 1))
        s = a["grad_scale"][k]
        nu = (torch.randn(shape, generator=g, device=device) * s) ** 2 + (0.1 * s) ** 2
        mu = torch.randn(shape, generator=g, device=device) * (a["mu_share"] * torch.sqrt(nu))
        out["mu." + k] = mu * rows
        out["nu." + k] = nu * rows
    c = alive.shape[0]
    denom = torch.randint(0, a["stat_steps"] + 1, (c,), generator=g, device=device).float()
    out["denom"] = denom * alive
    share = torch.rand(c, generator=g, device=device)
    out["xyz_grad_accum"] = denom * share * a["tap_scale"] * alive
    out["max_radii2d"] = torch.randint(0, 40, (c,), generator=g, device=device).float() * alive
    return out


def target_images(n: int, width: int, height: int, seed: int, device, batch: int = 8):
    """``n`` smooth images (H, W, 3) uint8 in [13, 242] (no pure black or
    white, so the L1 term has no ties), a sum of random low-frequency
    waves per view; yielded one at a time on the host."""
    g = generator(seed, "targets", device)
    ys = torch.linspace(0.0, 1.0, height, device=device)[:, None]
    xs = torch.linspace(0.0, 1.0, width, device=device)[None, :]
    for b0 in range(0, n, batch):
        b = min(batch, n - b0)
        waves = 6
        f = torch.rand(b, waves, 3, 2, generator=g, device=device) * 12.0 + 0.5
        ph = torch.rand(b, waves, 3, generator=g, device=device) * (2 * math.pi)
        amp = torch.rand(b, waves, 3, generator=g, device=device) * (0.3 / waves)
        base = torch.rand(b, 3, generator=g, device=device) * 0.5 + 0.25
        img = base[:, :, None, None].expand(b, 3, height, width).clone()
        for w in range(waves):
            arg = (f[:, w, :, 0, None, None] * xs + f[:, w, :, 1, None, None] * ys) * (2 * math.pi)
            img += amp[:, w, :, None, None] * torch.sin(arg + ph[:, w, :, None, None])
        u8 = torch.clamp(img * 255.0, 13.0, 242.0).round().to(torch.uint8)
        for im in u8.permute(0, 2, 3, 1).cpu().numpy():
            yield im


def image_name(i: int) -> str:
    return f"view_{i:04d}.jpg"


def write_capture(root: str, cfg: dict, poses, seed: int, device) -> None:
    """A COLMAP capture under ``root``: ``sparse/0/{cameras,images,
    points3D}.bin`` (one PINHOLE camera, the poses, the assumed number of
    points) and the target images as JPEG under ``cfg["images"]``."""
    from PIL import Image

    W, H = cfg["width"], cfg["height"]
    f = cfg["assumed"]["focal_px"]
    sparse = os.path.join(root, "sparse", "0")
    img_dir = os.path.join(root, cfg["images"])
    os.makedirs(sparse)
    os.makedirs(img_dir)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<QiiQQ", 1, 1, 1, W, H))
        fh.write(struct.pack("<4d", f, f, W / 2.0, H / 2.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(poses)))
        for i, (q, t) in enumerate(poses):
            fh.write(struct.pack("<i4d3di", i + 1, *q, *t, 1))
            fh.write(image_name(i).encode() + b"\x00" + struct.pack("<Q", 0))
    n = cfg["assumed"]["points3D"]
    g = generator(seed, "points3D", device)
    xyz = positions(n, cfg["assumed"]["layout"], g, device).double().cpu().numpy()
    rgb = torch.randint(0, 256, (n, 3), generator=g, device=device).to(torch.uint8).cpu().numpy()
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                                ("err", "<f8"), ("track", "<u8")]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    rec["err"] = 1.0
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", n))
        fh.write(rec.tobytes())

    def save(item):
        i, im = item
        Image.fromarray(im).save(os.path.join(img_dir, image_name(i)), quality=95,
                                 subsampling=0)

    # the encoder lets go of the interpreter's lock: four threads shorten set-up
    with ThreadPoolExecutor(ENCODE_THREADS) as pool:
        list(pool.map(save, enumerate(target_images(len(poses), W, H, seed, device))))


def read_target(root: str, cfg: dict, i: int, device) -> torch.Tensor:
    """View ``i``'s target as the loader decodes it: (3, H, W) in [0, 1]."""
    from PIL import Image

    with Image.open(os.path.join(root, cfg["images"], image_name(i))) as im:
        a = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return torch.from_numpy(a).permute(2, 0, 1).contiguous().to(device)
