"""Dense reference renderer (the correctness oracle).

Counterpart of ``gaussian_splatting_tpu/ops/oracle.py``: every pixel scans
every Gaussian in global depth order with the same tile-rect coverage test,
alpha thresholds and early termination as the tiled blend.  It is plain
tensor code, so autograd runs through it: its gradients are the ground truth
the tiled path's hand-written backward is held against (with JAX's zero
gradient on the capped branch of ``alpha = min(0.99, op * G)``).  O(P * H *
W) work: small scenes only.  Selected with ``impl="dense"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians

ALPHA_MIN = 1.0 / 255.0
ALPHA_CAP = 0.99
T_EPS = 1e-4


class RenderOutput(NamedTuple):
    color: torch.Tensor  # (3, H, W)
    invdepth: torch.Tensor  # (H, W)
    final_T: torch.Tensor  # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32


def depth_order(proj: ProjectedGaussians) -> torch.Tensor:
    """Front-to-back order (ties by index) with culled Gaussians last."""
    key = torch.where(proj.valid, proj.depths, float("inf"))
    return torch.sort(key, stable=True).indices


def render_dense(
    proj: ProjectedGaussians,
    cam: CameraParams,
    bg_color: torch.Tensor,
    *,
    tile_w: int = 16,
    tile_h: int = 16,
) -> RenderOutput:
    H, W = cam.height, cam.width
    dev = proj.means2d.device
    order = depth_order(proj)
    n_valid = int(proj.valid.sum())

    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    tile_x = (torch.arange(W, device=dev) // tile_w)[None, :]
    tile_y = (torch.arange(H, device=dev) // tile_h)[:, None]

    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    C = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    invd = torch.zeros((H, W), dtype=torch.float32, device=dev)
    ncontrib = torch.zeros((H, W), dtype=torch.int32, device=dev)
    # culled Gaussians sort last and never cover a pixel: stop at n_valid
    for g in order[:n_valid].tolist():
        xy = proj.means2d[g]
        con = proj.conics[g]
        rmin = proj.rect_min[g]
        rmax = proj.rect_max[g]
        cover = (
            (tile_x >= rmin[0]) & (tile_x < rmax[0])
            & (tile_y >= rmin[1]) & (tile_y < rmax[1])
        )
        dx = xy[0] - px
        dy = xy[1] - py
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        raw = proj.opacities[g] * torch.exp(power)
        alpha = torch.minimum(raw, raw.new_full((), ALPHA_CAP))
        eligible = cover & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        trigger = eligible & (test_T < T_EPS) & ~done
        contrib = eligible & ~done & (test_T >= T_EPS)
        w = torch.where(contrib, alpha * T, 0.0)
        C = C + w[None] * proj.colors[g][:, None, None]
        invd = invd + w / proj.depths[g]
        T = torch.where(contrib, test_T, T)
        done = done | trigger
        ncontrib = ncontrib + contrib.to(torch.int32)
    color = C + T[None] * bg_color[:, None, None]
    return RenderOutput(color=color, invdepth=invd, final_T=T, n_contrib=ncontrib)
