"""Gaussian model: fixed-capacity pre-activation parameters, the alive mask
and the densification statistics.

Counterpart of ``gaussian_splatting_tpu/models/gaussians.py``
(``GaussianParams`` + ``GaussianAux`` + ``GaussianModel``).  Live Gaussians
occupy slots marked by ``alive``; dead slots keep the JAX package's empty
values (logit -10, identity rotation) and render as fully transparent, so
they become sentinel instances exactly as in JAX and the instance counts of
the two packages agree.  The active SH degree is a host integer (JAX keeps
it on the device); ``spatial_lr_scale`` is the scene extent.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.data.ply import load_gaussian_ply
from gaussian_splatting_torch.ops.knn import knn_mean_sq_dist, knn_mean_sq_dist_exact
from gaussian_splatting_torch.ops.sh import num_sh_coeffs, rgb_to_sh

PARAM_NAMES = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")
# densification statistics (reference max_radii2D / xyz_gradient_accum / denom)
STAT_NAMES = ("max_radii2d", "xyz_grad_accum", "denom")


class GaussianModel(nn.Module):
    """Pre-activation parameters (log-scales, opacity logits, unnormalized
    wxyz quaternions, SH DC + rest), each of length ``capacity``, and the
    per-slot buffers ``alive`` and ``STAT_NAMES`` (float32, zeros by
    default)."""

    def __init__(
        self,
        means3d: torch.Tensor,  # (C, 3)
        features_dc: torch.Tensor,  # (C, 1, 3)
        features_rest: torch.Tensor,  # (C, K-1, 3)
        opacities: torch.Tensor,  # (C,) logits
        scales: torch.Tensor,  # (C, 3) log-scales
        quats: torch.Tensor,  # (C, 4)
        alive: torch.Tensor,  # (C,) bool
        *,
        max_sh_degree: int,
        sh_degree: int,
        spatial_lr_scale: float = 1.0,
        stats: Optional[Dict[str, torch.Tensor]] = None,
    ):
        super().__init__()
        self.means3d = nn.Parameter(means3d)
        self.features_dc = nn.Parameter(features_dc)
        self.features_rest = nn.Parameter(features_rest)
        self.opacities = nn.Parameter(opacities)
        self.scales = nn.Parameter(scales)
        self.quats = nn.Parameter(quats)
        self.register_buffer("alive", alive)
        for name in STAT_NAMES:
            self.register_buffer(name, torch.zeros_like(opacities) if stats is None else stats[name])
        self.max_sh_degree = int(max_sh_degree)
        self.sh_degree = int(sh_degree)  # active degree (<= max_sh_degree)
        self.spatial_lr_scale = float(spatial_lr_scale)

    @classmethod
    def empty(cls, capacity: int, max_sh_degree: int, *, device=None) -> "GaussianModel":
        dev = resolve_device(device)
        K = num_sh_coeffs(max_sh_degree)
        quats = torch.zeros((capacity, 4), device=dev)
        quats[:, 0] = 1.0
        return cls(
            means3d=torch.zeros((capacity, 3), device=dev),
            features_dc=torch.zeros((capacity, 1, 3), device=dev),
            features_rest=torch.zeros((capacity, K - 1, 3), device=dev),
            opacities=torch.full((capacity,), -10.0, device=dev),
            scales=torch.zeros((capacity, 3), device=dev),
            quats=quats,
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            max_sh_degree=max_sh_degree,
            sh_degree=max_sh_degree,
        )

    @property
    def capacity(self) -> int:
        return self.means3d.shape[0]

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    def num_alive(self) -> torch.Tensor:
        return self.alive.sum(dtype=torch.int32)

    def one_up_sh_degree(self) -> None:
        """Raise the active SH degree by one, up to the maximum."""
        self.sh_degree = min(self.sh_degree + 1, self.max_sh_degree)

    def activated_params(self) -> Tuple[torch.Tensor, ...]:
        """Rasterizer inputs: (means, scales, unit quats, opacities, sh) with
        SH coefficients above the active degree zeroed and dead slots at
        opacity 0 (JAX ``train/loop.py::_activated_params``)."""
        sh = torch.cat([self.features_dc, self.features_rest], dim=1)
        K = sh.shape[1]
        degs = torch.floor(
            torch.sqrt(torch.arange(K, dtype=torch.float32, device=sh.device))
        ).to(torch.int32)
        sh = torch.where((degs <= self.sh_degree)[None, :, None], sh, 0.0)
        q = self.quats
        return (
            self.means3d,
            torch.exp(self.scales),
            q / torch.sqrt((q * q).sum(dim=-1, keepdim=True)),
            torch.sigmoid(self.opacities) * self.alive,
            sh,
        )


def create_from_pcd(
    points: np.ndarray,
    colors: np.ndarray,
    *,
    max_sh_degree: int,
    spatial_lr_scale: float,
    capacity: Optional[int] = None,
    device=None,
) -> GaussianModel:
    """A model from a point cloud, as the JAX package's ``create_from_pcd``:
    SH DC from the colours, isotropic log-scales from the mean 3-NN squared
    distance (clipped at 1e-7; exact up to 20k points, the Morton window
    above), identity rotations, opacity 0.1, active SH degree 0.  Capacity
    defaults to ``int(n * 1.5) + 1024``; a larger cloud is subsampled with
    ``default_rng(0)``."""
    n = points.shape[0]
    capacity = capacity or int(n * 1.5) + 1024
    if n > capacity:
        print(f"[create_from_pcd] subsampling init cloud {n} -> {capacity} points "
              "(capacity limit)")
        sel = np.random.default_rng(0).choice(n, capacity, replace=False)
        points = np.asarray(points)[sel]
        colors = np.asarray(colors)[sel]
        n = capacity
    model = GaussianModel.empty(capacity, max_sh_degree, device=device)
    dev = model.means3d.device
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(dev)
    dist_fn = knn_mean_sq_dist_exact if n <= 20_000 else knn_mean_sq_dist
    log_scale = torch.log(torch.sqrt(torch.clamp(dist_fn(pts), min=1e-7)))
    tenth = torch.tensor(0.1, dtype=torch.float32)
    with torch.no_grad():
        model.means3d[:n] = pts
        model.features_dc[:n, 0] = rgb_to_sh(
            torch.from_numpy(np.asarray(colors, np.float32)).to(dev))
        model.opacities[:n] = float(torch.log(tenth / (1.0 - tenth)))  # inverse_sigmoid
        model.scales[:n] = log_scale[:, None]
        model.alive[:n] = True
    model.sh_degree = 0
    model.spatial_lr_scale = float(spatial_lr_scale)
    return model


def load_model_ply(
    path: str, *, max_sh_degree: int, capacity: Optional[int] = None, device=None
) -> GaussianModel:
    """Read a ``point_cloud.ply`` snapshot into a model padded to the JAX
    package's capacity (``int(n * 1.2) + 1024``).  A snapshot of another SH
    degree than ``max_sh_degree`` raises ``ValueError``, as in JAX."""
    data = load_gaussian_ply(path)
    n = data["means3d"].shape[0]
    k = data["features_rest"].shape[1] + 1
    if k != num_sh_coeffs(max_sh_degree):
        raise ValueError(f"{path} holds {k} SH coefficients per channel, but "
                         f"max_sh_degree {max_sh_degree} needs {num_sh_coeffs(max_sh_degree)}")
    capacity = capacity or int(n * 1.2) + 1024
    model = GaussianModel.empty(capacity, max_sh_degree, device=device)
    with torch.no_grad():
        for name in ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats"):
            getattr(model, name)[:n] = torch.from_numpy(np.asarray(data[name]))
        model.alive[:n] = True
    return model


def grow_capacity(model: GaussianModel, new_capacity: int) -> GaussianModel:
    """A copy of ``model`` padded with empty slots to ``new_capacity``."""
    extra = new_capacity - model.capacity
    if extra < 0:
        raise ValueError("grow_capacity cannot shrink a model")
    pad = GaussianModel.empty(extra, model.max_sh_degree, device=model.means3d.device)
    with torch.no_grad():
        cat = {name: torch.cat([getattr(model, name), getattr(pad, name)])
               for name in PARAM_NAMES + ("alive",) + STAT_NAMES}
    return GaussianModel(
        **{name: cat[name] for name in PARAM_NAMES}, alive=cat["alive"],
        max_sh_degree=model.max_sh_degree, sh_degree=model.sh_degree,
        spatial_lr_scale=model.spatial_lr_scale,
        stats={name: cat[name] for name in STAT_NAMES},
    )
