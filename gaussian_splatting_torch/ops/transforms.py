"""Quaternion / covariance math for anisotropic 3D Gaussians.

Counterpart of ``gaussian_splatting_tpu/ops/transforms.py``: quaternions are
(w, x, y, z); Sigma = L L^T with L = R diag(scale), packed as the upper
triangle [xx, xy, xz, yy, yz, zz].  Products are written elementwise in the
JAX package's order so the two agree to float32 rounding.
"""

from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt((q * q).sum(dim=-1, keepdim=True))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) normalized wxyz quaternion -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def build_scaling_rotation(scale: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s)."""
    return quat_to_rotmat(q) * scale[..., None, :]


def build_covariance(
    scale: torch.Tensor, q: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Packed (..., 6) upper triangle of Sigma = L L^T."""
    L = build_scaling_rotation(scale_modifier * scale, q)

    def dot_rows(i, j):
        return (
            L[..., i, 0] * L[..., j, 0]
            + L[..., i, 1] * L[..., j, 1]
            + L[..., i, 2] * L[..., j, 2]
        )

    return torch.stack(
        [dot_rows(0, 0), dot_rows(0, 1), dot_rows(0, 2),
         dot_rows(1, 1), dot_rows(1, 2), dot_rows(2, 2)],
        dim=-1,
    )


def apply_rot(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row-convention ``p @ M.T`` for (3, 3) M and (..., 3) points."""
    return torch.stack(
        [
            p[..., 0] * M[0, 0] + p[..., 1] * M[0, 1] + p[..., 2] * M[0, 2],
            p[..., 0] * M[1, 0] + p[..., 1] * M[1, 1] + p[..., 2] * M[1, 2],
            p[..., 0] * M[2, 0] + p[..., 1] * M[2, 1] + p[..., 2] * M[2, 2],
        ],
        dim=-1,
    )


def apply_affine(M: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Top-left 3x3 + translation column of a 4x4 applied to (..., 3) points."""
    return apply_rot(M[:3, :3], p) + M[:3, 3]
