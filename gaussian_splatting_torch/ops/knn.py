"""Mean squared distance to the 3 nearest neighbours (Gaussian scale init).

Counterpart of ``gaussian_splatting_tpu/ops/knn.py``, plain PyTorch:

- ``knn_mean_sq_dist_exact``: O(N^2) in row chunks, the ground truth and
  the choice for small clouds;
- ``knn_mean_sq_dist``: a window of 2 x 32 candidates along the Morton curve
  (the reference's ``simple-knn`` strategy), which upper-bounds the true
  3-NN distance; the scale init only needs its order of magnitude.

The Morton codes are computed in int64 with explicit masks (CUDA lacks most
``uint32`` operations); every mask lies in the low 32 bits, so the result is
the JAX package's ``uint32`` arithmetic bit for bit.
"""

from __future__ import annotations

import torch


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (Morton encoding helper)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) from (N, 3) points in a 1024^3 grid."""
    lo = points.amin(dim=0)
    hi = points.amax(dim=0)
    extent = torch.clamp(hi - lo, min=1e-9)
    # a true division: ``1023.0 / t`` is ``t.reciprocal() * 1023``, which
    # rounds differently and moves points across grid cells
    scale = torch.full_like(extent, 1023.0) / extent
    q = torch.clamp((points - lo) * scale, 0.0, 1023.0).to(torch.int64)
    return _expand_bits(q[:, 0]) | (_expand_bits(q[:, 1]) << 1) | (_expand_bits(q[:, 2]) << 2)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last axis, summed x, y, z in order."""
    d = a - b
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def knn_mean_sq_dist(points: torch.Tensor, window: int = 32, k: int = 3) -> torch.Tensor:
    """Approximate mean of squared distances to the k nearest neighbours."""
    n = points.shape[0]
    order = torch.argsort(morton_codes(points), stable=True)
    sorted_pts = points[order]
    dev = points.device
    offs = torch.cat([torch.arange(-window, 0, device=dev), torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(n, device=dev)[:, None] + offs[None, :]
    valid = (idx >= 0) & (idx < n)
    cand = sorted_pts[idx.clamp(0, n - 1)]  # (N, 2W, 3)
    d2 = torch.where(valid, _sq_dist(cand, sorted_pts[:, None, :]), torch.inf)
    best = torch.topk(d2, k, dim=-1, largest=False).values  # k smallest
    mean = torch.where(torch.isfinite(best), best, 0.0).mean(dim=-1)
    return torch.zeros(n, dtype=points.dtype, device=dev).index_put_((order,), mean)


def knn_mean_sq_dist_exact(points: torch.Tensor, k: int = 3, chunk: int = 1024) -> torch.Tensor:
    """Exact O(N^2) version, row-chunked to bound memory."""
    out = []
    for s in range(0, points.shape[0], chunk):
        d2 = _sq_dist(points[s : s + chunk, None, :], points[None, :, :])
        # the smallest is the point itself (0); coincident points keep 0s
        best = torch.topk(d2, k + 1, dim=-1, largest=False).values
        out.append(best[:, 1:].mean(dim=-1))
    return torch.cat(out)
