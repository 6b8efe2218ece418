"""Per-Gaussian preprocessing: projection, EWA 2D covariance, conics, culling,
tile rects and exact ellipse-vs-tile spans.

Counterpart of ``gaussian_splatting_tpu/ops/preprocess.py`` (the reference's
``preprocessCUDA``), written as plain tensor code in the JAX package's
operation order so integer outputs (radii, rects, spans, tile counts) match
it bit for bit.  Float -> int conversions truncate toward zero like JAX's
``astype(int32)``; values are clamped into the int32 range first so that
out-of-range floats saturate as XLA's conversion does.

Bounds that gradients pass through use ``maximum`` / ``minimum`` / ``clip``
below, the forms the JAX package writes (``jnp.maximum``, ``jnp.clip``):
at a tie JAX splits the gradient evenly between the value and the bound,
as ``torch.maximum`` does, while ``torch.clamp`` would pass all of it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch.ops.camera_math import CameraParams, ndc_to_pixel
from gaussian_splatting_torch.ops.sh import sh_to_color
from gaussian_splatting_torch.ops.transforms import apply_affine, build_covariance

# Per-row span culling handles rects up to this many tile rows; taller rects
# fall back to full-rect expansion.
MAX_SPAN_ROWS = 16
# Span cells and tile x stay below this (the JAX package's packed-integer
# limit, kept so that tiles_touched matches it bit for bit).
SPAN_LIMIT = 4096


class ProjectedGaussians(NamedTuple):
    """Screen-space Gaussians; ``valid`` marks those that survived culling."""

    means2d: torch.Tensor  # (P, 2) pixel coordinates
    depths: torch.Tensor  # (P,) view-space z
    conics: torch.Tensor  # (P, 3) inverse 2D covariance [a, b, c]
    opacities: torch.Tensor  # (P,) after the antialiasing rescale
    colors: torch.Tensor  # (P, 3) RGB from SH (clamped at 0)
    radii: torch.Tensor  # (P,) int32 pixel radius (0 = culled)
    rect_min: torch.Tensor  # (P, 2) int32 tile coords (x, y)
    rect_max: torch.Tensor  # (P, 2) int32 exclusive tile coords
    tiles_touched: torch.Tensor  # (P,) int32 exact ellipse-intersecting count
    valid: torch.Tensor  # (P,) bool
    cut_radius: torch.Tensor  # (P,) f32 conservative visibility radius
    span_x0: torch.Tensor  # (P, 16) int32 first tile x per rect row
    span_cum: torch.Tensor  # (P, 16) int32 cumulative cell count through row
    span_flag: torch.Tensor  # (P,) bool: span mapping applies


def maximum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.maximum(x, bound)``, gradient halved at a tie."""
    return torch.maximum(x, x.new_full((), bound))


def minimum(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``jnp.minimum(x, bound)``, gradient halved at a tie."""
    return torch.minimum(x, x.new_full((), bound))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``maximum`` then ``minimum``."""
    return minimum(maximum(x, lo), hi)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncating float -> int32, saturating outside the int32 range."""
    return x.clamp(-2.0**31, 2.0**31 - 256).to(torch.int32)


def compute_tile_spans(
    mean2d: torch.Tensor,
    conic: torch.Tensor,
    tau: torch.Tensor,
    r_cut: torch.Tensor,
    rx_min: torch.Tensor,
    ry_min: torch.Tensor,
    rx_max: torch.Tensor,
    ry_max: torch.Tensor,
    *,
    tile_w: int,
    tile_h: int,
):
    """Exact ellipse-vs-tile spans, one contiguous x-span per rect row.

    Returns (span_x0 (P, 16) int32, span_cum (P, 16) int32, tiles (P,)
    int32, is_span (P,) bool); see the JAX docstring for the derivation."""
    cx = mean2d[:, 0]
    cy = mean2d[:, 1]
    a = conic[:, 0]
    b = conic[:, 1]
    c = conic[:, 2]
    rect_w = rx_max - rx_min
    rect_h = ry_max - ry_min
    detc = a * c - b * b
    is_pd = (detc > 0.0) & (a > 0.0) & (c > 0.0)
    is_span = (rect_h <= MAX_SPAN_ROWS) & (rect_h > 0) & (rect_w > 0) & is_pd
    taus = tau + 1e-3
    SLACK_PX = 0.05
    safe_a = torch.clamp(a, min=1e-30)
    safe_detc = torch.clamp(detc, min=1e-30)
    inv_a = 1.0 / safe_a
    dy_lim = torch.sqrt(torch.clamp(taus * a, min=0.0) / safe_detc)
    s_shared = torch.sqrt(
        torch.clamp(taus, min=0.0) / torch.clamp(c * detc, min=1e-30)
    )
    dy_star = -b * s_shared

    x0_rows = []
    cum_rows = []
    cum = torch.zeros_like(rx_min)
    for r in range(MAX_SPAN_ROWS):
        ty = ry_min + r
        tyf = ty.to(torch.float32)
        l = tyf * tile_h - cy
        u = l + (tile_h - 1)
        lo_d = torch.maximum(l, -dy_lim)
        hi_d = torch.minimum(u, dy_lim)

        dyc = torch.minimum(torch.maximum(dy_star, lo_d), hi_d)
        D = torch.clamp(taus * a - detc * dyc * dyc, min=0.0)
        xmax_e = (-b * dyc + torch.sqrt(D)) * inv_a
        dyc2 = torch.minimum(torch.maximum(-dy_star, lo_d), hi_d)
        D2 = torch.clamp(taus * a - detc * dyc2 * dyc2, min=0.0)
        xmin_e = (-b * dyc2 - torch.sqrt(D2)) * inv_a

        dyn = torch.minimum(torch.clamp(l, min=0.0), u)  # clip(0, l, u)
        rem = r_cut * r_cut - dyn * dyn
        xc = torch.sqrt(torch.clamp(rem, min=0.0)) + SLACK_PX
        xmax = torch.minimum(xmax_e + SLACK_PX, xc)
        xmin = torch.maximum(xmin_e - SLACK_PX, -xc)

        lo = _to_int32(torch.ceil((cx + xmin - (tile_w - 1)) / tile_w))
        hi = _to_int32(torch.floor((cx + xmax) / tile_w))
        lo = torch.maximum(lo, rx_min)
        hi = torch.minimum(hi, rx_max - 1)
        row_ok = (r < rect_h) & (lo_d <= hi_d) & (rem >= 0.0) & (xmin <= xmax)
        span = torch.where(row_ok, torch.clamp(hi - lo + 1, min=0), 0)
        x0_rows.append(torch.where(span > 0, lo, 0))
        cum = cum + span
        cum_rows.append(cum)

    span_x0 = torch.stack(x0_rows, dim=1).to(torch.int32)
    span_cum = torch.stack(cum_rows, dim=1).to(torch.int32)
    is_span = is_span & (cum < SPAN_LIMIT) & (rx_max <= SPAN_LIMIT)
    rect_tiles = torch.clamp(rect_w, min=0) * torch.clamp(rect_h, min=0)
    tiles = torch.where(is_span, cum, rect_tiles).to(torch.int32)
    span_x0 = torch.where(is_span[:, None], span_x0, 0)
    span_cum = torch.where(is_span[:, None], span_cum, 0)
    return span_x0, span_cum, tiles, is_span


def compute_cov2d(
    means3d: torch.Tensor, cov3d: torch.Tensor, cam: CameraParams
) -> torch.Tensor:
    """EWA projection of 3D covariance -> (P, 3) [xx, xy, yy] before dilation."""
    W = cam.viewmatrix[:3, :3]
    t = apply_affine(cam.viewmatrix, means3d)
    tz = maximum(t[:, 2], 0.2)
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tx = clip(t[:, 0] / tz, -limx, limx) * tz
    ty = clip(t[:, 1] / tz, -limy, limy) * tz

    fx, fy = cam.focal_x, cam.focal_y
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    M0 = j00[:, None] * W[0] + j02[:, None] * W[2]
    M1 = j11[:, None] * W[1] + j12[:, None] * W[2]

    xx, xy, xz, yy, yz, zz = (cov3d[:, i] for i in range(6))

    def quad(a, b):
        sa0 = a[:, 0] * xx + a[:, 1] * xy + a[:, 2] * xz
        sa1 = a[:, 0] * xy + a[:, 1] * yy + a[:, 2] * yz
        sa2 = a[:, 0] * xz + a[:, 1] * yz + a[:, 2] * zz
        return sa0 * b[:, 0] + sa1 * b[:, 1] + sa2 * b[:, 2]

    return torch.stack([quad(M0, M0), quad(M0, M1), quad(M1, M1)], dim=-1)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor,
    cam: CameraParams,
    *,
    sh_degree: int,
    tile_w: int = 16,
    tile_h: int = 16,
    scale_modifier: float = 1.0,
    antialiasing: bool = False,
    cov3d_precomp: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project P Gaussians to screen space.  ``quats`` normalized,
    ``opacities`` post-sigmoid, ``sh`` (P, K, 3)."""
    W, H = cam.width, cam.height
    grid_x = (W + tile_w - 1) // tile_w
    grid_y = (H + tile_h - 1) // tile_h

    # frustum cull
    p_view = apply_affine(cam.viewmatrix, means3d)
    depth = p_view[:, 2]
    in_front = depth > 0.2

    # projection + perspective divide
    p_hom = apply_affine(cam.projmatrix, means3d)
    pm = cam.projmatrix
    w_hom = (
        means3d[:, 0] * pm[3, 0]
        + means3d[:, 1] * pm[3, 1]
        + means3d[:, 2] * pm[3, 2]
        + pm[3, 3]
    )
    w_hom = torch.where(in_front, w_hom, 1.0)
    p_w = 1.0 / (w_hom + 1e-7)
    ndc_xy = p_hom[:, :2] * p_w[:, None]
    mean2d = torch.stack(
        [ndc_to_pixel(ndc_xy[:, 0], W), ndc_to_pixel(ndc_xy[:, 1], H)], dim=-1
    )

    # covariances
    cov3d = (
        cov3d_precomp
        if cov3d_precomp is not None
        else build_covariance(scales, quats, scale_modifier)
    )
    cov2d = compute_cov2d(means3d, cov3d, cam)

    # dilation + antialiasing rescale
    h_var = 0.3
    det_orig = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    cxx = cov2d[:, 0] + h_var
    cyy = cov2d[:, 2] + h_var
    cxy = cov2d[:, 1]
    det = cxx * cyy - cxy * cxy
    if antialiasing:
        aa_scale = torch.sqrt(maximum(det_orig / det, 0.000025))
    else:
        aa_scale = torch.ones_like(det)

    det_ok = det != 0.0
    safe_det = torch.where(det_ok, det, 1.0)
    det_inv = 1.0 / safe_det
    conic = torch.stack([cyy * det_inv, -cxy * det_inv, cxx * det_inv], dim=-1)

    # radius from the larger eigenvalue
    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(maximum(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam1))

    # opacity-aware cut radius and per-axis ellipse extents
    op_for_cut = opacities * aa_scale
    log_term = 2.0 * torch.log(maximum(255.0 * op_for_cut, 1.0))
    r_cut = torch.minimum(torch.sqrt(lam1 * log_term), radius_f)
    taus = log_term + 1e-3
    ell_x = torch.sqrt(torch.clamp(taus * cxx, min=0.0)) + 0.1
    ell_y = torch.sqrt(torch.clamp(taus * cyy, min=0.0)) + 0.1
    is_pd = det > 0.0
    rect_rx = torch.ceil(torch.where(is_pd, torch.minimum(ell_x, r_cut), r_cut))
    rect_ry = torch.ceil(torch.where(is_pd, torch.minimum(ell_y, r_cut), r_cut))

    # tile rect: exclusive max floor((c + R) / tile) + 1
    rx_min = torch.clamp(_to_int32((mean2d[:, 0] - rect_rx) / tile_w), 0, grid_x)
    ry_min = torch.clamp(_to_int32((mean2d[:, 1] - rect_ry) / tile_h), 0, grid_y)
    rx_max = torch.clamp(
        _to_int32(torch.floor((mean2d[:, 0] + rect_rx) / tile_w)) + 1, 0, grid_x
    )
    ry_max = torch.clamp(
        _to_int32(torch.floor((mean2d[:, 1] + rect_ry) / tile_h)) + 1, 0, grid_y
    )
    # integer outputs only: no gradient, so no autograd graph for the loop
    span_x0, span_cum, tiles, span_flag = compute_tile_spans(
        mean2d.detach(), conic.detach(), log_term.detach(), r_cut.detach(),
        rx_min, ry_min, rx_max, ry_max,
        tile_w=tile_w, tile_h=tile_h,
    )
    tiles = torch.where(op_for_cut * 255.0 > 1.0, tiles, 0)

    valid = in_front & det_ok & (tiles > 0)
    tiles = torch.where(valid, tiles, 0).to(torch.int32)
    radius = _to_int32(torch.where(valid, radius_f, 0.0))

    colors = (
        colors_precomp
        if colors_precomp is not None
        else sh_to_color(sh_degree, sh, means3d, cam.campos)
    )

    return ProjectedGaussians(
        means2d=mean2d,
        depths=depth,
        conics=conic,
        opacities=opacities * aa_scale,
        colors=colors,
        radii=radius,
        rect_min=torch.stack([rx_min, ry_min], dim=-1),
        rect_max=torch.stack([rx_max, ry_max], dim=-1),
        tiles_touched=tiles,
        valid=valid,
        cut_radius=r_cut,
        span_x0=span_x0,
        span_cum=span_cum,
        span_flag=span_flag,
    )
