"""Plain PyTorch reference of one 3D Gaussian splatting render, its
gradient, and the work its inputs need.

It follows the published method (Kerbl et al., SIGGRAPH 2023, and its CUDA
rasterizer's ``preprocessCUDA`` / ``renderCUDA``) in plain operations: the
projection and the EWA covariance as matrix products, spherical harmonics
as the basis times the coefficients, 16x16 tiles, a stable (tile, depth)
order, front-to-back blending with alpha capped at 0.99, skipped below
1/255, and stopped where the transmittance would fall below 1e-4.  The
blend runs over blocks of tiles.  Its gradient comes from autograd, each
block recomputed with its inputs as leaves, so the whole image never holds
an autograd graph.

Which tiles a Gaussian is blended in is a rule of the system measured, not
of the method: an opacity-aware cut radius, and exact ellipse-against-tile
row spans.  ``tile_spans`` and the rect in ``project`` are a frozen copy of
that rule, taken from ``gaussian_splatting_torch/ops/preprocess.py`` at
commit 3e1fa2f (plain tensor code; nothing is imported from that package).

Nothing here reads what the program made: cameras come from poses, and the
Gaussians from the tensors the benchmark generated.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, NamedTuple

import numpy as np
import torch

TILE = 16
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
ALPHA_CAP = 0.99
T_EPS = 1e-4
POWER_EPS = 1e-4
Z_NEAR, Z_FAR = 0.01, 100.0
MAX_SPAN_ROWS = 16
SPAN_LIMIT = 4096
# elements of one (tiles, pixels, instances) block of the blend
BLOCK_ELEMENTS = 1 << 25

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


@contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (``tf32``) or in full
    float32, the reference's own precision, for the length of a ``with``."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass(frozen=True)
class Camera:
    view: torch.Tensor  # (4, 4) world -> camera, column vectors
    proj: torch.Tensor  # (4, 4) projection @ view
    campos: torch.Tensor  # (3,)
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int

    @property
    def fx(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def fy(self) -> float:
        return self.height / (2.0 * self.tan_fovy)


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def camera(qvec, tvec, fx: float, fy: float, width: int, height: int, device) -> Camera:
    """A pinhole camera from a COLMAP pose (world -> camera quaternion and
    translation) and focal lengths in pixels; OpenGL-style projection with
    near 0.01 and far 100, as the method's cameras."""
    V = np.eye(4)
    V[:3, :3] = qvec_to_rotmat(qvec)
    V[:3, 3] = np.asarray(tvec, np.float64)
    tan_x = math.tan(math.atan(width / (2.0 * fx)))
    tan_y = math.tan(math.atan(height / (2.0 * fy)))
    P = np.zeros((4, 4))
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = Z_FAR / (Z_FAR - Z_NEAR)
    P[2, 3] = -(Z_FAR * Z_NEAR) / (Z_FAR - Z_NEAR)
    P[3, 2] = 1.0
    campos = -V[:3, :3].T @ V[:3, 3]

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return Camera(view=t(V), proj=t(P @ V), campos=t(campos), tan_fovx=tan_x,
                  tan_fovy=tan_y, width=int(width), height=int(height))


def activate(params: Dict[str, torch.Tensor], alive: torch.Tensor):
    """Rasterizer inputs from the stored parameters: positions, scales
    (exp), unit quaternions, opacities (sigmoid, dead slots at 0) and the
    (C, K, 3) SH coefficients."""
    q = params["quats"]
    return (params["means3d"], torch.exp(params["scales"]),
            q / torch.linalg.vector_norm(q, dim=-1, keepdim=True),
            torch.sigmoid(params["opacities"]) * alive,
            torch.cat([params["features_dc"], params["features_rest"]], dim=1))


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """(P, (degree + 1)^2) real SH basis at unit directions, degree <= 3."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [torch.full_like(x, SH_C0)]
    if degree > 0:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        out += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
                SH_C2[3] * x * z, SH_C2[4] * (xx - yy)]
    if degree > 2:
        out += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                SH_C3[6] * x * (xx - 3 * yy)]
    if degree > 3:
        raise ValueError("the reference evaluates SH up to degree 3")
    return torch.stack(out, dim=1)


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


class Geometry(NamedTuple):
    """Screen-space Gaussians.  ``fields`` (P, 10) is differentiable: mean
    x, y, conic a, b, c, opacity, colour r, g, b, inverse depth."""

    fields: torch.Tensor
    depth: torch.Tensor  # (P,)
    radii: torch.Tensor  # (P,) int64, 0 where culled
    tiles: torch.Tensor  # (P,) int64 tiles touched, 0 where culled
    span: torch.Tensor  # (P,) bool: row spans apply
    span_x0: torch.Tensor  # (P, 16)
    span_cum: torch.Tensor  # (P, 16)
    rect: torch.Tensor  # (P, 4) x0, y0, x1, y1 (exclusive) in tiles


def _trunc(x: torch.Tensor) -> torch.Tensor:
    return torch.trunc(x.clamp(-2.0**31, 2.0**31 - 256)).long()


def tile_spans(mean2d, conic, tau, r_cut, rx0, ry0, rx1, ry1):
    """Per rect row, the contiguous run of tiles that the ellipse
    ``d^T conic d <= tau`` meets inside the cut circle, with 0.05 px slack
    (frozen copy of the measured system's rule).  Returns (x0 (P, 16),
    cum (P, 16), tiles (P,), span (P,) bool)."""
    cx, cy = mean2d[:, 0], mean2d[:, 1]
    a, b, c = conic[:, 0], conic[:, 1], conic[:, 2]
    rect_w, rect_h = rx1 - rx0, ry1 - ry0
    detc = a * c - b * b
    span = (rect_h <= MAX_SPAN_ROWS) & (rect_h > 0) & (rect_w > 0) & (detc > 0) & (a > 0) & (c > 0)
    taus = tau + 1e-3
    slack = 0.05
    inv_a = 1.0 / torch.clamp(a, min=1e-30)
    dy_lim = torch.sqrt(torch.clamp(taus * a, min=0.0) / torch.clamp(detc, min=1e-30))
    dy_star = -b * torch.sqrt(torch.clamp(taus, min=0.0) / torch.clamp(c * detc, min=1e-30))
    x0s, cums = [], []
    cum = torch.zeros_like(rx0)
    for r in range(MAX_SPAN_ROWS):
        l = (ry0 + r).to(torch.float32) * TILE - cy
        u = l + (TILE - 1)
        lo_d = torch.maximum(l, -dy_lim)
        hi_d = torch.minimum(u, dy_lim)
        d1 = torch.minimum(torch.maximum(dy_star, lo_d), hi_d)
        xmax_e = (-b * d1 + torch.sqrt(torch.clamp(taus * a - detc * d1 * d1, min=0.0))) * inv_a
        d2 = torch.minimum(torch.maximum(-dy_star, lo_d), hi_d)
        xmin_e = (-b * d2 - torch.sqrt(torch.clamp(taus * a - detc * d2 * d2, min=0.0))) * inv_a
        dyn = torch.minimum(torch.clamp(l, min=0.0), u)
        rem = r_cut * r_cut - dyn * dyn
        xc = torch.sqrt(torch.clamp(rem, min=0.0)) + slack
        xmax = torch.minimum(xmax_e + slack, xc)
        xmin = torch.maximum(xmin_e - slack, -xc)
        lo = torch.maximum(_trunc(torch.ceil((cx + xmin - (TILE - 1)) / TILE)), rx0)
        hi = torch.minimum(_trunc(torch.floor((cx + xmax) / TILE)), rx1 - 1)
        ok = (r < rect_h) & (lo_d <= hi_d) & (rem >= 0.0) & (xmin <= xmax)
        n = torch.where(ok, torch.clamp(hi - lo + 1, min=0), 0)
        x0s.append(torch.where(n > 0, lo, 0))
        cum = cum + n
        cums.append(cum)
    x0 = torch.stack(x0s, dim=1)
    cum_all = torch.stack(cums, dim=1)
    span = span & (cum < SPAN_LIMIT) & (rx1 <= SPAN_LIMIT)
    tiles = torch.where(span, cum, torch.clamp(rect_w, min=0) * torch.clamp(rect_h, min=0))
    return (torch.where(span[:, None], x0, 0), torch.where(span[:, None], cum_all, 0),
            tiles, span)


def project(means, scales, quats, opac, sh, cam: Camera, sh_degree: int) -> Geometry:
    """Projection, EWA covariance with the 0.3 px dilation, conics, cut
    radius, tile rect and spans, and SH colours (reference preprocess)."""
    W, H = cam.width, cam.height
    gx, gy = -(-W // TILE), -(-H // TILE)
    Rv, tv = cam.view[:3, :3], cam.view[:3, 3]
    p_view = means @ Rv.T + tv
    # the depth that orders the blend, as the dot product of the view's
    # third row with the point term by term: two Gaussians whose depths
    # lie within a rounding of each other then keep their order
    V = cam.view
    depth = means[:, 0] * V[2, 0] + means[:, 1] * V[2, 1] + means[:, 2] * V[2, 2] + V[2, 3]
    in_front = depth > 0.2
    p_hom = means @ cam.proj[:, :3].T + cam.proj[:, 3]
    w = torch.where(in_front, p_hom[:, 3], 1.0)
    ndc = p_hom[:, :2] / (w + 1e-7)[:, None]
    size = torch.tensor([W, H], dtype=means.dtype, device=means.device)
    mean2d = ((ndc + 1.0) * size - 1.0) * 0.5

    M = quat_rotmat(quats) * scales[:, None, :]
    cov3 = M @ M.transpose(1, 2)
    tz = torch.clamp(depth, min=0.2)
    limx, limy = 1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([cam.fx / tz, zero, -cam.fx * tx / (tz * tz),
                     zero, cam.fy / tz, -cam.fy * ty / (tz * tz)], dim=1).reshape(-1, 2, 3)
    T = J @ Rv
    cov2 = T @ cov3 @ T.transpose(1, 2)
    cxx = cov2[:, 0, 0] + 0.3
    cyy = cov2[:, 1, 1] + 0.3
    cxy = cov2[:, 0, 1]
    det = cxx * cyy - cxy * cxy
    det_ok = det != 0.0
    inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], dim=1)

    with torch.no_grad():
        mid = 0.5 * (cxx + cyy)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(lam1))
        tau = 2.0 * torch.log(torch.clamp(255.0 * opac, min=1.0))
        r_cut = torch.minimum(torch.sqrt(lam1 * tau), radius)
        ell_x = torch.sqrt(torch.clamp((tau + 1e-3) * cxx, min=0.0)) + 0.1
        ell_y = torch.sqrt(torch.clamp((tau + 1e-3) * cyy, min=0.0)) + 0.1
        pd = det > 0.0
        rrx = torch.ceil(torch.where(pd, torch.minimum(ell_x, r_cut), r_cut))
        rry = torch.ceil(torch.where(pd, torch.minimum(ell_y, r_cut), r_cut))
        mx, my = mean2d[:, 0], mean2d[:, 1]
        rx0 = torch.clamp(_trunc((mx - rrx) / TILE), 0, gx)
        ry0 = torch.clamp(_trunc((my - rry) / TILE), 0, gy)
        rx1 = torch.clamp(_trunc(torch.floor((mx + rrx) / TILE)) + 1, 0, gx)
        ry1 = torch.clamp(_trunc(torch.floor((my + rry) / TILE)) + 1, 0, gy)
        x0, cum, tiles, span = tile_spans(mean2d, conic, tau, r_cut, rx0, ry0, rx1, ry1)
        tiles = torch.where(opac * 255.0 > 1.0, tiles, 0)
        valid = in_front & det_ok & (tiles > 0)
        tiles = torch.where(valid, tiles, 0)
        radii = torch.where(valid, radius, 0.0).long()

    d = means - cam.campos
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    K = (sh_degree + 1) ** 2
    color = torch.einsum("pk,pkc->pc", sh_basis(d, sh_degree), sh[:, :K]) + 0.5
    color = torch.clamp(color, min=0.0)
    inv_depth = 1.0 / torch.where(valid, depth, 1.0)
    fields = torch.cat([mean2d, conic, opac[:, None], color, inv_depth[:, None]], dim=1)
    return Geometry(fields=fields, depth=depth.detach(), radii=radii, tiles=tiles, span=span,
                    span_x0=x0, span_cum=cum, rect=torch.stack([rx0, ry0, rx1, ry1], dim=1))


class Bins(NamedTuple):
    owner: torch.Tensor  # (n,) Gaussian of each instance, in (tile, depth, index) order
    starts: torch.Tensor  # (tiles,) first instance of each tile
    counts: torch.Tensor  # (tiles,)
    demand: int  # slots the instances need, one per Gaussian that touches no tile


def bin_instances(geo: Geometry, width: int, height: int, chunk: int = 1 << 21) -> Bins:
    """Every (Gaussian, tile) instance, ordered by tile, then depth, then
    Gaussian index."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    dev = geo.tiles.device
    idx = torch.nonzero(geo.tiles > 0).squeeze(1)
    counts = geo.tiles[idx]
    demand = int(torch.clamp(geo.tiles, min=1).sum())
    first = torch.cumsum(counts, 0) - counts
    n = int(counts.sum())
    g_all = torch.repeat_interleave(idx, counts)
    j_all = torch.arange(n, device=dev) - torch.repeat_interleave(first, counts)
    tile = torch.empty(n, dtype=torch.long, device=dev)
    for s in range(0, n, chunk):
        g, j = g_all[s:s + chunk], j_all[s:s + chunk]
        rect = geo.rect[g]
        cum = geo.span_cum[g]
        row = (cum <= j[:, None]).sum(dim=1).clamp(max=MAX_SPAN_ROWS - 1)
        prev = torch.where(row > 0, cum.gather(1, (row - 1).clamp(min=0)[:, None])[:, 0], 0)
        sx = geo.span_x0[g].gather(1, row[:, None])[:, 0] + j - prev
        sy = rect[:, 1] + row
        rw = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
        span = geo.span[g]
        x = torch.where(span, sx, rect[:, 0] + j % rw)
        y = torch.where(span, sy, rect[:, 1] + j // rw)
        tile[s:s + chunk] = y * gx + x
    order = torch.sort(geo.depth[g_all], stable=True).indices
    order = order[torch.sort(tile[order], stable=True).indices]
    tcount = torch.bincount(tile, minlength=gx * gy)
    return Bins(owner=g_all[order], starts=torch.cumsum(tcount, 0) - tcount, counts=tcount,
                demand=demand)


class Work(NamedTuple):
    """What the blend on these inputs needs (the kernels' rule of
    operations, on the reference's lists): pixel-instance pairs the
    forward visits and the backward replays, the pairs that contribute,
    the pixels that saturate, and the instances each direction reads."""

    visited: int
    replayed: int
    contributing: int
    saturated: int
    read_fwd: int
    read_bwd: int
    tiles: int


def _blocks(bins: Bins):
    """Tiles in blocks of similar length: (tile ids, padded length)."""
    order = torch.argsort(bins.counts, descending=True)
    counts = bins.counts[order].tolist()
    i = 0
    while i < len(counts) and counts[i] > 0:
        L = counts[i]
        b = max(1, BLOCK_ELEMENTS // (PIX * L))
        yield order[i:i + b], L
        i += b


def _pixel_index(tiles: torch.Tensor, width: int, height: int):
    """(B, 256) pixel x, y of each tile's pixels, and their flat index in
    the image (-1 outside it)."""
    gx = -(-width // TILE)
    lp = torch.arange(PIX, device=tiles.device)
    px = (tiles % gx * TILE)[:, None] + (lp % TILE)[None]
    py = (tiles // gx * TILE)[:, None] + (lp // TILE)[None]
    flat = torch.where((px < width) & (py < height), py * width + px, -1)
    return px.to(torch.float32), py.to(torch.float32), flat


def _blend_block(f, mask, px, py):
    """Front-to-back blending of one block: f (B, L, 10) the tiles'
    instances in order, mask (B, L) the real ones.  Returns colour (B, 256,
    3), final transmittance, inverse depth, and the contributing mask and
    each pixel's stop (position of the saturating instance, or -1)."""
    dx = f[:, None, :, 0] - px[:, :, None]
    dy = f[:, None, :, 1] - py[:, :, None]
    ca, cb, cc = f[:, None, :, 2], f[:, None, :, 3], f[:, None, :, 4]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(f[:, None, :, 5] * torch.exp(power), max=ALPHA_CAP)
    with torch.no_grad():
        elig = mask[:, None, :] & (power <= POWER_EPS) & (alpha >= ALPHA_MIN)
        t_incl = torch.cumprod(1.0 - torch.where(elig, alpha, 0.0), dim=-1)
        bad = elig & (t_incl < T_EPS)
        contrib = elig & ~bad
        stop = torch.where(bad.any(-1), bad.to(torch.uint8).argmax(-1), -1)
    a = torch.where(contrib, alpha, 0.0)
    one_m = 1.0 - a
    t_excl = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]), one_m[..., :-1]], -1), -1)
    w = a * t_excl
    color = torch.einsum("bpl,blc->bpc", w, f[:, :, 6:9])
    invd = (w * f[:, None, :, 9]).sum(-1)
    t_final = t_excl[..., -1] * one_m[..., -1]
    return color, t_final, invd, contrib, stop


def _gather_block(fields, bins: Bins, tiles, L):
    k = torch.arange(L, device=fields.device)
    mask = k[None] < bins.counts[tiles][:, None]
    pos = torch.where(mask, bins.starts[tiles][:, None] + k[None], 0)
    g = bins.owner[pos] if bins.owner.numel() else torch.zeros_like(pos)
    return g, mask


def blend(fields: torch.Tensor, bins: Bins, width: int, height: int, count_work=False):
    """Colour (3, H, W), final transmittance (H, W) and inverse depth
    (H, W), with no autograd graph; with ``count_work`` also the Work."""
    dev = fields.device
    color = torch.zeros(3, height * width, device=dev)
    trans = torch.ones(height * width, device=dev)
    invd = torch.zeros(height * width, device=dev)
    counts = torch.zeros(7, dtype=torch.long, device=dev)
    with torch.no_grad():
        for tiles, L in _blocks(bins):
            g, mask = _gather_block(fields, bins, tiles, L)
            px, py, flat = _pixel_index(tiles, width, height)
            c, t, d, contrib, stop = _blend_block(fields[g], mask, px, py)
            inside = flat >= 0
            color[:, flat[inside]] = c[inside].T
            trans[flat[inside]] = t[inside]
            invd[flat[inside]] = d[inside]
            if count_work:
                n = bins.counts[tiles][:, None]
                sat = stop >= 0
                vis = torch.where(sat, stop + 1, n)
                rep = torch.where(sat, stop, n)
                counts += torch.stack([
                    vis.sum(), rep.sum(), contrib.sum(), sat.sum(),
                    torch.where(sat.all(1), stop.max(1).values + 1, n[:, 0]).sum(),
                    torch.where(sat.all(1), stop.max(1).values, n[:, 0]).sum(),
                    torch.tensor(tiles.numel(), device=dev)])
    out = (color.reshape(3, height, width), trans.reshape(height, width),
           invd.reshape(height, width))
    if not count_work:
        return out
    c = counts.tolist()
    gx, gy = -(-width // TILE), -(-height // TILE)
    return out + (Work(c[0], c[1], c[2], c[3], c[4], c[5], gx * gy),)


def blend_backward(fields: torch.Tensor, bins: Bins, width: int, height: int,
                   d_color: torch.Tensor, d_trans: torch.Tensor, d_invd: torch.Tensor):
    """The gradient of the blend's outputs, given their cotangents, with
    respect to ``fields``: (P, 10)."""
    out = torch.zeros_like(fields)
    dc = d_color.reshape(3, -1)
    dt = d_trans.reshape(-1)
    dd = d_invd.reshape(-1)
    base = fields.detach()
    for tiles, L in _blocks(bins):
        g, mask = _gather_block(base, bins, tiles, L)
        px, py, flat = _pixel_index(tiles, width, height)
        f = base[g].requires_grad_(True)
        with torch.enable_grad():
            c, t, d, _, _ = _blend_block(f, mask, px, py)
        inside = (flat >= 0).to(torch.float32)
        fl = flat.clamp(min=0)
        gc = dc[:, fl].permute(1, 2, 0) * inside[..., None]
        (gf,) = torch.autograd.grad((c, t, d), (f,), (gc, dt[fl] * inside, dd[fl] * inside))
        out.index_add_(0, g[mask], gf[mask])
    return out


def render(fields: torch.Tensor, bins: Bins, width: int, height: int, bg: torch.Tensor,
           count_work=False):
    """Image (3, H, W) composited over ``bg`` and clipped to [0, 1], and
    inverse depth (H, W); with ``count_work`` also the Work."""
    res = blend(fields, bins, width, height, count_work)
    color, trans, invd = res[:3]
    image = torch.clamp(color + trans[None] * bg[:, None, None], 0.0, 1.0)
    return (image, invd) + tuple(res[3:])


def view(params: Dict[str, torch.Tensor], alive: torch.Tensor, cam: Camera, bg: torch.Tensor,
         sh_degree: int, count_work=False):
    """Inference render of the stored parameters: (image, inverse depth,
    Geometry, Bins[, Work])."""
    with torch.no_grad():
        geo = project(*activate(params, alive), cam, sh_degree)
        bins = bin_instances(geo, cam.width, cam.height)
        out = render(geo.fields, bins, cam.width, cam.height, bg, count_work)
    return out[:2] + (geo, bins) + out[2:]
