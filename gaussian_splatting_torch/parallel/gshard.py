"""Gaussian-sharded, tile-sharded rendering and training.

Counterpart of ``gaussian_splatting_tpu/parallel/gshard.py``.  Each of the n
ranks owns a contiguous 1/n of the Gaussian capacity and one horizontal
stripe of ``grid_y_local`` tile rows of the image.  A rank projects its own
Gaussians, packs each one's 16-column record (``pack_records``), routes to
each stripe the records of the Gaussians that overlap it
(``route_records``), swaps them with one ``all_to_all``, and blends its
stripe from the records it received (``stripe_from_records``: the render
core's K1 + sort -> K2 -> K3 at ``grid_y_local`` tile rows).  Sharding by
tiles keeps each pixel's whole blend list on one rank, so no cross-rank
compositing is needed.  The pieces are separate functions so that n ranks
can be emulated in one process.

``gshard_train_step`` computes the loss stripe by stripe (L1 and SSIM
partial sums, summed over ranks; SSIM's 11x11 window sees its neighbours
through a 5-row halo of the predicted image) and runs Adam on each rank's
own shard.  Autograd sends gradients back through the halo and the
exchange; the sum over ranks multiplies every gradient by n (see
``collectives``), which the step divides back out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, STAT_NAMES, GaussianModel
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.expand import BIG
from gaussian_splatting_torch.ops.losses import absolute, fused_ssim_weighted_sum
from gaussian_splatting_torch.ops.preprocess import (
    ProjectedGaussians,
    clip,
    compute_tile_spans,
    maximum,
    preprocess,
)
from gaussian_splatting_torch.ops.rasterize import blend_fields, rasterize_fields
from gaussian_splatting_torch.parallel import collectives as coll
from gaussian_splatting_torch.parallel import mesh
from gaussian_splatting_torch.train.optim import AdamState
from gaussian_splatting_torch.train.step import (
    StepBatch,
    TrainState,
    apply_exposure,
    apply_gradients,
    step_metrics,
)
from gaussian_splatting_torch.utils.schedules import expon_lr

# Exchange record: the 10 differentiable blend fields (``blend.F_*`` order),
# then 6 geometry columns that carry no gradient.
R_DEPTH, R_RX0, R_RY0, R_RX1, R_RY1, R_CUTR = range(10, 16)
REC_COLS = 16
HALO = 5  # rows of the SSIM window's reach (11 // 2)


def pack_records(proj: ProjectedGaussians) -> torch.Tensor:
    """(P, 16) exchange records.  The depth column is ``BIG`` for a Gaussian
    that owns no tile."""
    geometry = torch.stack([
        torch.where(proj.valid & (proj.tiles_touched > 0), proj.depths, BIG),
        proj.rect_min[:, 0].to(torch.float32),
        proj.rect_min[:, 1].to(torch.float32),
        proj.rect_max[:, 0].to(torch.float32),
        proj.rect_max[:, 1].to(torch.float32),
        proj.cut_radius,
    ], dim=1).detach()
    return torch.cat([blend_fields(proj), geometry], dim=1)


def route_records(
    rec: torch.Tensor, proj: ProjectedGaussians, *, n: int, grid_y_local: int, cap_x: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (n, cap_x, 16) sends: for destination stripe e, the first
    ``cap_x`` Gaussians whose tile rect overlaps it, in index order (a stable
    sort on a 0/1 key), padded with other rows whose depth is set to ``BIG``.
    Also the overflow flag: some stripe wanted more than ``cap_x``."""
    if cap_x > rec.shape[0]:
        raise ValueError(f"route_records: cap_x {cap_x} exceeds the {rec.shape[0]} records")
    touched = proj.valid & (proj.tiles_touched > 0)
    s0 = torch.clamp(proj.rect_min[:, 1] // grid_y_local, 0, n - 1)
    s1 = torch.clamp((proj.rect_max[:, 1] - 1) // grid_y_local, 0, n - 1) + 1
    s1 = torch.where(touched, s1, s0)  # a Gaussian without tiles goes nowhere
    depth_col = torch.arange(REC_COLS, device=rec.device) == R_DEPTH
    sends, counts = [], []
    for e in range(n):
        mask = touched & (s0 <= e) & (e < s1)
        idx = torch.argsort((~mask).to(torch.int32), stable=True)[:cap_x]
        pad = depth_col[None, :] & ~mask[idx][:, None]
        sends.append(torch.where(pad, BIG, rec[idx]))
        counts.append(mask.sum())
    return torch.stack(sends), torch.stack(counts).max() > cap_x


def stripe_from_records(
    flat: torch.Tensor,
    *,
    d: int,
    grid_x: int,
    grid_y_local: int,
    tile_w: int,
    tile_h: int,
    width: int,
    capacity: int,
    bg_color: torch.Tensor,
    kernels: bool = True,
):
    """Blend stripe ``d`` from the (m, 16) records it received.  Returns
    the background-composited colour (3, S, width) and the inverse depth
    (S, width), S = ``grid_y_local * tile_h``, plus the stripe's overflow
    flag and slot demand.  Differentiable in record columns 0-9 when they
    require grad.  ``kernels=False`` runs the kernels' plain twins."""
    y0_tiles = d * grid_y_local
    geo = flat.detach()
    depths = geo[:, R_DEPTH]
    valid = depths < BIG
    ry0 = torch.clamp(geo[:, R_RY0].to(torch.int32) - y0_tiles, 0, grid_y_local)
    ry1 = torch.clamp(geo[:, R_RY1].to(torch.int32) - y0_tiles, 0, grid_y_local)
    rx0 = geo[:, R_RX0].to(torch.int32)
    rx1 = geo[:, R_RX1].to(torch.int32)
    # a whole number of tile rows: the shift is exact in float32, so the
    # stripe's spans are the single render's spans of these rows
    y_shift = float(y0_tiles * tile_h)
    fields = torch.cat([flat[:, 0:1], flat[:, 1:2] - y_shift, flat[:, 2:10]], dim=1)
    means2d = torch.stack([geo[:, 0], geo[:, 1] - y_shift], dim=1)
    # preprocess's opacity term, from the received (antialiased) opacity
    tau = 2.0 * torch.log(maximum(255.0 * geo[:, 5], 1.0))
    span_x0, span_cum, tiles, span_flag = compute_tile_spans(
        means2d, geo[:, 2:5], tau, geo[:, R_CUTR], rx0, ry0, rx1, ry1,
        tile_w=tile_w, tile_h=tile_h)
    m = flat.shape[0]
    zeros = torch.zeros((m, 3), dtype=torch.float32, device=flat.device)
    pseudo = ProjectedGaussians(
        means2d=means2d, depths=depths, conics=zeros, opacities=zeros[:, 0], colors=zeros,
        radii=torch.zeros((m,), dtype=torch.int32, device=flat.device),
        rect_min=torch.stack([rx0, ry0], dim=1), rect_max=torch.stack([rx1, ry1], dim=1),
        tiles_touched=torch.where(valid, tiles, 0).to(torch.int32), valid=valid,
        cut_radius=geo[:, R_CUTR], span_x0=span_x0, span_cum=span_cum, span_flag=span_flag,
    )
    img, overflow, num_instances = rasterize_fields(
        fields.contiguous(), pseudo, grid_x=grid_x, grid_y=grid_y_local, tile_w=tile_w,
        tile_h=tile_h, width=width, height=grid_y_local * tile_h, capacity=capacity,
        kernels=kernels)
    color = img[bl.O_R : bl.O_B + 1] + img[bl.O_T][None] * bg_color[:, None, None]
    return color, img[bl.O_INVD], overflow, num_instances


def _geometry(cam: CameraParams, cfg: RasterizeConfig, n: int):
    """(tile_w, tile_h, grid_x, grid_y_local): the tile rows padded to a
    multiple of n stripes."""
    grid_x = -(-cam.width // cfg.tile_w)
    grid_y = -(-cam.height // cfg.tile_h)
    return cfg.tile_w, cfg.tile_h, grid_x, -(-grid_y // n)


def default_cap_x(P_total: int, n: int) -> int:
    """Records per destination stripe when the caller names none: twice a
    stripe's even share of a shard, at least 256."""
    return max(256, 2 * P_total // (n * n) + 128)


def _capacities(P_total: int, n: int, cfg: RasterizeConfig, cap_x: int):
    """(cap_x, stripe capacity): records per destination, at most a shard
    (``default_cap_x`` when ``cap_x`` is 0), and instance slots per stripe,
    which hold one sentinel per received record besides the stripe's share
    of the slack."""
    cap_x = min(cap_x or default_cap_x(P_total, n), P_total // n)
    capacity = int(cfg.instance_slack * P_total) // n + n * cap_x + 1024
    return cap_x, -(-capacity // cfg.chunk) * cfg.chunk


def _exchange(proj: ProjectedGaussians, n: int, grid_y_local: int, cap_x: int):
    """pack -> route -> all_to_all: the (n * cap_x, 16) records of this
    rank's stripe, rank-major, and the routing overflow flag."""
    send, overflow = route_records(pack_records(proj), proj, n=n, grid_y_local=grid_y_local,
                                   cap_x=cap_x)
    return coll.all_to_all(send).reshape(n * cap_x, REC_COLS), overflow


def render_gaussian_sharded(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor,
    cam: CameraParams,
    bg_color: torch.Tensor,
    *,
    sh_degree: int,
    cfg: RasterizeConfig = RasterizeConfig(),
    exchange_capacity: int = 0,
    return_overflow: bool = False,
):
    """The sharded render; each rank passes its own equal shard of the
    Gaussians and gets the whole (3, H, W) image, clipped to [0, 1].
    Differentiable in the shard.  With ``return_overflow`` also the () bool
    that an exchange buffer or a stripe's instance buffer overflowed on any
    rank (grow and render again)."""
    n, d = mesh.world_size(), mesh.rank()
    tile_w, tile_h, grid_x, grid_y_local = _geometry(cam, cfg, n)
    cap_x, capacity = _capacities(means3d.shape[0] * n, n, cfg, exchange_capacity)
    proj = preprocess(means3d, scales, quats, opacities, sh, cam, sh_degree=sh_degree,
                      tile_w=tile_w, tile_h=tile_h, antialiasing=cfg.antialiasing)
    flat, xovf = _exchange(proj, n, grid_y_local, cap_x)
    color, _, ovf, _ = stripe_from_records(
        flat, d=d, grid_x=grid_x, grid_y_local=grid_y_local, tile_w=tile_w, tile_h=tile_h,
        width=cam.width, capacity=capacity, bg_color=bg_color)
    stripes = coll.all_gather(color)  # (n, 3, S, W)
    image = stripes.permute(1, 0, 2, 3).reshape(3, -1, cam.width)[:, : cam.height]
    image = clip(image, 0.0, 1.0)
    if return_overflow:
        return image, coll.all_reduce_max(ovf | xovf)
    return image


def gshard_train_step(
    state: TrainState,
    cam: CameraParams,
    batch: StepBatch,
    *,
    opt: OptimizationConfig,
    raster: RasterizeConfig,
    use_exposure: bool = False,
    use_depth: bool = False,
    exchange_capacity: int = 0,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One sharded iteration (``train.step.train_step``'s semantics).
    ``state`` is this rank's shard (``shard_state``): every per-Gaussian
    tensor holds its 1/n of the capacity; exposures and the step are
    replicated.  Updates the shard in place; the metrics are the whole
    step's, the same on every rank."""
    n, d = mesh.world_size(), mesh.rank()
    model = state.model
    dev = model.means3d.device
    tile_w, tile_h, grid_x, grid_y_local = _geometry(cam, raster, n)
    W, H = cam.width, cam.height
    cap_x, capacity = _capacities(model.capacity * n, n, raster, exchange_capacity)
    leaves = model.params()
    exposures = state.exposures.detach().requires_grad_(use_exposure)
    tap = torch.zeros((model.capacity, 2), dtype=torch.float32, device=dev, requires_grad=True)

    with torch.enable_grad():
        proj = preprocess(*model.activated_params(), cam, sh_degree=model.max_sh_degree,
                          tile_w=tile_w, tile_h=tile_h, antialiasing=raster.antialiasing)
        # the densification tap in NDC units, as in rasterize.render
        ndc_scale = torch.tensor([0.5 * W, 0.5 * H], dtype=torch.float32, device=dev)
        proj = proj._replace(means2d=proj.means2d + tap * ndc_scale)
        flat, xovf = _exchange(proj, n, grid_y_local, cap_x)
        color, invd, ovf, ninst = stripe_from_records(
            flat, d=d, grid_x=grid_x, grid_y_local=grid_y_local, tile_w=tile_w,
            tile_h=tile_h, width=W, capacity=capacity, bg_color=batch.bg_color)

        # The stripe-local loss: each rank sums L1 and SSIM over its own S
        # rows and the sums are added over ranks.  Rows past H and the halo
        # beyond the mesh ends are zero, which is the blur's zero padding,
        # so the sum is the single-device loss.
        S = grid_y_local * tile_h
        y0 = d * S
        bottom = n * S - H
        img_s = clip(color, 0.0, 1.0)
        if use_exposure:
            img_s = apply_exposure(img_s, exposures[batch.exposure_idx])
        mask = F.pad(batch.alpha_mask.expand(1, H, W).to(torch.float32), (0, 0, 0, bottom))
        img_s = img_s * mask[:, y0 : y0 + S]
        gt_pad = F.pad(batch.gt_image * batch.alpha_mask, (0, 0, HALO, bottom + HALO))
        gt_ext = gt_pad[:, y0 : y0 + S + 2 * HALO]
        gt_s = gt_ext[:, HALO:-HALO]
        pred_ext = coll.halo_exchange(img_s, HALO)
        rows_valid = (y0 + torch.arange(S, device=dev)) < H
        # selects this stripe's image rows; carries the mean's denominator
        weight = (F.pad(rows_valid.to(torch.float32), (HALO, HALO))[:, None]
                  * torch.ones((1, W), device=dev) / (3.0 * H * W))
        ssim_val = coll.all_reduce_sum(fused_ssim_weighted_sum(pred_ext, gt_ext, weight))
        l1 = coll.all_reduce_sum(torch.sum(absolute(img_s - gt_s))) / (3.0 * H * W)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim_val)
        depth_loss = torch.zeros((), dtype=torch.float32, device=dev)
        if use_depth:
            w = expon_lr(state.step + 1, lr_init=opt.depth_l1_weight_init,
                         lr_final=opt.depth_l1_weight_final, max_steps=opt.iterations)
            dmask = F.pad(batch.depth_mask.expand(H, W).to(torch.float32), (0, 0, 0, bottom))
            dgt = F.pad(batch.invdepth_gt.expand(H, W), (0, 0, 0, bottom))
            err = (absolute(invd - dgt[y0 : y0 + S]) * dmask[y0 : y0 + S]
                   * rows_valid[:, None])
            depth_loss = w * (coll.all_reduce_sum(torch.sum(err)) / (H * W))
            loss = loss + depth_loss
        wrt = list(leaves.values()) + [tap] + ([exposures] if use_exposure else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]

    with torch.no_grad():
        # every gradient through the sum over ranks came back n-fold
        g_params = {k: g / n for k, g in zip(leaves, grads)}
        g_tap = grads[len(leaves)] / n
        # exposure is applied stripe by stripe: its gradient is a partial
        g_exp = coll.all_reduce_sum(grads[-1]) / n if use_exposure else None
        overflow = coll.all_reduce_max(ovf | xovf)
        apply_gradients(state, g_params, g_tap, g_exp, proj.radii, overflow, opt=opt,
                        use_exposure=use_exposure)
        return state, step_metrics(
            loss.detach(), l1.detach(), depth_loss.detach(), overflow,
            coll.all_reduce_sum(ninst), coll.all_reduce_sum(model.num_alive()))


def _map_state(state: TrainState, per_gaussian) -> TrainState:
    """A new state: ``per_gaussian`` of every tensor with a capacity axis,
    copies of the replicated ones."""
    m = state.model
    model = GaussianModel(
        **{k: per_gaussian(getattr(m, k).detach()) for k in PARAM_NAMES},
        alive=per_gaussian(m.alive), max_sh_degree=m.max_sh_degree, sh_degree=m.sh_degree,
        spatial_lr_scale=m.spatial_lr_scale,
        stats={k: per_gaussian(getattr(m, k)) for k in STAT_NAMES},
    )
    adam = AdamState(count=state.adam.count.clone(),
                     mu={k: per_gaussian(v) for k, v in state.adam.mu.items()},
                     nu={k: per_gaussian(v) for k, v in state.adam.nu.items()})
    exp_adam = AdamState(count=state.exp_adam.count.clone(),
                         mu={k: v.clone() for k, v in state.exp_adam.mu.items()},
                         nu={k: v.clone() for k, v in state.exp_adam.nu.items()})
    return TrainState(model=model, adam=adam, exposures=state.exposures.clone(),
                      exp_adam=exp_adam, step=state.step.clone())


def shard_state(state: TrainState, rank: int = None, world: int = None) -> TrainState:
    """Rank ``rank``'s contiguous 1/``world`` of every per-Gaussian tensor
    (this process's rank and world by default); the capacity must divide."""
    r = mesh.rank() if rank is None else rank
    n = mesh.world_size() if world is None else world
    cap = state.model.capacity
    if cap % n:
        raise ValueError(f"shard_state: capacity {cap} is not a multiple of {n} ranks")
    k = cap // n
    return _map_state(state, lambda t: t[r * k : (r + 1) * k].clone())


def gather_state(shard: TrainState) -> TrainState:
    """The whole state on every rank: each shard's tensors all-gathered
    along the capacity axis, rank-major (the inverse of ``shard_state``)."""

    def gather(t):
        return coll.all_gather(t).reshape((-1,) + t.shape[1:])

    with torch.no_grad():
        return _map_state(shard, gather)
