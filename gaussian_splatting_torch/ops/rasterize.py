"""The render op: preprocess -> instances (K1 + sort) -> blend (K2) -> untile
(K3) -> background compositing, and its gradient.

Counterpart of ``gaussian_splatting_tpu/ops/rasterize.py::render``.  Only the
blend core and the untile are hand-written kernels with hand-written
backwards (``_RasterCore``: K5 blend backward -> select of the valid stream
-> scatter to expansion order -> K6 segment reduce; ``ops.untile._Untile``:
K4 retile).  Every other gradient (projection, EWA covariance, SH,
antialiasing rescale, inverse depth) comes from autograd.

The densification tap mirrors the reference's ``screenspace_points``: pass
a zeros (P, 2) tensor that requires grad as ``means2d_tap`` and read its
gradient, scaled by (0.5 W, 0.5 H) into NDC units so that
``densify_grad_threshold`` keeps its reference meaning.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import segreduce as sr
from gaussian_splatting_torch.ops import untile as ut
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.oracle import render_dense
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians, clip, preprocess
from gaussian_splatting_torch.ops.sh import sh_to_color
from gaussian_splatting_torch.ops.transforms import apply_affine, build_covariance

# Names of the tiled path, which runs the CUDA kernels.  "jax" named the JAX
# package's own tiled variant; a model trained with it renders the same here.
TILED_IMPLS = ("auto", "pallas", "jax")


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor) -> torch.Tensor:
    """Frustum-visibility mask (reference ``markVisible``): view-space z > 0.2."""
    return apply_affine(viewmatrix, means3d)[:, 2] > 0.2


class RenderResult(NamedTuple):
    image: torch.Tensor  # (3, H, W) background composited, clipped to [0, 1]
    invdepth: torch.Tensor  # (H, W)
    final_T: torch.Tensor  # (H, W)
    radii: torch.Tensor  # (P,) int32
    visibility: torch.Tensor  # (P,) bool
    overflow: torch.Tensor  # () bool: the instance buffer overflowed
    num_instances: torch.Tensor  # () int32


def blend_fields(proj: ProjectedGaussians) -> torch.Tensor:
    """(P, 10) per-Gaussian blend table in ``blend.F_*`` column order.  The
    inverse depth is 1/depth for every Gaussian that owns an instance."""
    safe_depth = torch.where(proj.valid, proj.depths, 1.0)
    return torch.stack(
        [
            proj.means2d[:, 0], proj.means2d[:, 1],
            proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
            proj.opacities,
            proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2],
            1.0 / safe_depth,
        ],
        dim=1,
    ).to(torch.float32).contiguous()


class _RasterCore(torch.autograd.Function):
    """Instances + blend with a hand-written backward (JAX
    ``_make_render_core``'s ``core``).

    Forward: K1 -> stable sort -> K2; outputs the five columns the render
    consumes, a view of the packed (tiles, 256, 8) block, which is kept with
    the layout for the backward.  Backward: K5 per-slot gradients ->
    ``expansion_order`` -> K6 per-Gaussian sums -> (P, 10) field
    gradients."""

    @staticmethod
    def forward(ctx, fields, proj, grid_x, grid_y, tile_w, tile_h, capacity, kernels):
        layout, packed = _bin_and_blend(proj, fields, grid_x, grid_y, tile_w, tile_h,
                                        capacity, kernels, grad_layout=True)
        ctx.save_for_backward(fields)
        ctx.layout, ctx.packed, ctx.kernels = layout, packed, kernels
        ctx.tiles = dict(grid_x=grid_x, tile_w=tile_w, tile_h=tile_h)
        ctx.mark_non_differentiable(layout.overflow, layout.num_instances)
        return packed[:, :, : bl.CT_COLS], layout.overflow, layout.num_instances

    @staticmethod
    def backward(ctx, ct, _overflow, _count):
        (fields,) = ctx.saved_tensors
        layout = ctx.layout
        backward = bl.blend_backward if ctx.kernels else bl.blend_backward_plain
        d_sorted = backward(
            layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields,
            ctx.packed, ct.contiguous(), **ctx.tiles,
        )
        reduce = sr.segment_reduce_rows if ctx.kernels else sr.segment_reduce_rows_plain
        d_fields = reduce(expansion_order(d_sorted, layout), layout.seg_offsets)
        return (d_fields,) + (None,) * 7


def _bin_and_blend(proj, fields, grid_x, grid_y, tile_w, tile_h, capacity, kernels,
                   grad_layout=False):
    """Instances (K1 + sort) and the blend (K2), or their twins: the layout
    and the packed (tiles, 256, 8) block."""
    layout = inst.build_instances(
        proj, grid_x=grid_x, grid_y=grid_y, capacity=capacity,
        use_kernels=kernels, grad_layout=grad_layout,
    )
    blend = bl.blend_forward if kernels else bl.blend_forward_plain
    packed = blend(
        layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields,
        grid_x=grid_x, tile_w=tile_w, tile_h=tile_h,
    )
    return layout, packed


def expansion_order(d_sorted: torch.Tensor, layout: inst.InstanceLayout) -> torch.Tensor:
    """K5's per-sorted-slot rows in expansion order, K6's input: a SELECT of
    the slots below ``n_valid`` (slots past it are never written, and
    NaN * 0 is NaN), then a scatter by the sort permutation."""
    valid = torch.arange(d_sorted.shape[0], device=d_sorted.device) < layout.n_valid
    d_sorted = torch.where(valid[:, None], d_sorted, 0.0)
    return torch.empty_like(d_sorted).index_copy_(0, layout.perm, d_sorted)


def render(
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
    means2d_tap: Optional[torch.Tensor] = None,
    capacity: Optional[int] = None,
    scale_modifier: float = 1.0,
    impl: Optional[str] = None,
    inference: bool = False,
) -> RenderResult:
    """Render P Gaussians to an image (reference ``render()``, minus the
    exposure affine, which callers apply).  Differentiable in the five
    Gaussian inputs and ``means2d_tap`` unless ``inference``, which renders
    without building any autograd state."""
    kw = dict(sh_degree=sh_degree, cfg=cfg, capacity=capacity,
              scale_modifier=scale_modifier, impl=impl or cfg.impl,
              means2d_tap=means2d_tap)
    inputs = (means3d, scales, quats, opacities, sh)
    if inference:
        with torch.no_grad():
            return _render(*inputs, cam, bg_color, **kw)
    return _render(*inputs, cam, bg_color, **kw)


def _render(
    means3d, scales, quats, opacities, sh, cam, bg_color, *, sh_degree,
    cfg=RasterizeConfig(), capacity=None, scale_modifier=1.0, impl="auto",
    means2d_tap=None, kernels=True,
) -> RenderResult:
    """``render`` without its ``inference`` switch.  ``kernels=False`` runs
    the tiled path, forward and backward, through the kernels' plain twins
    on any device: the reference that the kernel path is held against on
    the card."""
    if impl not in TILED_IMPLS + ("dense",):
        raise ValueError(f"unknown rasterizer impl: {impl}")
    P = means3d.shape[0]
    W, H = cam.width, cam.height
    tile_w, tile_h = cfg.tile_w, cfg.tile_h
    grid_x = (W + tile_w - 1) // tile_w
    grid_y = (H + tile_h - 1) // tile_h

    proj = project(means3d, scales, quats, opacities, sh, cam, sh_degree=sh_degree, cfg=cfg,
                   scale_modifier=scale_modifier)
    if means2d_tap is not None:
        ndc_scale = torch.tensor([0.5 * W, 0.5 * H], dtype=torch.float32,
                                 device=means3d.device)
        proj = proj._replace(means2d=proj.means2d + means2d_tap * ndc_scale)

    if impl == "dense":
        out = render_dense(proj, cam, bg_color, tile_w=tile_w, tile_h=tile_h)
        return RenderResult(
            image=clip(out.color, 0.0, 1.0),
            invdepth=out.invdepth,
            final_T=out.final_T,
            radii=proj.radii,
            visibility=proj.radii > 0,
            overflow=torch.zeros((), dtype=torch.bool, device=means3d.device),
            num_instances=proj.tiles_touched.sum(dtype=torch.int32),
        )

    if capacity is None:
        capacity = inst.required_capacity(P, cfg.instance_slack)
    else:
        capacity = -(-capacity // cfg.chunk) * cfg.chunk

    img, overflow, num_instances = rasterize_fields(
        blend_fields(proj), proj, grid_x=grid_x, grid_y=grid_y, tile_w=tile_w,
        tile_h=tile_h, width=W, height=H, capacity=capacity, kernels=kernels)
    T_img = img[bl.O_T]
    color = img[bl.O_R : bl.O_B + 1] + T_img[None] * bg_color[:, None, None]
    return RenderResult(
        image=clip(color, 0.0, 1.0),
        invdepth=img[bl.O_INVD],
        final_T=T_img,
        radii=proj.radii,
        visibility=proj.radii > 0,
        overflow=overflow,
        num_instances=num_instances,
    )


def project(
    means3d, scales, quats, opacities, sh, cam, *, sh_degree, cfg=RasterizeConfig(),
    scale_modifier=1.0,
) -> ProjectedGaussians:
    """``preprocess`` under ``cfg``'s switches: the antialiasing filter, and
    the debug hooks (reference --compute_cov3D_python / --convert_SHs_python),
    which compute the covariances / colours up front and feed them back in."""
    cov3d_precomp = (
        build_covariance(scales, quats, scale_modifier)
        if cfg.compute_cov3D_python else None
    )
    colors_precomp = (
        sh_to_color(sh_degree, sh, means3d, cam.campos)
        if cfg.convert_SHs_python else None
    )
    return preprocess(
        means3d, scales, quats, opacities, sh, cam,
        sh_degree=sh_degree, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
        scale_modifier=scale_modifier, antialiasing=cfg.antialiasing,
        cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp,
    )


def rasterize_fields(
    fields: torch.Tensor, proj: ProjectedGaussians, *, grid_x: int, grid_y: int,
    tile_w: int, tile_h: int, width: int, height: int, capacity: int, kernels: bool = True,
):
    """The tiled core on a (P, 10) blend table and its binning geometry:
    K1 + sort -> K2 -> K3, differentiable in ``fields`` (K5 -> K6 and K4)
    when they require grad.  Returns the ``CT_COLS`` planes cropped to
    (height, width), the overflow flag and the slot demand."""
    untile_kw = dict(grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h,
                     width=width, height=height)
    if torch.is_grad_enabled() and fields.requires_grad:
        packed, overflow, num_instances = _RasterCore.apply(
            fields, _detached(proj), grid_x, grid_y, tile_w, tile_h, capacity, kernels,
        )
        return ut.untile_differentiable(packed, **untile_kw, kernels=kernels), overflow, \
            num_instances
    layout, packed = _bin_and_blend(proj, fields, grid_x, grid_y, tile_w, tile_h,
                                    capacity, kernels)
    untile = ut.untile if kernels else ut.untile_plain
    return untile(packed, **untile_kw, cols=bl.CT_COLS), layout.overflow, layout.num_instances


def _detached(proj: ProjectedGaussians) -> ProjectedGaussians:
    """The binning geometry, cut from the graph (JAX ``stop_gradient``)."""
    return ProjectedGaussians(*(t.detach() for t in proj))
