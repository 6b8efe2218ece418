"""The render op: preprocess -> instances (K1 + sort) -> blend (K2) -> untile
(K3) -> background compositing.

Counterpart of ``gaussian_splatting_tpu/ops/rasterize.py::render``.  This
slice is forward only: the training path (the custom backward over blend,
segment reduce and retile) belongs to a later slice, so a call that would
need gradients raises instead of silently detaching.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import untile as ut
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.oracle import render_dense
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians, preprocess
from gaussian_splatting_torch.ops.sh import sh_to_color
from gaussian_splatting_torch.ops.transforms import build_covariance

# Names of the tiled path, which runs the CUDA kernels.  "jax" named the JAX
# package's own tiled variant; a model trained with it renders the same here.
TILED_IMPLS = ("auto", "pallas", "jax")


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
    capacity: Optional[int] = None,
    scale_modifier: float = 1.0,
    impl: Optional[str] = None,
    inference: bool = False,
) -> RenderResult:
    """Render P Gaussians to an image (reference ``render()``, minus the
    exposure affine, which callers apply)."""
    inputs = (means3d, scales, quats, opacities, sh)
    if not inference and torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise NotImplementedError("training path: a later slice")
    with torch.no_grad():
        return _render(
            *inputs, cam, bg_color, sh_degree=sh_degree, cfg=cfg,
            capacity=capacity, scale_modifier=scale_modifier,
            impl=impl or cfg.impl,
        )


def _render(
    means3d, scales, quats, opacities, sh, cam, bg_color, *, sh_degree,
    cfg=RasterizeConfig(), capacity=None, scale_modifier=1.0, impl="auto",
    kernels=True,
) -> RenderResult:
    """``render`` without its gradient guard.  ``kernels=False`` runs the
    tiled path through the kernels' plain twins on any device, the reference
    that the kernel path is held against on the card."""
    if impl not in TILED_IMPLS + ("dense",):
        raise ValueError(f"unknown rasterizer impl: {impl}")
    P = means3d.shape[0]
    W, H = cam.width, cam.height
    tile_w, tile_h = cfg.tile_w, cfg.tile_h
    grid_x = (W + tile_w - 1) // tile_w
    grid_y = (H + tile_h - 1) // tile_h

    # Debug hooks (reference --compute_cov3D_python / --convert_SHs_python):
    # compute the covariance / colours up front and feed them back in.
    cov3d_precomp = (
        build_covariance(scales, quats, scale_modifier)
        if cfg.compute_cov3D_python else None
    )
    colors_precomp = (
        sh_to_color(sh_degree, sh, means3d, cam.campos)
        if cfg.convert_SHs_python else None
    )
    proj = preprocess(
        means3d, scales, quats, opacities, sh, cam,
        sh_degree=sh_degree, tile_w=tile_w, tile_h=tile_h,
        scale_modifier=scale_modifier, antialiasing=cfg.antialiasing,
        cov3d_precomp=cov3d_precomp, colors_precomp=colors_precomp,
    )

    if impl == "dense":
        out = render_dense(proj, cam, bg_color, tile_w=tile_w, tile_h=tile_h)
        return RenderResult(
            image=torch.clamp(out.color, 0.0, 1.0),
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

    layout = inst.build_instances(
        proj, grid_x=grid_x, grid_y=grid_y, capacity=capacity, use_kernels=kernels
    )
    blend = bl.blend_forward if kernels else bl.blend_forward_plain
    packed = blend(
        layout.sorted_owner, layout.tile_starts, layout.tile_ends,
        blend_fields(proj), grid_x=grid_x, tile_w=tile_w, tile_h=tile_h,
    )
    untile = ut.untile if kernels else ut.untile_plain
    img = untile(
        packed, grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h,
        width=W, height=H, cols=bl.CT_COLS,
    )
    T_img = img[bl.O_T]
    color = img[bl.O_R : bl.O_B + 1] + T_img[None] * bg_color[:, None, None]
    return RenderResult(
        image=torch.clamp(color, 0.0, 1.0),
        invdepth=img[bl.O_INVD],
        final_T=T_img,
        radii=proj.radii,
        visibility=proj.radii > 0,
        overflow=layout.overflow,
        num_instances=layout.num_instances,
    )
