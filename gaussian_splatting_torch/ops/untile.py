"""K3 untile and K4 retile: packed per-tile records <-> (C, H, W) planes.

Counterpart of ``gaussian_splatting_tpu/ops/untile.py``: ``untile_pallas``
(K3, forward) and ``_retile_raw`` (K4, its VJP), wired together by
``_Untile`` as JAX wires them with ``custom_vjp``.  The untile kernel crops
to (H, W) itself and the retile kernel pads with zeros itself, so neither
direction materialises the padded image.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from gaussian_splatting_torch import _kernels


def untile(
    packed: torch.Tensor,  # (grid_y*grid_x, tile_h*tile_w, cols_in) f32
    *,
    grid_x: int,
    grid_y: int,
    tile_w: int,
    tile_h: int,
    width: int,
    height: int,
    cols: int,
) -> torch.Tensor:
    """The first ``cols`` packed columns as (cols, height, width) planes.

    ``packed`` may be a leading-column slice of wider records (the render
    core's 5-column view of its 8-column output).  CPU tensors run the plain
    version; CUDA tensors launch the kernel."""
    kw = dict(grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h,
              width=width, height=height, cols=cols)
    if packed.device.type == "cpu":
        return untile_plain(packed, **kw)
    _kernels.check_cuda("untile", packed, contiguous=False)
    n_tiles, pix, cols_in = packed.shape
    row = packed.stride(1)  # floats per pixel record, >= cols_in for a slice
    if packed.stride(2) != 1 or packed.stride(0) != pix * row:
        raise ValueError("untile: packed must hold whole pixel records in order")
    if packed.dtype != torch.float32 or n_tiles != grid_x * grid_y or (
        pix != tile_w * tile_h
    ) or cols > cols_in or width > grid_x * tile_w or height > grid_y * tile_h:
        raise ValueError("untile: packed shape does not match the grid")
    out = torch.empty((cols, height, width), dtype=torch.float32, device=packed.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "untile", "gs_untile", [vp] + [ci] * 7 + [vp] * 2,
        packed.data_ptr(), row, cols, grid_x, tile_w, tile_h, height, width,
        out.data_ptr(), _kernels.current_stream(packed.device),
    )
    return out


def untile_plain(
    packed: torch.Tensor, *, grid_x, grid_y, tile_w, tile_h, width, height, cols
) -> torch.Tensor:
    """Plain twin: a reshape / permute, then the crop."""
    img = untile_padded(packed[:, :, :cols], grid_x=grid_x, grid_y=grid_y,
                        tile_w=tile_w, tile_h=tile_h)
    return img[:, :height, :width].contiguous()


def untile_padded(packed: torch.Tensor, *, grid_x, grid_y, tile_w, tile_h) -> torch.Tensor:
    """(tiles, PIX, C) -> (C, grid_y*tile_h, grid_x*tile_w) in one permute."""
    c = packed.shape[-1]
    return (
        packed.reshape(grid_y, grid_x, tile_h, tile_w, c)
        .permute(4, 0, 2, 1, 3)
        .reshape(c, grid_y * tile_h, grid_x * tile_w)
    )


def retile(
    img: torch.Tensor,  # (cols, height, width) f32
    *,
    grid_x: int,
    grid_y: int,
    tile_w: int,
    tile_h: int,
) -> torch.Tensor:
    """(cols, H, W) planes -> (grid_y*grid_x, tile_h*tile_w, cols) records,
    zeros outside (H, W): the adjoint of ``untile``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    kw = dict(grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h)
    if img.device.type == "cpu":
        return retile_plain(img, **kw)
    _kernels.check_cuda("retile", img)
    cols, height, width = img.shape
    if img.dtype != torch.float32 or width > grid_x * tile_w or height > grid_y * tile_h:
        raise ValueError("retile: image shape does not match the grid")
    out = torch.empty((grid_x * grid_y, tile_w * tile_h, cols), dtype=torch.float32,
                      device=img.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "retile", "gs_retile", [vp] + [ci] * 7 + [vp] * 2,
        img.data_ptr(), cols, grid_x, grid_y, tile_w, tile_h, height, width,
        out.data_ptr(), _kernels.current_stream(img.device),
    )
    return out


def retile_plain(img: torch.Tensor, *, grid_x, grid_y, tile_w, tile_h) -> torch.Tensor:
    """Plain twin: zero-pad to the tile grid, then one permute."""
    c, h, w = img.shape
    padded = F.pad(img, (0, grid_x * tile_w - w, 0, grid_y * tile_h - h))
    return (
        padded.reshape(c, grid_y, tile_h, grid_x, tile_w)
        .permute(1, 3, 2, 4, 0)
        .reshape(grid_y * grid_x, tile_h * tile_w, c)
        .contiguous()
    )


class _Untile(torch.autograd.Function):
    """``untile`` whose backward is ``retile`` (K3 forward, K4 backward)."""

    @staticmethod
    def forward(ctx, packed, grid_x, grid_y, tile_w, tile_h, width, height, kernels):
        ctx.grid = dict(grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h)
        ctx.kernels = kernels
        fn = untile if kernels else untile_plain
        return fn(packed, **ctx.grid, width=width, height=height, cols=packed.shape[2])

    @staticmethod
    def backward(ctx, grad):
        fn = retile if ctx.kernels else retile_plain
        return (fn(grad.contiguous(), **ctx.grid),) + (None,) * 7


def untile_differentiable(
    packed: torch.Tensor, *, grid_x, grid_y, tile_w, tile_h, width, height, kernels=True
) -> torch.Tensor:
    """(tiles, PIX, C) -> (C, height, width), differentiable in ``packed``.
    ``kernels=False`` runs both directions through the plain twins."""
    return _Untile.apply(packed, grid_x, grid_y, tile_w, tile_h, width, height, kernels)
