"""K3 untile: packed per-tile records -> (C, H, W) image planes.

Counterpart of ``gaussian_splatting_tpu/ops/untile.py::untile_pallas``.  The
kernel crops to (H, W) itself; the retile mirror (the untile's backward)
belongs to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

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

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    kw = dict(grid_x=grid_x, grid_y=grid_y, tile_w=tile_w, tile_h=tile_h,
              width=width, height=height, cols=cols)
    if packed.device.type == "cpu":
        return untile_plain(packed, **kw)
    _kernels.check_cuda("untile", packed)
    n_tiles, pix, cols_in = packed.shape
    if packed.dtype != torch.float32 or n_tiles != grid_x * grid_y or (
        pix != tile_w * tile_h
    ) or cols > cols_in or width > grid_x * tile_w or height > grid_y * tile_h:
        raise ValueError("untile: packed shape does not match the grid")
    out = torch.empty((cols, height, width), dtype=torch.float32, device=packed.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "untile", "gs_untile", [vp] + [ci] * 7 + [vp] * 2,
        packed.data_ptr(), cols_in, cols, grid_x, tile_w, tile_h, height, width,
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
