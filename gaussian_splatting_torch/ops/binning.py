"""Tile binning, the layout oracle: instance expansion, (tile, depth) sort,
chunk-aligned tile ranges.

Counterpart of ``gaussian_splatting_tpu/ops/binning.py`` (the first
instance pipeline, which JAX's tests hold ``build_instances`` against).
Plain tensor bookkeeping on no path: ``tests/test_torch_binning.py`` holds
it bit for bit against JAX's and holds the port's ``build_instances``
against it.

Slot s belongs to the last Gaussian whose first slot (exclusive cumsum of
``tiles_touched``) is <= s; its (tile x, tile y) comes from the span table
(or the rect walk for tall rects), exactly as the expand kernel computes
it.  The two-key stable sort on (tile, depth) is one stable sort of the
int64 key ``tile << 32 | float_bits(depth)`` (depths are positive or inf).
Every tile's range then starts at a multiple of ``chunk``
(``gaussian_ids == -1`` pads the gap), and ``pos_expansion`` maps each
expansion slot to its aligned slot.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussian_splatting_torch.ops.expand import _float_bits
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians

# float32 carries integers exactly up to 2^24; offsets and capacities stay below
MAX_CAPACITY = 1 << 24


class BinnedInstances(NamedTuple):
    gaussian_ids: torch.Tensor  # (aligned_capacity,) int32, -1 = padding
    tile_starts: torch.Tensor  # (num_tiles,) int32, multiples of chunk
    tile_ends: torch.Tensor  # (num_tiles,) int32, start + true count
    pos_expansion: torch.Tensor  # (capacity,) int32 expansion slot -> aligned slot
    seg_starts: torch.Tensor  # (P,) int32 expansion-segment start per Gaussian
    seg_ends: torch.Tensor  # (P,) int32 expansion-segment end (clamped)
    num_instances: torch.Tensor  # () int32 instance count (capped at capacity)
    total_aligned: torch.Tensor  # () int32 end of the written region
    overflow: torch.Tensor  # () bool capacity exceeded, results truncated


def aligned_capacity(capacity: int, grid_x: int, grid_y: int, chunk: int) -> int:
    """Size of the chunk-aligned instance buffer."""
    return capacity + grid_x * grid_y * chunk


def bin_gaussians(
    proj: ProjectedGaussians,
    *,
    grid_x: int,
    grid_y: int,
    capacity: int,
    chunk: int = 128,
    tile_w: int = 16,
    tile_h: int = 16,
    grad_layout: bool = True,
) -> BinnedInstances:
    """Expand Gaussians to per-tile instances and sort them by (tile,
    depth).  ``grad_layout=False`` fills ``pos_expansion`` with
    ``aligned_capacity`` instead of the expansion -> aligned map."""
    if capacity >= MAX_CAPACITY:
        raise ValueError(f"instance capacity {capacity} exceeds f32-exact range")
    dev = proj.tiles_touched.device
    i32 = torch.int32
    num_tiles = grid_x * grid_y
    tiles_touched = proj.tiles_touched.to(i32)
    incl = torch.cumsum(tiles_touched, 0, dtype=i32)
    offsets = incl - tiles_touched
    total = incl[-1] if tiles_touched.numel() else torch.zeros((), dtype=i32, device=dev)
    overflow = total > capacity

    # slot -> Gaussian: ones at each Gaussian's first slot (past capacity
    # dropped), then an inclusive scan
    marks = torch.zeros((capacity,), dtype=i32, device=dev)
    keep = offsets < capacity
    marks.index_add_(0, offsets[keep].long(), torch.ones_like(offsets[keep]))
    g = torch.cumsum(marks, 0, dtype=i32) - 1

    table = torch.stack([
        offsets.to(torch.float32),
        proj.rect_min[:, 0].to(torch.float32),
        proj.rect_min[:, 1].to(torch.float32),
        torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=1).to(torch.float32),
        torch.where(proj.valid, proj.depths, torch.inf),
        proj.means2d[:, 0],
        proj.means2d[:, 1],
        proj.cut_radius,
    ], dim=1)
    gl = g.long()
    rows = table[gl]
    slots = torch.arange(capacity, dtype=i32, device=dev)
    in_range = slots < torch.clamp(total, max=capacity)
    local = slots - rows[:, 0].to(i32)
    safe_w = rows[:, 3].to(i32)

    cum = proj.span_cum[gl].to(i32)
    x0 = proj.span_x0[gl].to(i32)
    r = torch.sum(cum <= local[:, None], dim=1, dtype=i32)
    jj = torch.arange(cum.shape[1], dtype=i32, device=dev)[None, :]
    base = torch.sum(torch.where(jj == (r - 1)[:, None], cum, 0), dim=1, dtype=i32)
    x0_sel = torch.sum(torch.where(jj == r[:, None], x0, 0), dim=1, dtype=i32)
    is_span = proj.span_flag[gl]
    ty = rows[:, 2].to(i32) + torch.where(is_span, r, local // safe_w)
    tx = torch.where(is_span, x0_sel + (local - base), rows[:, 1].to(i32) + local % safe_w)
    tile = torch.where(in_range, ty * grid_x + tx, num_tiles).to(i32)
    depth = torch.where(in_range, rows[:, 4], torch.inf)

    _, order = torch.sort((tile.long() << 32) | _float_bits(depth), stable=True)
    sorted_tile = tile[order]
    sorted_g = g[order]

    tile_ids = torch.arange(num_tiles, dtype=i32, device=dev)
    starts = torch.searchsorted(sorted_tile, tile_ids, side="left").to(i32)
    ends = torch.searchsorted(sorted_tile, tile_ids, side="right").to(i32)
    counts = ends - starts

    cap_aligned = aligned_capacity(capacity, grid_x, grid_y, chunk)
    aligned_counts = (counts + chunk - 1) // chunk * chunk
    aligned_starts = torch.cumsum(aligned_counts, 0, dtype=i32) - aligned_counts
    total_aligned = (aligned_starts[-1] + aligned_counts[-1] if num_tiles
                     else torch.zeros((), dtype=i32, device=dev))

    # aligned destination of each sorted position; padding sorts past the end
    slot_tile = torch.clamp(sorted_tile, 0, num_tiles - 1).long()
    pos = aligned_starts[slot_tile] + (slots - starts[slot_tile])
    pos = torch.where(sorted_tile < num_tiles, pos, cap_aligned)
    ids_aligned = torch.full((cap_aligned,), -1, dtype=i32, device=dev)
    written = pos < cap_aligned
    ids_aligned[pos[written].long()] = sorted_g[written]

    if grad_layout:  # the inverse of the sort's permutation, applied to pos
        pos_expansion = torch.empty_like(pos)
        pos_expansion[order] = pos
    else:
        pos_expansion = torch.full((capacity,), cap_aligned, dtype=i32, device=dev)

    return BinnedInstances(
        gaussian_ids=ids_aligned,
        tile_starts=aligned_starts,
        tile_ends=aligned_starts + counts,
        pos_expansion=pos_expansion,
        seg_starts=torch.clamp(offsets, max=capacity),
        seg_ends=torch.clamp(incl, max=capacity),
        num_instances=torch.clamp(total, max=capacity).to(i32),
        total_aligned=total_aligned,
        overflow=overflow,
    )
