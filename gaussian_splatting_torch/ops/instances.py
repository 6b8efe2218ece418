"""Instance pipeline (inference layout): table -> expand (K1) -> stable sort
-> per-tile ranges.

Counterpart of ``gaussian_splatting_tpu/ops/instances.py::build_instances``
with ``grad_layout=False``.  Every Gaussian owns at least one slot (a
zero-tile Gaussian one sentinel slot that sorts to the dropped tail), so
``num_instances`` counts sentinels as the JAX package does.  The JAX two-key
stable ``(tile, depth)`` sort becomes one stable ``torch.sort`` of the int64
key ``tile << 32 | float_bits(depth)``: positive depths order like their
bits, and ties keep expansion (Gaussian-index) order.  Tile ranges are one
``searchsorted`` over the sorted keys.  The blend then reads each instance's
fields through ``sorted_owner``.

With ``grad_layout=True`` (the training path) the layout also keeps what
the backward needs: the sort permutation ``perm`` (sorted position ->
expansion slot, JAX's ``sorted_src``) and each Gaussian's expansion segment
``seg_offsets`` clamped to the internal capacity (JAX's ``seg_starts`` /
``seg_ends``).  The inference layout leaves both ``None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussian_splatting_torch.ops import expand as ex
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians

CHUNK = 128
MAX_CAPACITY = 1 << 24  # f32-exact stream positions (NB is stored as f32)


class InstanceLayout(NamedTuple):
    sorted_keys: torch.Tensor  # (cap_int,) int64 tile << 32 | depth bits
    sorted_owner: torch.Tensor  # (cap_int,) int32 Gaussian per sorted slot
    tile_starts: torch.Tensor  # (num_tiles,) int32
    tile_ends: torch.Tensor  # (num_tiles,) int32
    n_valid: torch.Tensor  # () int32 length of the non-sentinel stream
    num_instances: torch.Tensor  # () int32 sentinel-inclusive demand, capped
    overflow: torch.Tensor  # () bool demand > capacity
    perm: Optional[torch.Tensor] = None  # (cap_int,) int64 expansion slot per sorted slot
    seg_offsets: Optional[torch.Tensor] = None  # (P + 1,) int32, clamped to cap_int

    def sorted_tiles(self) -> torch.Tensor:
        return (self.sorted_keys >> 32).to(torch.int32)


def required_capacity(P: int, instance_slack: float) -> int:
    """Instance-buffer size: ``instance_slack`` per Gaussian (it must cover
    real instances AND one sentinel per untouched Gaussian) + 1024."""
    cap = int(instance_slack * P) + 1024
    return -(-cap // CHUNK) * CHUNK


def internal_capacity(capacity: int) -> int:
    """Slots actually expanded and sorted: capacity plus the JAX package's
    1024-slot tail, rounded to 1024.  Kept so that an overflowing render
    drops exactly the slots the JAX one drops."""
    gran = 8 * CHUNK
    return -(-(capacity + 8 * CHUNK) // gran) * gran


class ProjectedTable(NamedTuple):
    """The per-Gaussian stage in the layout the tiled core reads: the
    (P, 10) blend table, the radii, and the expansion table with its total
    slot demand (sentinels included).  K8 (``ops/project.py``) writes it in
    one pass; ``ops.rasterize.table_of`` builds it from a
    ``ProjectedGaussians``."""

    fields: torch.Tensor  # (P, 10) f32 in blend.F_* column order
    radii: torch.Tensor  # (P,) int32
    table: ex.ExpandTable
    total: torch.Tensor  # () int64


def build_table(proj: ProjectedGaussians):
    """Per-Gaussian expansion table and the total slot demand (sentinels
    included).  Returns (ExpandTable, total () int64)."""
    touched = proj.tiles_touched > 0
    counts = torch.where(touched, proj.tiles_touched, 1)
    incl = torch.cumsum(counts, dim=0, dtype=torch.int64)
    total = incl[-1] if counts.numel() else torch.zeros((), dtype=torch.int64, device=counts.device)
    offsets = torch.cat([incl - counts, total[None]]).to(torch.int32)
    depth_key = torch.where(touched & proj.valid, proj.depths, ex.BIG)
    rect_w = torch.clamp(proj.rect_max[:, 0] - proj.rect_min[:, 0], min=1)
    table = ex.ExpandTable(
        offsets=offsets.contiguous(),
        rect_x0=proj.rect_min[:, 0].to(torch.int32).contiguous(),
        rect_y0=proj.rect_min[:, 1].to(torch.int32).contiguous(),
        rect_w=rect_w.to(torch.int32).contiguous(),
        span_flag=proj.span_flag.to(torch.int32).contiguous(),
        span_x0=proj.span_x0.to(torch.int32).contiguous(),
        span_cum=proj.span_cum.to(torch.int32).contiguous(),
        depth_key=depth_key.to(torch.float32).contiguous(),
    )
    return table, total


def layout_from_keys(
    keys: torch.Tensor, owner: torch.Tensor, total: torch.Tensor, *,
    capacity: int, num_tiles: int, offsets: Optional[torch.Tensor] = None,
) -> InstanceLayout:
    """Stable sort of the expanded keys + per-tile ranges.  Given the
    table's ``offsets``, also the gradient layout (``perm``, ``seg_offsets``)."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    sorted_owner = owner[perm]
    bounds = torch.arange(num_tiles + 1, dtype=torch.int64, device=keys.device) << 32
    starts_ext = torch.searchsorted(sorted_keys, bounds).to(torch.int32)
    return InstanceLayout(
        sorted_keys=sorted_keys,
        sorted_owner=sorted_owner,
        tile_starts=starts_ext[:num_tiles],
        tile_ends=starts_ext[1:],
        n_valid=starts_ext[num_tiles],
        num_instances=torch.clamp(total, max=capacity).to(torch.int32),
        overflow=total > capacity,
        perm=None if offsets is None else perm,
        seg_offsets=None if offsets is None else offsets.clamp(max=keys.shape[0]),
    )


def build_instances(
    table: ex.ExpandTable,
    total: torch.Tensor,
    *,
    grid_x: int,
    grid_y: int,
    capacity: int,
    use_kernels: bool = True,
    grad_layout: bool = False,
) -> InstanceLayout:
    """The layout of ``build_table``'s table and slot demand.
    ``use_kernels=False`` runs the expand's plain twin on any device;
    ``grad_layout=True`` keeps what the backward needs."""
    if capacity >= MAX_CAPACITY:
        raise ValueError(f"instance capacity {capacity} exceeds f32-exact range")
    num_tiles = grid_x * grid_y
    cap_int = internal_capacity(capacity)
    expand = ex.expand_instances if use_kernels else ex.expand_instances_plain
    keys, owner = expand(table, capacity=cap_int, grid_x=grid_x, num_tiles=num_tiles)
    return layout_from_keys(keys, owner, total, capacity=capacity, num_tiles=num_tiles,
                            offsets=table.offsets if grad_layout else None)
