"""K1 expand: Gaussian table -> per-slot (tile, depth) sort keys and owners.

Counterpart of ``gaussian_splatting_tpu/ops/expand.py``.  Every Gaussian
owns a contiguous run of slots in *expansion order* (its exclusive offset up
to the next Gaussian's); Gaussians that touch no tile own one sentinel slot,
and slots past the total demand belong to a terminator (owner ``P``).  For
each slot the kernel emits one int64 key ``tile << 32 | float_bits(depth)``
and the owner index.  Depths of real instances are positive floats, so the
key's integer order is (tile, depth) order; sentinels and terminators carry
``tile = num_tiles`` and ``depth = BIG`` and sort to the dropped tail.

Unlike the TPU version this one carries rect and span tables as plain
integers (no ``PACK_BASE`` packing, so no 4096-tile grid limit) and expands
no blend fields: the blend gathers them through the sorted owner index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from gaussian_splatting_torch import _kernels

# Finite "infinity" for sentinel depths: exact in f32 and above every legal
# slot index and scene depth (JAX expand.BIG).
BIG = float(1 << 24)
MAX_SPAN_ROWS = 16


class ExpandTable(NamedTuple):
    """Per-Gaussian inputs of the expansion, all contiguous on one device."""

    offsets: torch.Tensor  # (P + 1,) int32 exclusive offsets; [P] = total demand
    rect_x0: torch.Tensor  # (P,) int32 rect min x (tiles)
    rect_y0: torch.Tensor  # (P,) int32 rect min y
    rect_w: torch.Tensor  # (P,) int32 rect width, >= 1
    span_flag: torch.Tensor  # (P,) int32 1 = span mapping, 0 = full rect
    span_x0: torch.Tensor  # (P, 16) int32 first tile x per rect row
    span_cum: torch.Tensor  # (P, 16) int32 cumulative cells through each row
    depth_key: torch.Tensor  # (P,) f32 view depth, BIG for sentinel-only


def expand_instances(
    table: ExpandTable, *, capacity: int, grid_x: int, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (keys (capacity,) int64, owner (capacity,) int32).

    The table is ``instances.build_table``'s: offsets non-decreasing from 0
    and span rows cumulative.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if table.depth_key.device.type == "cpu":
        return expand_instances_plain(
            table, capacity=capacity, grid_x=grid_x, num_tiles=num_tiles
        )
    _kernels.check_cuda("expand", *table)
    P = table.depth_key.shape[0]
    if table.offsets.shape != (P + 1,) or table.span_cum.shape != (P, MAX_SPAN_ROWS):
        raise ValueError("expand: table shapes do not match")
    for t in table[:-1]:
        if t.dtype != torch.int32:
            raise ValueError("expand: integer table columns must be int32")
    if table.depth_key.dtype != torch.float32:
        raise ValueError("expand: depth_key must be float32")
    if table.span_x0.data_ptr() % 16 or table.span_cum.data_ptr() % 16:
        raise ValueError("expand: span rows must start on a 16-byte boundary")
    dev = table.depth_key.device
    n_splits = -(-(capacity + P + 1) // _block_items()) + 1
    keys = torch.empty(capacity, dtype=torch.int64, device=dev)
    # the owners, then the kernel's scratch: each block's ends
    owner_splits = torch.empty(capacity + n_splits, dtype=torch.int32, device=dev)
    owner, splits = owner_splits[:capacity], owner_splits[capacity:]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "expand", "gs_expand", [vp] * 8 + [ci] * 4 + [vp] * 4,
        *(t.data_ptr() for t in table),
        P, capacity, grid_x, num_tiles,
        keys.data_ptr(), owner.data_ptr(), splits.data_ptr(), _kernels.current_stream(dev),
    )
    return keys, owner


@functools.cache
def _block_items() -> int:
    """The kernel's merged items (slots and offsets entries) per block."""
    return _kernels.library("expand").gs_expand_block_items()


def expand_instances_plain(
    table: ExpandTable, *, capacity: int, grid_x: int, num_tiles: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the expand kernel (same outputs, bit for bit)."""
    dev = table.depth_key.device
    P = table.depth_key.shape[0]
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    owner = (torch.searchsorted(table.offsets, slot, right=True) - 1).to(torch.int32)
    g = owner.clamp(max=max(P - 1, 0)).long()
    if P == 0:
        keys = torch.full((capacity,), num_tiles << 32, dtype=torch.int64, device=dev)
        return keys | _float_bits(torch.full((capacity,), BIG, device=dev)), owner

    local = slot - table.offsets[owner.long()]
    depth = table.depth_key[g]
    valid = (owner < P) & (depth < BIG)

    cum = table.span_cum[g]  # (cap, 16)
    r = (cum <= local[:, None]).sum(dim=1, dtype=torch.int32)
    base = torch.where(
        r > 0, cum.gather(1, (r - 1).clamp(min=0).long()[:, None])[:, 0], 0
    )
    x0 = torch.where(
        r < MAX_SPAN_ROWS,
        table.span_x0[g].gather(1, r.clamp(max=MAX_SPAN_ROWS - 1).long()[:, None])[:, 0],
        0,
    )
    w = table.rect_w[g]
    q = torch.div(local, w, rounding_mode="floor")
    is_span = table.span_flag[g] != 0
    tx = torch.where(is_span, x0 + (local - base), table.rect_x0[g] + (local - q * w))
    ty = table.rect_y0[g] + torch.where(is_span, r, q)
    tile = torch.where(valid, ty * grid_x + tx, num_tiles).long()
    depth = torch.where(valid, depth, BIG)
    return (tile << 32) | _float_bits(depth), owner


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    """Bits of non-negative float32 values as int64 (order-preserving)."""
    return x.contiguous().view(torch.int32).long()
