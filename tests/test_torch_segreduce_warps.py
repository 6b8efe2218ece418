"""K6's warp decomposition, emulated on the CPU.

The kernel (``csrc/segment_reduce.cu``) runs one warp per 32 consecutive
segments, WARPS warps per block.  A warp reads its 33 offsets, then walks
its segments' contiguous rows in windows of WINDOW rows: it stages a window
as float4s from a 16-byte boundary (scalars for the rows' last floats, or
float by float when the rows do not start on a 16-byte boundary), and each
lane adds the rows of its own segment inside the window, in order, to its
running sums.  This emulates the offsets, the windows and the staging with
the kernel's constants (read from its source) into a NaN-filled shared
buffer, checks that every shared read lands on a staged float, and holds the
sums bitwise against ``segment_reduce_rows_plain`` on the card tests' edge
tables and on the gradient layout of a ``random_scene`` view."""

import os
import re

import pytest
import torch

from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import segreduce as sr
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.utils.testing import (
    SEGREDUCE_EDGE_CASES,
    random_scene,
    segreduce_edge_table,
)

SOURCE = os.path.join(os.path.dirname(sr.__file__), os.pardir, "csrc", "segment_reduce.cu")


def _constant(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


COLS, WARPS, WINDOW = _constant("COLS"), _constant("WARPS"), _constant("WINDOW")
WIN_F4 = (WINDOW * COLS + 2 + 3) // 4  # the kernel's float4s per window


def emulate(rows, offsets, aligned=True):
    """(P, COLS) sums as the kernel forms them, warp by warp."""
    n, P = rows.shape[0], offsets.shape[0] - 1
    out = torch.full((max(P, 0), COLS), float("nan"))
    flat, end = rows.reshape(-1), n * COLS
    b = offsets.long()
    for g0 in range(0, max(P, 0), 32):
        lo = b[(g0 + torch.arange(32)).clamp(max=P)]
        whi = int(b[min(g0 + 32, P)])
        hi = torch.cat([lo[1:], torch.tensor([whi])])
        acc = torch.zeros((32, COLS))
        for c0 in range(int(lo[0]), whi, WINDOW):
            c1 = min(c0 + WINDOW, whi)
            a0, a1 = (c0 * COLS) & ~3, c1 * COLS
            n_f = 4 * ((a1 - a0 + 3) >> 2) if aligned else a1 - a0
            assert n_f <= 4 * WIN_F4
            smem = torch.full((4 * WIN_F4,), float("nan"))
            f = a0 + torch.arange(n_f)
            keep = f < end  # the tail float4 loads no float past the rows' end
            smem[:n_f][keep] = flat[f[keep]]
            r0, r1 = lo.clamp(min=c0), hi.clamp(max=c1)
            for step in range(max(int((r1 - r0).max()), 0)):
                r = r0 + step
                live = r < r1
                src = (r * COLS - a0)[:, None] + torch.arange(COLS)
                # every row read from shared memory was staged there
                assert bool(((src >= 0) & (src < n_f))[live].all())
                vals = smem[src.clamp(0, 4 * WIN_F4 - 1)]
                acc = torch.where(live[:, None], acc + vals, acc)
        out[g0: g0 + 32] = acc[: min(32, P - g0)]
    return out


def _check(rows, offsets, aligned=True):
    got = emulate(rows, offsets, aligned)
    want = sr.segment_reduce_rows_plain(rows, offsets)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_constants():
    assert (COLS, WARPS, WINDOW) == (10, 4, 128)


@pytest.mark.parametrize("name", SEGREDUCE_EDGE_CASES)
def test_warp_emulation_matches_plain_on_edge_tables(name):
    rows, offsets = segreduce_edge_table(name, device="cpu", long_rows=3000)
    _check(rows, offsets)


@pytest.mark.parametrize("name", ["ragged_tail", "window_offset_1", "clamped_to_n"])
def test_warp_emulation_unaligned_rows(name):
    """Rows that do not start on a 16-byte boundary are staged float by float."""
    rows, offsets = segreduce_edge_table(name, device="cpu")
    _check(rows, offsets, aligned=False)


def test_warp_emulation_matches_plain_on_a_scene():
    s = random_scene(600, sh_degree=0, width=128, height=96, seed=5,
                     scale_range=(0.03, 0.25), device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=0)
    layout = inst.build_instances(proj, grid_x=8, grid_y=6,
                                  capacity=inst.required_capacity(600, 3.0), grad_layout=True)
    offsets = layout.seg_offsets
    lengths = offsets[1:] - offsets[:-1]
    # warps whose rows span more than one window
    warp_rows = offsets[32::32] - offsets[:-32:32]
    assert int(lengths.max()) > 1 and int(warp_rows.max()) > WINDOW
    rows = torch.randn((layout.sorted_owner.shape[0], COLS),
                       generator=torch.Generator().manual_seed(0))
    _check(rows, offsets)
