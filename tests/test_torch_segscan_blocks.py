"""K7's window decomposition, emulated on the CPU.

The kernel (``csrc/segscan.cu``) runs one block of THREADS threads per
window of WINDOW indices.  The block reads the window's flags as one float4
a thread, ranks the starts with a ballot per float4 lane and the warps'
totals, and finds the first start in the TAIL indices past the window.
Then, ROWS rows at a time, it stages each row from its first start to its
last segment's end (float4s from a 16-byte boundary, scalars for the
array's last floats, or float by float when the arrays are not 16-byte
aligned), each thread sums its segments front to back in place and
continues a segment longer than the tail in device memory, and the block
stores the staged range back (float4s inside it, scalars at its ends).
This emulates all of it with the kernel's constants, read from its source,
into NaN-filled shared buffers: every shared read lands on a staged float,
every output index is written exactly once, and the result is bitwise equal
to ``segmented_cumsum_plain`` on the card tests' edge tables
(``utils.testing.segscan_edge_table``) and on a scene's gradient layout."""

import os
import re

import numpy as np
import pytest
import torch

from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import segscan as ss
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.utils.testing import (
    SEGSCAN_EDGE_CASES,
    SEGSCAN_WINDOW,
    random_scene,
    segscan_edge_table,
)

SOURCE = os.path.join(os.path.dirname(ss.__file__), os.pardir, "csrc", "segscan.cu")


def _constant(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


THREADS, WINDOW, TAIL, ROWS = (_constant(k) for k in ("THREADS", "WINDOW", "TAIL", "ROWS"))
STAGE_F4 = (WINDOW + TAIL) // 4 + 1  # the kernel's float4s per staged row


def _ranked_starts(b):
    """The block's start positions as its ballots rank them: thread t holds
    flags 4t..4t+3; its first start's slot is the starts of lower lanes of
    its warp (one ballot per float4 lane) plus the totals of lower warps."""
    b = b.reshape(THREADS // 32, 32, 4)
    below = np.tril(np.ones((32, 32), bool), -1)  # [lane, other]: other < lane
    in_warp = (below[None, :, :, None] & b[:, None, :, :]).sum(axis=(2, 3))
    warp_tot = b.sum(axis=(1, 2))
    rank = in_warp + (np.cumsum(warp_tot) - warp_tot)[:, None]
    slots = np.full(WINDOW, -1)
    for w in range(THREADS // 32):
        for lane in range(32):
            r = rank[w, lane]
            for k in range(4):
                if b[w, lane, k]:
                    slots[r] = 4 * (32 * w + lane) + k
                    r += 1
    return slots[: int(warp_tot.sum())]


def emulate(vals, flags, aligned=True):
    """(rows, n) scan as the kernel forms it, block by block."""
    rows, n = vals.shape
    flat, total = vals.reshape(-1), rows * n
    out = np.full(total, np.nan, np.float32)
    written = np.zeros(total, np.int64)
    for w0 in range(0, n, WINDOW):
        lim = min(WINDOW, n - w0)
        b = np.zeros(WINDOW, bool)
        b[:lim] = flags[w0: w0 + lim] > 0
        if w0 == 0:
            b[0] = True
        starts = _ranked_starts(b)
        assert np.array_equal(starts, np.flatnonzero(b))  # sorted, one slot each
        tail = np.flatnonzero(flags[w0 + WINDOW: min(w0 + WINDOW + TAIL, n)] > 0)
        nxt = int(tail[0]) if len(tail) else TAIL
        if len(starts) == 0:
            continue
        s0, end, past = int(starts[0]), lim, False
        if lim == WINDOW:
            end = WINDOW + nxt if nxt < TAIL else min(WINDOW + TAIL, n - w0)
            past = nxt == TAIL and w0 + WINDOW + TAIL < n
        seg_hi = np.append(starts[1:], end)
        for g0 in range(0, rows, ROWS):
            gr = min(ROWS, rows - g0)
            smem = np.full((gr, 4 * STAGE_F4), np.nan, np.float32)
            lo = (g0 + np.arange(gr)) * n + w0 + s0  # each row's first start
            off = lo & 3 if aligned else np.zeros(gr, np.int64)
            a0, cnt = lo - off, end - s0 + off
            for r in range(gr):
                n_f = 4 * ((cnt[r] + 3) >> 2) if aligned else cnt[r]
                assert n_f <= 4 * STAGE_F4
                f = a0[r] + np.arange(n_f)
                keep = f < total  # no load past the array's end
                smem[r, :n_f][keep] = flat[f[keep]]
            staged = smem.copy()
            rr = np.arange(gr)
            for k in range(len(starts)):
                acc = np.zeros(gr, np.float32)
                for p in range(int(starts[k]), int(seg_hi[k])):
                    idx = off + p - s0
                    assert (idx < cnt).all() and not np.isnan(staged[rr, idx]).any()
                    acc = acc + smem[rr, idx]
                    smem[rr, idx] = acc
                if past and k == len(starts) - 1:
                    q = w0 + end
                    while q < n and not flags[q] > 0:
                        g = (g0 + rr) * n + q
                        acc = acc + flat[g]
                        out[g] = acc
                        written[g] += 1
                        q += 1
            for r in range(gr):
                hi = lo[r] + (end - s0)
                out[lo[r]:hi] = smem[r, off[r]: off[r] + (hi - lo[r])]
                written[lo[r]:hi] += 1
    assert (written == 1).all()  # every output index exactly once
    return out.reshape(rows, n)


def _check(vals, flags, aligned=True):
    got = emulate(vals.numpy(), flags.numpy(), aligned)
    want = ss.segmented_cumsum_plain(vals, flags).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_constants():
    assert (THREADS, WINDOW, TAIL, ROWS) == (128, 512, 64, 10)
    assert WINDOW == SEGSCAN_WINDOW == 4 * THREADS


@pytest.mark.parametrize("rows", [1, 10])
@pytest.mark.parametrize("name", SEGSCAN_EDGE_CASES)
def test_window_emulation_matches_plain_on_edge_tables(name, rows):
    _check(*segscan_edge_table(name, rows, device="cpu"))


@pytest.mark.parametrize("name", ["odd", "crossing_1", "one_segment"])
def test_window_emulation_unaligned_rows(name):
    """Arrays off a 16-byte boundary are staged and stored float by float."""
    _check(*segscan_edge_table(name, 10, device="cpu"), aligned=False)


def test_window_emulation_more_rows_than_staged():
    """Rows past ROWS are staged and scanned in a second group."""
    vals, flags = segscan_edge_table("crossing_2", 13, device="cpu")
    _check(vals, flags)


def test_window_emulation_matches_plain_on_a_scene():
    """The rows chip_smoke.py scans: a view's expansion-order gradient rows,
    field-major, flagged at each Gaussian segment's first slot."""
    s = random_scene(600, sh_degree=0, width=128, height=96, seed=5,
                     scale_range=(0.03, 0.25), device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=0)
    layout = inst.build_instances(*inst.build_table(proj), grid_x=8, grid_y=6,
                                  capacity=inst.required_capacity(600, 3.0),
                                  grad_layout=True)
    offsets = layout.seg_offsets.long()
    lo, hi = int(offsets[0]), int(offsets[-1])
    first, last = offsets[:-1] - lo, offsets[1:] - lo
    flags = torch.zeros(hi - lo)
    flags[first[last > first]] = 1.0
    assert hi - lo > 2 * WINDOW and int((last - first).max()) > 1
    vals = torch.randn((10, hi - lo), generator=torch.Generator().manual_seed(0))
    _check(vals, flags)
