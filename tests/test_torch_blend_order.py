"""K5's summation order over a tile's pixels, emulated on the CPU.

The kernel (``csrc/blend_backward.cu``) runs 4 warps of 32 threads per
16x16 tile.  Warp w covers the 8x8 quarter (w % 2, w // 2), lane l the
column l % 8 of two vertically adjacent rows.  Each thread adds its two
pixels' terms; the warp then sums the 10 terms by an xor reduce-scatter: at
lane offsets 16, 8, 4, 2, 1 every lane trades half of the terms it carries
with lane ``l ^ o`` and adds the half it keeps, so 12 shuffles leave the 10
warp sums in 10 lanes; last, the 4 warp sums are added in warp order.  The
plain twin sums with ``ops/blend.py::_pixel_sum``; the two must agree bit for
bit, which is what lets the card compare K5 with its twin to the last bit.
This emulates the kernel, one operation per shuffle level, with its
pixel-to-lane and lane-to-term maps, and holds it against ``_pixel_sum``."""

import numpy as np
import pytest
import torch

from gaussian_splatting_torch.ops.blend import _pixel_sum

NSUM, WARP, WARPS = 10, 32, 4
LEVELS = ((10, 16), (5, 8), (3, 4), (2, 2), (1, 1))  # (terms carried, lane offset)


def term_of(lane: int) -> int:
    """The kernel's ``term_of``: the term whose warp sum the butterfly leaves
    in ``lane`` (stored by the even lane of each pair), or -1."""
    code = (lane >> 1) & 7
    k = code if code < 3 else code - 1 if code in (4, 5) else -1
    return -1 if (lane & 1) or k < 0 else k + 5 * (lane >> 4)


def butterfly(v: torch.Tensor) -> torch.Tensor:
    """The kernel's ``reduce_scatter`` on (..., 32 lanes, 10 slots): each
    lane's slot 0 at the end.  Lanes with bit ``o`` clear keep the low half of
    their slots, lanes with it set the high half; each adds the partner's
    copy of the half it keeps."""
    lanes = torch.arange(WARP)
    for m, o in LEVELS:
        v = v.clone()
        if m == 1:
            v[..., 0] = v[..., 0] + v[..., lanes ^ o, 0]
            continue
        h = (m + 1) // 2
        hi = ((lanes & o) != 0)[:, None]
        lo, up = v[..., :h], torch.zeros_like(v[..., :h])
        up[..., : m - h] = v[..., h:m]
        send = torch.where(hi, lo, up)
        v[..., :h] = torch.where(hi, up, lo) + send[..., lanes ^ o, :]  # __shfl_xor_sync
    return v[..., 0]


def kernel_order_sum(x: torch.Tensor) -> torch.Tensor:
    """(tiles, 10, 256) terms -> (tiles, 10) sums in the kernel's order."""
    tiles = x.shape[0]
    lane = torch.arange(WARP)
    warp = torch.arange(WARPS)[:, None]
    col = 8 * (warp % 2) + lane % 8  # (warp, lane)
    row = 8 * (warp // 2) + 2 * (lane // 8)
    top = x[..., row * 16 + col]  # (tiles, 10, warp, lane)
    bottom = x[..., (row + 1) * 16 + col]
    v = (top + bottom).permute(0, 2, 3, 1)  # (tiles, warp, lane, slot)
    held = butterfly(v)  # (tiles, warp, lane)
    warp_sums = torch.zeros((tiles, WARPS, NSUM), dtype=x.dtype)
    for ln in range(WARP):
        k = term_of(ln)
        if k >= 0:
            warp_sums[:, :, k] = held[:, :, ln]
    acc = warp_sums[:, 0]
    for w in range(1, WARPS):
        acc = acc + warp_sums[:, w]
    return acc


def test_each_term_has_one_holder_and_the_map_follows_the_butterfly():
    """The lane-to-term map is the one the halving gives: track which term
    each lane's slots stand for through the levels."""
    holders = []
    for lane in range(WARP):
        slots, m = list(range(NSUM)), NSUM
        for mm, o in LEVELS:
            assert mm == m
            if m > 1:
                h = (m + 1) // 2
                hi = bool(lane & o)
                slots = [(slots[h + i] if h + i < m else None) if hi else slots[i]
                         for i in range(h)]
                m = h
        if term_of(lane) >= 0:
            assert slots[0] == term_of(lane), lane
            holders.append(term_of(lane))
    assert sorted(holders) == list(range(NSUM))


@pytest.mark.parametrize("density", [1.0, 0.3, 1 / 32])
def test_butterfly_order_is_bitwise_pixel_sum(density):
    """Seeded terms spread over six decades, with the share of contributing
    pixels ``density`` (non-contributing pixels add +0.0, as in the kernel;
    1/32 leaves about two pixels per warp)."""
    rng = np.random.default_rng(int(density * 1000))
    tiles = 48
    mag = np.exp(rng.uniform(-7.0, 7.0, size=(tiles, NSUM, 256)))
    vals = rng.normal(size=(tiles, NSUM, 256)) * mag
    vals[rng.uniform(size=(tiles, 1, 256)).repeat(NSUM, axis=1) >= density] = 0.0
    x = torch.from_numpy(vals.astype(np.float32))
    ours = kernel_order_sum(x)
    ref = _pixel_sum(x)
    assert torch.equal(ours.view(torch.int32), ref.view(torch.int32))
    if density == 1.0:
        # the order matters: a front-to-back sum rounds differently somewhere
        seq = x[..., 0]
        for p in range(1, 256):
            seq = seq + x[..., p]
        assert not torch.equal(seq, ref)
