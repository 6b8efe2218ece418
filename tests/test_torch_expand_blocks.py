"""K1's block decomposition, emulated on the CPU.

The kernel (``csrc/expand.cu``) runs blocks of NT threads, each taking NV =
NT * VT consecutive items of the merge path of slots and offsets entries
(entry b[j] going before slot i when b[j] <= i).  A first launch finds every
block's ends, one warp each with a 32-way search over the offsets; each
block stages the fields of the Gaussians ``j0 - 1 .. j1 - 1`` its slots can
belong to (the first STAGED_ROWS entries of each span row among them); each
slot binary-searches the staged offsets for its owner and reads span rows
past the staged ones from global memory.  This emulates the partition, the
window and the owner search with the kernel's constants and holds the
result bitwise against ``expand_instances_plain``, on the card tests' edge
tables and a table of ``random_scene``."""

import math
import os
import re

import pytest
import torch

from gaussian_splatting_torch.ops import expand as ex
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.utils.testing import (
    EXPAND_EDGE_CASES,
    expand_edge_table,
    random_scene,
)

SOURCE = os.path.join(os.path.dirname(ex.__file__), os.pardir, "csrc", "expand.cu")


def _constant(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


NT, VT, STAGED_ROWS = _constant("NT"), _constant("VT"), _constant("STAGED_ROWS")
NV = NT * VT


def merge_path(b, M, N, d):
    """The kernel's ``merge_path``: 32 probes per step, one per lane."""
    lo, hi = max(0, d - N), min(d, M)
    while lo < hi:
        s = (hi - lo + 31) >> 5
        probes = [j >= hi or b[j] > d - 1 - j
                  for j in (lo + (lane + 1) * s - 1 for lane in range(32))]
        if not any(probes):
            return hi
        f = probes.index(True)
        lo, hi = lo + f * s, min(lo + (f + 1) * s - 1, hi)
    return lo


def merged_split(b, N, d):
    """Offsets entries among the first d items of the merged sequence."""
    i = j = 0
    for _ in range(d):
        if j < len(b) and (i >= N or b[j] <= i):
            j += 1
        else:
            i += 1
    return j


def emulate(table, *, capacity, grid_x, num_tiles):
    """(keys, owner) as the kernel computes them, block by block."""
    P = table.depth_key.shape[0]
    M = P + 1
    b = table.offsets.tolist()
    keys = torch.empty(capacity, dtype=torch.int64)
    owner = torch.empty(capacity, dtype=torch.int32)
    n_blocks = math.ceil((capacity + M) / NV)
    splits = [merge_path(b, M, capacity, min(k * NV, capacity + M)) for k in range(n_blocks + 1)]
    for k in range(n_blocks):
        d0, d1 = k * NV, min(k * NV + NV, capacity + M)
        j0, j1 = splits[k], splits[k + 1]
        i0, i1 = d0 - j0, d1 - j1
        nw = j1 - j0 + 1
        assert 0 <= i1 - i0 <= NV and nw <= NV + 1
        # staging: the window's Gaussians, placeholders outside [0, P)
        g = torch.arange(j0 - 1, j1)
        inside = (g >= 0) & (g < P)
        gi = g.clamp(0, max(P - 1, 0))
        off = torch.where(g >= 0, table.offsets[g.clamp(min=0)], 0)
        depth = torch.where(inside, table.depth_key[gi] if P else 0.0, ex.BIG)
        live = depth < ex.BIG
        flag = torch.where(live, table.span_flag[gi], 0) if P else torch.zeros_like(g)
        # the slots and their owners: the last staged offset <= slot
        slot = torch.arange(i0, i1, dtype=torch.int32)
        lo = torch.zeros_like(slot)
        hi = torch.full_like(slot, nw - 1)
        while bool((lo < hi).any()):
            mid = (lo + hi + 1) >> 1
            le = off[mid.long()] <= slot
            lo, hi = torch.where(lo < hi, torch.where(le, mid, lo), lo), \
                torch.where(lo < hi, torch.where(le, hi, mid - 1), hi)
        w = lo.long()
        own = (j0 - 1 + lo).to(torch.int32)
        tile = torch.full_like(slot, num_tiles)
        dep = torch.full((slot.numel(),), ex.BIG)
        valid = live[w]
        if bool(valid.any()):
            gv = own[valid].long()
            local = slot[valid] - off[w[valid]]
            cum, x0 = table.span_cum[gv], table.span_x0[gv]
            r = (cum[:, :STAGED_ROWS] <= local[:, None]).sum(dim=1)
            # past the staged rows: read on while the next row starts at or before local
            j = torch.full_like(r, STAGED_ROWS)
            going = r == STAGED_ROWS
            while bool(going.any()):
                going &= j < 16
                step = going & (cum.gather(1, j.clamp(max=15)[:, None])[:, 0] <= local)
                r = r + step
                j = j + 1
                going = step
            base = torch.where(r > 0, cum.gather(1, (r - 1).clamp(min=0)[:, None])[:, 0], 0)
            x0r = torch.where(r < 16, x0.gather(1, r.clamp(max=15)[:, None])[:, 0], 0)
            q = torch.div(local, table.rect_w[gv], rounding_mode="floor")
            is_span = flag[w[valid]] != 0
            tx = torch.where(is_span, x0r + (local - base),
                             table.rect_x0[gv] + (local - q * table.rect_w[gv]))
            ty = table.rect_y0[gv] + torch.where(is_span, r.to(torch.int32), q)
            tile[valid] = (ty * grid_x + tx).to(torch.int32)
            dep[valid] = depth[w[valid]]
        bits = dep.view(torch.int32).long() & 0xFFFFFFFF
        keys[i0:i1] = (tile.long() << 32) | bits
        owner[i0:i1] = own
    return keys, owner


def _check(table, **kw):
    keys, owner = emulate(table, **kw)
    keys_p, owner_p = ex.expand_instances_plain(table, **kw)
    assert torch.equal(owner, owner_p)
    assert torch.equal(keys, keys_p)


def test_constants_and_merge_path():
    """The block sizes read from the kernel's source, and its 32-way search
    against a direct merge of slots and offsets."""
    assert (NT, VT, STAGED_ROWS) == (256, 2, 4)
    g = torch.Generator().manual_seed(0)
    counts = torch.randint(0, 4, (300,), generator=g)
    counts[40:120] = 0
    b = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]).tolist()
    N = b[-1] + 37
    for d in list(range(0, N + len(b) + 1, 7)) + [N + len(b)]:
        assert merge_path(b, len(b), N, d) == merged_split(b, N, d), d


@pytest.mark.parametrize("name", EXPAND_EDGE_CASES)
def test_block_emulation_matches_plain_on_edge_tables(name):
    table, capacity, gx, num_tiles = expand_edge_table(name, device="cpu")
    _check(table, capacity=capacity, grid_x=gx, num_tiles=num_tiles)


def test_block_emulation_matches_plain_on_a_scene():
    s = random_scene(600, sh_degree=0, width=128, height=96, seed=5,
                     scale_range=(0.01, 0.12), device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=0)
    table, total = inst.build_table(proj)
    assert bool((table.span_flag == 1).any()) and bool((table.span_flag == 0).any())
    assert bool((table.depth_key == ex.BIG).any())
    gx, gy = 8, 6
    capacity = inst.internal_capacity(inst.required_capacity(600, 3.0))
    assert int(total) < capacity
    _check(table, capacity=capacity, grid_x=gx, num_tiles=gx * gy)
