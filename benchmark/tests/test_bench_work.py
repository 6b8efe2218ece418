"""Work counts on a hand-sized case: five flat Gaussians stacked over one
16x16 tile, each of alpha 0.95, so every pixel saturates at the fourth."""

import math

import pytest
import torch

from benchmark import work
from benchmark.reference import render as rr


def stacked_tile(n=5, opacity=0.95):
    fields = torch.zeros(n, 10)
    fields[:, 0:2] = 7.5
    fields[:, 2] = fields[:, 4] = 1e-8  # a nearly flat footprint
    fields[:, 5] = opacity
    fields[:, 6:9] = torch.rand(n, 3, generator=torch.Generator().manual_seed(0))
    fields[:, 9] = 1.0 / torch.arange(1, n + 1)
    bins = rr.Bins(owner=torch.arange(n), starts=torch.zeros(1, dtype=torch.long),
                   counts=torch.tensor([n]), demand=n)
    return fields, bins


def test_blend_work_by_hand():
    fields, bins = stacked_tile()
    color, trans, invd, w = rr.blend(fields, bins, 16, 16, count_work=True)
    # T: 0.05, 0.0025, 1.25e-4; the fourth would take it under 1e-4
    assert w == rr.Work(visited=4 * 256, replayed=3 * 256, contributing=3 * 256, saturated=256,
                        read_fwd=4, read_bwd=3, tiles=1)
    assert torch.allclose(trans, torch.full((16, 16), 0.05 ** 3), rtol=1e-4)
    weights = torch.tensor([0.95, 0.05 * 0.95, 0.0025 * 0.95])
    assert torch.allclose(color[:, 0, 0], (weights[:, None] * fields[:3, 6:9]).sum(0), rtol=1e-4)


def test_operation_and_byte_counts():
    _, bins = stacked_tile()
    w = rr.Work(visited=1024, replayed=768, contributing=768, saturated=256, read_fwd=4,
                read_bwd=3, tiles=1)._asdict()
    assert work.k2(w) == (16 * 1024 + 3 * (768 + 256) + 9 * 768, 4 * 44 + 256 * 8 * 4 + 8)
    assert work.k5(w) == (17 * 768 + 37 * 768, 3 * 84 + 256 * 13 * 4 + 8)
    ops, nbytes = work.k2(w)
    assert work.roofline_s(ops, nbytes) == max(ops / 67e12, nbytes / 3.35e12)


@pytest.mark.parametrize("capacity,pixels,instances", [(1000, 64 * 48, 3000), (10, 16 * 16, 5)])
def test_step_least_time_sums_its_stages(capacity, pixels, instances):
    w = dict(visited=1024, replayed=768, contributing=768, saturated=256, read_fwd=4,
             read_bwd=3, tiles=1, instances=instances)
    stages = [work.preprocess_bytes(capacity, True) / 3.35e12, 36 * instances / 3.35e12,
              work.roofline_s(*work.k2(w)), work.roofline_s(*work.k5(w)),
              work.roofline_s(*work.loss_work(pixels)), capacity * 59 * 28 / 3.35e12]
    assert math.isclose(work.train_step_s(w, capacity, pixels), sum(stages), rel_tol=1e-12)
    view = [capacity * 73 * 4 / 3.35e12, 36 * instances / 3.35e12, work.roofline_s(*work.k2(w))]
    assert math.isclose(work.view_s(w, capacity), sum(view), rel_tol=1e-12)
