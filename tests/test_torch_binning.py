"""Port parity: the binning oracle ``ops.binning.bin_gaussians`` bit for bit
against JAX's on the same projection (every output, both layouts, with and
without overflow), and the port's ``build_instances`` per-tile contents
against it, as JAX ``tests/test_instances.py`` holds its pipeline against
its oracle."""

import jax
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.binning import bin_gaussians as jax_bin_gaussians
from gaussian_splatting_tpu.ops.preprocess import preprocess as jax_preprocess
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops.binning import aligned_capacity, bin_gaussians
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians, preprocess
from gaussian_splatting_torch.utils.testing import random_scene

W, H, TILE = 96, 64, 16
GX, GY = W // TILE, H // TILE
CASES = {  # name: (seed, Gaussians, instance capacity, grad_layout)
    "s0_n300": (0, 300, None, True),
    "s3_n300": (3, 300, None, True),
    "s7_n300_inference": (7, 300, None, False),
    "s0_n300_overflow": (0, 300, 256, True),
}


@pytest.fixture(scope="module")
def jax_projections():
    """The three seeds' projections, one compiled preprocess."""
    scenes = {seed: jax_random_scene(300, sh_degree=1, width=W, height=H, seed=seed,
                                     spread=1.6, scale_range=(0.01, 0.12))
              for seed in (0, 3, 7)}
    cam = scenes[0].cam  # random_scene's camera does not depend on the seed
    fn = jax.jit(lambda *a: jax_preprocess(*a, cam, sh_degree=1))
    return {seed: fn(s.means3d, s.scales, s.quats, s.opacities, s.sh)
            for seed, s in scenes.items()}


def _port_proj(jp) -> ProjectedGaussians:
    return ProjectedGaussians(**{
        f: torch.from_numpy(np.array(getattr(jp, f)).astype(
            np.int32 if f in ("span_x0", "span_cum") else np.array(getattr(jp, f)).dtype))
        for f in ProjectedGaussians._fields})


@pytest.mark.parametrize("case", list(CASES))
def test_bin_gaussians_matches_jax_bitwise(jax_projections, case):
    seed, n, capacity, grad_layout = CASES[case]
    capacity = capacity or inst.required_capacity(n, 12.0)
    jp = jax_projections[seed]
    kw = dict(grid_x=GX, grid_y=GY, capacity=capacity, chunk=128, grad_layout=grad_layout)
    ref = jax_bin_gaussians(jp, **kw)
    got = bin_gaussians(_port_proj(jp), **kw)
    assert bool(got.overflow) == (case.endswith("overflow"))
    for field in got._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.gaussian_ids.shape[0] == aligned_capacity(capacity, GX, GY, 128)


@pytest.mark.parametrize("seed,n", [(0, 300), (3, 57), (7, 1000)])
def test_build_instances_matches_the_oracle_per_tile(seed, n):
    s = random_scene(n, sh_degree=1, width=W, height=H, seed=seed, spread=1.6,
                     scale_range=(0.01, 0.12), device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=1)
    capacity = inst.required_capacity(n, 12.0)
    layout = inst.build_instances(*inst.build_table(proj), grid_x=GX, grid_y=GY,
                                  capacity=capacity)
    old = bin_gaussians(proj, grid_x=GX, grid_y=GY, capacity=capacity)
    assert not bool(layout.overflow) and not bool(old.overflow)
    untouched = int((proj.tiles_touched == 0).sum())
    assert int(layout.num_instances) == int(old.num_instances) + untouched  # sentinels
    starts, ends = layout.tile_starts.numpy(), layout.tile_ends.numpy()
    o_starts, o_ends = old.tile_starts.numpy(), old.tile_ends.numpy()
    np.testing.assert_array_equal(ends - starts, o_ends - o_starts)
    owner, ids = layout.sorted_owner.numpy(), old.gaussian_ids.numpy()
    for t in range(GX * GY):
        np.testing.assert_array_equal(owner[starts[t]:ends[t]], ids[o_starts[t]:o_ends[t]],
                                      err_msg=f"tile {t}")
    assert (o_starts % 128 == 0).all() and int((ends - starts).sum()) > n


def test_gradient_layout_maps_segments_to_their_gaussian():
    """``pos_expansion`` sends each Gaussian's expansion segment to aligned
    slots holding that Gaussian."""
    s = random_scene(120, sh_degree=0, width=64, height=48, seed=5, device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=0)
    old = bin_gaussians(proj, grid_x=4, grid_y=3, capacity=inst.required_capacity(120, 12.0))
    ids, pos = old.gaussian_ids.numpy(), old.pos_expansion.numpy()
    for gi, (a, b) in enumerate(zip(old.seg_starts.numpy(), old.seg_ends.numpy())):
        assert (ids[pos[a:b]] == gi).all()
