"""Port parity: expand (plain twin of K1) + stable sort + tile ranges against
the JAX package's ``build_instances(grad_layout=False)`` (Pallas expand in
interpret mode), on the same projected Gaussians.  Over the valid stream,
sorted tile ids, sorted blend fields, tile starts/ends, ``n_valid``,
``num_instances`` and ``overflow`` match exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import blend_pallas as bp
from gaussian_splatting_tpu.ops import camera_math as jcm
from gaussian_splatting_tpu.ops import instances as jinst
from gaussian_splatting_tpu.ops.preprocess import preprocess as jax_preprocess
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops.camera_math import look_at
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians
from gaussian_splatting_torch.ops.rasterize import blend_fields
from gaussian_splatting_torch.utils.testing import random_arrays


def to_port_proj(jp) -> ProjectedGaussians:
    """The JAX projection as port tensors (span tables as int32)."""
    out = {}
    for f in ProjectedGaussians._fields:
        a = np.array(getattr(jp, f))
        if f in ("span_x0", "span_cum"):
            a = a.astype(np.int32)
        out[f] = torch.from_numpy(a)
    return ProjectedGaussians(**out)


def jax_diff_fields(proj):
    """The (10, P) blend records JAX ``render`` hands to build_instances."""
    safe_depth = jnp.where(proj.valid, proj.depths, 1.0)
    return jnp.stack([
        proj.means2d[:, 0], proj.means2d[:, 1], proj.conics[:, 0],
        proj.conics[:, 1], proj.conics[:, 2], proj.opacities,
        proj.colors[:, 0], proj.colors[:, 1], proj.colors[:, 2], 1.0 / safe_depth,
    ])


def _projection(n, width, height, tile, seed, scale_range, big=0):
    arrs = list(random_arrays(n, sh_degree=1, seed=seed, scale_range=scale_range))
    if big:  # large Gaussians along the view axis: rects > 16 tile rows
        s = np.linspace(0.3, 0.8, big)[:, None]
        arrs[0][:big] = s * np.array([0.3, -0.2, -4.0], np.float32)
        arrs[1][:big] = 0.15
    R, t = look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    cam = jcm.make_camera(R, t, 0.9, 0.9 * height / width, width, height)
    return jax_preprocess(*(jnp.asarray(a) for a in arrs), cam, sh_degree=1,
                          tile_w=tile, tile_h=tile)


@pytest.mark.parametrize(
    "case", ["spans_and_rects", "overflow"],
)
def test_layout_matches_jax(case):
    if case == "spans_and_rects":
        width, height, tile = 96, 72, 4
        jp = _projection(300, width, height, tile, seed=4, scale_range=(0.005, 0.03), big=4)
        capacity = jinst.required_capacity(300, 8.0)
    else:  # demand beyond the internal capacity: both drop the same tail
        width, height, tile = 128, 96, 16
        jp = _projection(1500, width, height, tile, seed=5, scale_range=(0.02, 0.1))
        capacity = 512
    gx, gy = -(-width // tile), -(-height // tile)
    num_tiles = gx * gy
    jl = jinst.build_instances(
        jp, jax_diff_fields(jp), grid_x=gx, grid_y=gy, capacity=capacity,
        tile_w=tile, tile_h=tile, grad_layout=False, interpret=True,
    )
    proj = to_port_proj(jp)
    tl = inst.build_instances(proj, grid_x=gx, grid_y=gy, capacity=capacity)

    n = int(jl.n_valid)
    assert int(tl.n_valid) == n
    assert int(tl.num_instances) == int(jl.num_instances)
    assert bool(tl.overflow) == bool(jl.overflow) == (case == "overflow")
    np.testing.assert_array_equal(tl.tile_starts.numpy(), np.asarray(jl.tile_starts))
    np.testing.assert_array_equal(tl.tile_ends.numpy(), np.asarray(jl.tile_ends))
    counts = np.asarray(jl.tile_ends) - np.asarray(jl.tile_starts)
    np.testing.assert_array_equal(
        tl.sorted_tiles()[:n].numpy(), np.repeat(np.arange(num_tiles), counts)
    )
    assert bool((tl.sorted_tiles()[n:] == num_tiles).all())  # the dropped tail
    sorted_fields = blend_fields(proj)[tl.sorted_owner[:n].long()].numpy()
    np.testing.assert_array_equal(sorted_fields, np.asarray(jl.meta_sorted)[:10, :n].T)
    if case == "spans_and_rects":
        assert bool(proj.span_flag.any()) and bool((proj.valid & ~proj.span_flag).any())
        assert int(tl.num_instances) < capacity
    else:
        assert int((proj.tiles_touched.clamp(min=1)).sum()) > inst.internal_capacity(capacity)


def test_compact_boundary_seam_matches_jax():
    """Two tiles whose ranges meet inside one 128-slot window of the JAX
    layout (tile 0 owns [0, 200), tile 1 [200, 360)): the port's blend over
    the same records equals JAX's, and tile 1 equals tile 1 rendered alone
    (the same scenario as tests/test_rasterize.py's seam test)."""
    rng = np.random.default_rng(11)
    n0, n1 = 200, 160
    n = n0 + n1
    meta = np.zeros((bp.NUM_FIELDS, 512 + 256), np.float32)
    for lo, hi, cx, cy in ((0, n0, 8.0, 8.0), (n0, n, 24.0, 8.0)):
        k = hi - lo
        meta[bp.F_X, lo:hi] = cx + rng.uniform(-4, 4, k)
        meta[bp.F_Y, lo:hi] = cy + rng.uniform(-4, 4, k)
        meta[bp.F_CA, lo:hi] = rng.uniform(0.02, 0.1, k)
        meta[bp.F_CC, lo:hi] = rng.uniform(0.02, 0.1, k)
        meta[bp.F_OP, lo:hi] = rng.uniform(0.1, 0.6, k)
        meta[bp.F_R, lo:hi] = rng.uniform(0, 1, k)
        meta[bp.F_G, lo:hi] = rng.uniform(0, 1, k)
        meta[bp.F_B, lo:hi] = rng.uniform(0, 1, k)
        meta[bp.F_INVD, lo:hi] = rng.uniform(0.2, 2.0, k)
    starts = np.array([0, n0], np.int32)
    ends = np.array([n0, n], np.int32)
    jfwd = np.asarray(bp.blend_forward_pallas(
        jnp.asarray(meta), jnp.asarray(starts), jnp.asarray(ends),
        grid_x=2, grid_y=1, interpret=True,
    ))

    fields = torch.from_numpy(np.ascontiguousarray(meta[:10].T))
    owner = torch.arange(meta.shape[1], dtype=torch.int32)
    tfwd = bl.blend_forward_plain(owner, torch.from_numpy(starts), torch.from_numpy(ends),
                                  fields, grid_x=2)
    np.testing.assert_allclose(tfwd[..., :5].numpy(), jfwd[..., :5], atol=2e-4)
    alone = bl.blend_forward_plain(  # tile 1's records alone, from position 0
        owner[n0:n].contiguous(), torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([0, n1], dtype=torch.int32), fields, grid_x=2,
    )
    np.testing.assert_array_equal(alone[1, :, :5].numpy(), tfwd[1, :, :5].numpy())
    # NB positions are absolute: shifted by tile 1's start in the shared layout
    nb, nb_alone = tfwd[1, :, bl.O_NB], alone[1, :, bl.O_NB]
    done = nb < bl.NB_BIG
    assert torch.equal(done, nb_alone < bl.NB_BIG)
    assert torch.equal(nb[done], nb_alone[done] + n0)
