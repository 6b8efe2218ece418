"""Port parity: the plain twins of K5 (blend backward) and K6 (segment
reduce) against the JAX package's Pallas kernels in interpret mode.

K5: per sorted slot below ``n_valid``, on the same sorted layout (the sort
order of the two packages is bitwise equal, ``test_torch_instances.py``, so
the port's layout is handed to JAX as its sorted records), the same forward
output (so both replay the same contributor set) and the same cotangent;
within 3e-4 of each column's largest magnitude (the JAX kernel forms T by
exp of a prefix sum of logs and sums over pixels on the matrix unit with a
bf16 split, about 2^-17 relative).  K6: exact zeros
where JAX has them, 1e-5 relative elsewhere (JAX's two-pass bf16 split)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import blend_pallas as bp
from gaussian_splatting_tpu.ops.segreduce import segment_reduce_rows as jax_segment_reduce
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import segreduce as sr
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.ops.rasterize import blend_fields
from gaussian_splatting_torch.utils.testing import random_scene

W, H = 64, 48


def test_cotangent_columns_match_jax():
    for name in ("CT_R", "CT_G", "CT_B", "CT_BGDOT", "CT_INVD", "CT_COLS"):
        assert getattr(bl, name) == getattr(bp, name), name


@pytest.fixture(scope="module")
def backward_pair():
    """One scene with saturated pixels through both backwards: the port's
    layout and forward output, handed to JAX as its sorted records."""
    s = random_scene(600, sh_degree=0, width=W, height=H, seed=31,
                     scale_range=(0.03, 0.2), device="cpu")
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, sh_degree=0)
    gx, gy = -(-W // 16), -(-H // 16)
    tl = inst.build_instances(proj, grid_x=gx, grid_y=gy,
                              capacity=inst.required_capacity(600, 8.0), grad_layout=True)
    assert not bool(tl.overflow)
    n = int(tl.n_valid)
    fields = blend_fields(proj)
    packed = bl.blend_forward(tl.sorted_owner, tl.tile_starts, tl.tile_ends, fields, grid_x=gx)
    ct = np.random.default_rng(5).normal(size=(gx * gy, 256, bl.CT_COLS)).astype(np.float32)
    tgrad = bl.blend_backward(tl.sorted_owner, tl.tile_starts, tl.tile_ends, fields, packed,
                              torch.from_numpy(ct), grid_x=gx).numpy()

    cap_int = tl.sorted_owner.shape[0]
    meta = np.zeros((bp.NUM_FIELDS, cap_int), np.float32)
    meta[:10, :n] = fields[tl.sorted_owner[:n].long()].numpy().T
    jgrad = np.asarray(bp.blend_backward_compact_pallas(
        jnp.asarray(meta), jnp.asarray(tl.tile_starts.numpy()), jnp.asarray(tl.tile_ends.numpy()),
        jnp.asarray(packed.numpy()), jnp.asarray(ct), capacity=cap_int, grid_x=gx, grid_y=gy,
        chunk=128, interpret=True,
    ))
    return jgrad, tgrad, n, packed.numpy()


def test_blend_backward_matches_jax(backward_pair):
    jgrad, tgrad, n, packed = backward_pair
    assert (packed[..., bl.O_NB] < bl.NB_BIG).mean() > 0.05  # saturated pixels
    j = jgrad[:10, :n].T
    t = tgrad[:n]
    for col in range(10):
        scale = np.abs(j[:, col]).max() + 1e-8
        np.testing.assert_allclose(t[:, col] / scale, j[:, col] / scale, atol=3e-4,
                                   err_msg=f"field {col}")
    # instances past every pixel's last contributor get exact zeros in both
    assert ((j == 0).all(axis=1) == (t == 0).all(axis=1)).mean() > 0.99
    assert np.abs(t).sum() > 1.0


def test_blend_backward_tail_and_out_buffer():
    """Slots outside every tile range are zero in the twin (the kernel
    leaves them unwritten), in a new (cap, 10) output buffer."""
    fields = torch.zeros((3, bl.NUM_FIELDS))
    fields[:, bl.F_X] = torch.tensor([3.0, 8.0, 20.0])
    fields[:, bl.F_Y] = 5.0
    fields[:, bl.F_CA] = 0.05
    fields[:, bl.F_CC] = 0.05
    fields[:, bl.F_OP] = 0.7
    fields[:, bl.F_R] = 1.0
    fields[:, bl.F_INVD] = 0.5
    owner = torch.tensor([0, 1, 2, 0, 0, 0], dtype=torch.int32)  # 3 valid, 3 tail
    starts = torch.tensor([0, 2], dtype=torch.int32)
    ends = torch.tensor([2, 3], dtype=torch.int32)
    packed = bl.blend_forward(owner, starts, ends, fields, grid_x=2)
    ct = torch.ones((2, 256, bl.CT_COLS))
    out = bl.blend_backward(owner, starts, ends, fields, packed, ct, grid_x=2)
    assert out.shape == (6, bl.NUM_FIELDS) and out.is_contiguous()
    assert not out.isnan().any()
    assert torch.equal(out[3:], torch.zeros(3, bl.NUM_FIELDS))
    assert bool((out[:3, bl.F_R] > 0).all())  # every instance colours pixels


def _stream(rng, P, n_slots):
    """Dense monotone slot -> Gaussian map (every Gaussian owns >= 1 slot,
    the tail belongs to the terminator P), and its port offsets."""
    counts = rng.integers(1, 6, size=P)
    while counts.sum() > n_slots - 1:
        counts[rng.integers(0, P)] = 1
    g = np.repeat(np.arange(P), counts)
    g = np.concatenate([g, np.full(n_slots - g.size, P)]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return g, offsets


def test_segment_reduce_matches_jax():
    P, n_slots = 777, 2048
    rng = np.random.default_rng(P)
    g, offsets = _stream(rng, P, n_slots)
    vals = rng.normal(size=(n_slots, 10)).astype(np.float32)
    vals[np.isin(g, np.arange(10, 40))] = 0.0  # Gaussians with no contribution
    jout = np.asarray(jax_segment_reduce(jnp.asarray(vals.T), jnp.asarray(g), P,
                                         interpret=True))[:10, :P].T
    tout = sr.segment_reduce_rows(torch.from_numpy(vals), torch.from_numpy(offsets)).numpy()
    zero = jout == 0
    assert zero[10:40].all()
    np.testing.assert_array_equal(tout[zero], 0.0)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    # and against a float64 reference
    ref = np.stack([vals[offsets[i]:offsets[i + 1]].sum(axis=0, dtype=np.float64)
                    for i in range(P)]).astype(np.float32)
    np.testing.assert_allclose(tout, ref, rtol=1e-6, atol=1e-6)


def test_segment_reduce_clamped_offsets():
    """Offsets clamped to the row count (an overflowed stream): segments past
    the end are empty and sum to zero."""
    rows = torch.arange(30, dtype=torch.float32).reshape(3, 10)
    offsets = torch.tensor([0, 2, 3, 3, 3], dtype=torch.int32)
    out = sr.segment_reduce_rows(rows, offsets)
    assert torch.equal(out[0], rows[0] + rows[1])
    assert torch.equal(out[1], rows[2])
    assert torch.equal(out[2:], torch.zeros(2, 10))
