"""Port parity: the plain twin of K2 against the JAX package's
``blend_forward_pallas`` (interpret mode) on the same sorted layout.

RGB, T and inverse depth agree within 2e-4.  The JAX kernel forms the
transmittance as exp of a prefix sum of logs, the port multiplies
sequentially, so NB (the first stream position where test_T < 1e-4) may
differ where that rounding moves test_T across T_EPS: it must agree on at
least 99.9% of pixels, while the 2e-4 image tolerance holds everywhere."""

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
from gaussian_splatting_torch.ops.rasterize import blend_fields
from gaussian_splatting_torch.utils.testing import random_arrays
from test_torch_instances import jax_diff_fields, to_port_proj

W, H = 64, 48


def test_constants_and_layout_match_jax():
    for name in ("ALPHA_MIN", "ALPHA_CAP", "T_EPS", "POWER_EPS", "NB_BIG", "OUT_COLS",
                 "CT_COLS", "O_R", "O_G", "O_B", "O_T", "O_INVD", "O_NB",
                 "F_X", "F_Y", "F_CA", "F_CB", "F_CC", "F_OP", "F_R", "F_G", "F_B", "F_INVD"):
        assert getattr(bl, name) == getattr(bp, name), name


@pytest.fixture(scope="module")
def blended():
    """One dense scene (many pixels saturate) through both blends."""
    arrs = random_arrays(1200, sh_degree=0, seed=21, spread=1.0, scale_range=(0.05, 0.25))
    R, t = look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    cam = jcm.make_camera(R, t, 0.9, 0.9 * H / W, W, H)
    jp = jax_preprocess(*(jnp.asarray(a) for a in arrs), cam, sh_degree=0)
    gx, gy = -(-W // 16), -(-H // 16)
    capacity = jinst.required_capacity(1200, 8.0)
    jl = jinst.build_instances(jp, jax_diff_fields(jp), grid_x=gx, grid_y=gy, capacity=capacity,
                               tile_w=16, tile_h=16, grad_layout=False, interpret=True)
    jout = np.asarray(bp.blend_forward_pallas(
        jl.meta_sorted, jl.tile_starts, jl.tile_ends, grid_x=gx, grid_y=gy,
        chunk=512, interpret=True,
    ))
    proj = to_port_proj(jp)
    tl = inst.build_instances(*inst.build_table(proj), grid_x=gx, grid_y=gy,
                              capacity=capacity)
    assert not bool(tl.overflow)
    tout = bl.blend_forward(tl.sorted_owner, tl.tile_starts, tl.tile_ends,
                            blend_fields(proj), grid_x=gx).numpy()
    return jout, tout


def test_blend_colour_transmittance_invdepth_match_jax(blended):
    jout, tout = blended
    assert tout.shape == jout.shape == (12, 256, bl.OUT_COLS)
    np.testing.assert_allclose(tout[..., :5], jout[..., :5], atol=2e-4)
    assert float(np.abs(tout[..., :3]).sum()) > 10.0
    np.testing.assert_array_equal(tout[..., 6:], 0.0)


def test_blend_nb_matches_jax(blended):
    jout, tout = blended
    nb_t, nb_j = tout[..., bl.O_NB], jout[..., bl.O_NB]
    done = nb_t < bl.NB_BIG
    assert done.mean() > 0.2  # the scene saturates many pixels
    assert (nb_t == nb_j).mean() >= 0.999


def test_blend_empty_and_saturated_tiles():
    # tile 0 empty; tile 1 saturates on its first instances
    fields = torch.zeros((4, bl.NUM_FIELDS))
    fields[:, bl.F_X] = 24.0
    fields[:, bl.F_Y] = 8.0
    fields[:, bl.F_CA] = 1e-4
    fields[:, bl.F_CC] = 1e-4
    fields[:, bl.F_OP] = 1.0
    fields[:, bl.F_R] = 1.0
    fields[:, bl.F_INVD] = 0.5
    out = bl.blend_forward(
        torch.arange(4, dtype=torch.int32), torch.tensor([0, 0], dtype=torch.int32),
        torch.tensor([0, 4], dtype=torch.int32), fields, grid_x=2,
    )
    assert torch.equal(out[0, :, bl.O_T], torch.ones(256))
    assert torch.equal(out[0, :, bl.O_NB], torch.full((256,), bl.NB_BIG))
    # alpha caps at 0.99: instance 0 leaves T = 0.01, instance 1 would take
    # it below T_EPS, so NB is stream position 1 and T stays 0.01
    assert torch.equal(out[1, :, bl.O_NB], torch.full((256,), 1.0))
    torch.testing.assert_close(out[1, :, bl.O_T], torch.full((256,), 0.01), atol=1e-6, rtol=0)
    torch.testing.assert_close(out[1, :, bl.O_R], torch.full((256,), 0.99), atol=1e-6, rtol=0)
