"""Port parity: the plain twins of K3 (untile) and K4 (retile) against the
JAX package's ``untile_pallas`` followed by the render's crop, and against
``_retile_raw`` of the zero-padded image (interpret mode): exact.  Retile is
untile's adjoint, and ``_Untile``'s backward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.untile import _retile_raw, pick_t_per, untile_pallas
from gaussian_splatting_torch.ops import untile as ut


@pytest.mark.parametrize("width,height,cols_in,cols", [(64, 48, 8, 5), (50, 35, 5, 5), (40, 20, 8, 3)])
def test_untile_matches_jax(width, height, cols_in, cols):
    gx, gy = -(-width // 16), -(-height // 16)
    rng = np.random.default_rng(width)
    packed = rng.normal(size=(gx * gy, 256, cols_in)).astype(np.float32)
    jimg = np.asarray(untile_pallas(
        jnp.asarray(packed[:, :, :cols]), gx, gy, 16, 16, pick_t_per(gx, 16), True
    ))[:, :height, :width]
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16, width=width, height=height,
              cols=cols)
    timg = ut.untile(torch.from_numpy(packed), **kw)
    assert timg.shape == (cols, height, width) and timg.is_contiguous()
    np.testing.assert_array_equal(timg.numpy(), jimg)
    np.testing.assert_array_equal(ut.untile_plain(torch.from_numpy(packed), **kw).numpy(), jimg)


def test_untile_padded_is_the_uncropped_layout():
    packed = torch.arange(2 * 256 * 1, dtype=torch.float32).reshape(2, 256, 1)
    img = ut.untile_padded(packed, grid_x=2, grid_y=1, tile_w=16, tile_h=16)
    assert img.shape == (1, 16, 32)
    # pixel (y, x) of tile t is packed[t, y * 16 + x]
    assert float(img[0, 3, 20]) == float(packed[1, 3 * 16 + 4, 0])


@pytest.mark.parametrize("width,height,cols", [(64, 48, 5), (50, 35, 5), (40, 20, 3)])
def test_retile_matches_jax(width, height, cols):
    gx, gy = -(-width // 16), -(-height // 16)
    img = np.random.default_rng(height).normal(size=(cols, height, width)).astype(np.float32)
    padded = np.zeros((cols, gy * 16, gx * 16), np.float32)
    padded[:, :height, :width] = img
    jrec = np.asarray(_retile_raw(jnp.asarray(padded), grid_x=gx, grid_y=gy, tile_w=16,
                                  tile_h=16, t_per=pick_t_per(gx, 16), interpret=True))
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16)
    trec = ut.retile(torch.from_numpy(img), **kw)
    assert trec.shape == (gx * gy, 256, cols) and trec.is_contiguous()
    np.testing.assert_array_equal(trec.numpy(), jrec)
    np.testing.assert_array_equal(ut.retile_plain(torch.from_numpy(img), **kw).numpy(), jrec)


def test_retile_is_the_adjoint_and_backward_of_untile():
    """<untile(x), y> == <x, retile(y)>, and autograd through ``_Untile``
    gives retile of the cotangent."""
    width, height, cols = 50, 35, 5
    gx, gy = 4, 3
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(gx * gy, 256, cols)).astype(np.float64))
    y = torch.from_numpy(rng.normal(size=(cols, height, width)).astype(np.float64))
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16)
    lhs = (ut.untile_plain(x, **kw, width=width, height=height, cols=cols) * y).sum()
    rhs = (x * ut.retile_plain(y, **kw)).sum()
    assert abs(float(lhs - rhs)) < 1e-9 * float(abs(lhs))

    xf = x.float().requires_grad_(True)
    img = ut.untile_differentiable(xf, **kw, width=width, height=height)
    (img * y.float()).sum().backward()
    assert torch.equal(xf.grad, ut.retile(y.float(), **kw))
