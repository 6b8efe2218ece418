"""Port parity: the plain twin of K3 against the JAX package's
``untile_pallas`` (interpret mode) followed by the render's crop: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.untile import pick_t_per, untile_pallas
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
