"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
twin at a small size, on the card.

They skip without a card.  On a machine with one (which need not have JAX;
``--noconftest`` keeps the JAX-pinning conftest out):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from gaussian_splatting_torch import _kernels
from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import expand as ex
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import untile as ut
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.ops.rasterize import _render, blend_fields, render
from gaussian_splatting_torch.utils.testing import random_scene

pytestmark = pytest.mark.gpu

W, H = 200, 120  # not tile-aligned: 13 x 8 tiles


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _scene_proj(cuda, sh_degree=3):
    s = random_scene(3000, sh_degree=sh_degree, width=W, height=H, seed=3,
                     scale_range=(0.005, 0.03), device=cuda)
    proj = preprocess(s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam,
                      sh_degree=sh_degree)
    return s, proj


def _grid():
    return (W + 15) // 16, (H + 15) // 16


def test_expand_kernel_matches_plain(cuda):
    _, proj = _scene_proj(cuda)
    gx, gy = _grid()
    table, total = inst.build_table(proj)
    cap = inst.internal_capacity(inst.required_capacity(3000, 2.0))
    before = _kernels.launches["expand"]
    assert int(total) < cap  # every Gaussian expands, terminators follow
    # the scene's own span mapping, then every Gaussian on full-rect mapping
    for tbl in (table, table._replace(span_flag=torch.zeros_like(table.span_flag))):
        keys, owner = ex.expand_instances(tbl, capacity=cap, grid_x=gx,
                                          num_tiles=gx * gy)
        torch.cuda.synchronize()
        keys_p, owner_p = ex.expand_instances_plain(tbl, capacity=cap, grid_x=gx,
                                                    num_tiles=gx * gy)
        assert torch.equal(keys, keys_p)
        assert torch.equal(owner, owner_p)
    assert _kernels.launches["expand"] == before + 2


def test_blend_kernel_matches_plain(cuda):
    _, proj = _scene_proj(cuda)
    gx, gy = _grid()
    layout = inst.build_instances(proj, grid_x=gx, grid_y=gy,
                                  capacity=inst.required_capacity(3000, 2.0))
    fields = blend_fields(proj)
    args = (layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields)
    before = _kernels.launches["blend_forward"]
    out = bl.blend_forward(*args, grid_x=gx)
    torch.cuda.synchronize()
    assert _kernels.launches["blend_forward"] == before + 1
    ref = bl.blend_forward_plain(*args, grid_x=gx)
    torch.testing.assert_close(out[..., :5], ref[..., :5], atol=1e-5, rtol=0)
    assert torch.equal(out[..., bl.O_NB], ref[..., bl.O_NB])
    assert float(out[..., :3].abs().sum()) > 1.0


def test_untile_kernel_matches_plain(cuda):
    gx, gy = _grid()
    g = torch.Generator(device=cuda).manual_seed(0)
    packed = torch.rand((gx * gy, 256, bl.OUT_COLS), generator=g, device=cuda)
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16, width=W, height=H,
              cols=bl.CT_COLS)
    before = _kernels.launches["untile"]
    out = ut.untile(packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["untile"] == before + 1
    assert torch.equal(out, ut.untile_plain(packed, **kw))


@pytest.mark.parametrize("antialiasing", [False, True])
def test_render_kernels_match_plain_path(cuda, antialiasing):
    s, _ = _scene_proj(cuda)
    cfg = RasterizeConfig(antialiasing=antialiasing)
    args = (s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, s.bg)
    fast = render(*args, sh_degree=3, cfg=cfg, inference=True)
    plain = _render(*args, sh_degree=3, cfg=cfg, kernels=False)
    assert not bool(fast.overflow)
    for name in ("image", "invdepth", "final_T"):
        torch.testing.assert_close(getattr(fast, name), getattr(plain, name),
                                   atol=2e-4, rtol=0)
    assert torch.equal(fast.radii, plain.radii)
    assert int(fast.num_instances) == int(plain.num_instances)


def test_kernels_raise_on_wrong_input(cuda):
    gx, gy = _grid()
    packed = torch.zeros((gx * gy, 256, 8), device=cuda)
    with pytest.raises(ValueError):
        ut.untile(packed[:, :, ::2], grid_x=gx, grid_y=gy, tile_w=16, tile_h=16,
                  width=W, height=H, cols=3)
