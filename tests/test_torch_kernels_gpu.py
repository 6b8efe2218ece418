"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
twin at a small size, on the card, and the render's gradients through the
kernels against the all-twin path.

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
from gaussian_splatting_torch.ops import segreduce as sr
from gaussian_splatting_torch.ops import untile as ut
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.ops.rasterize import _render, blend_fields, expansion_order, render
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


def test_retile_kernel_matches_plain(cuda):
    gx, gy = _grid()
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.randn((bl.CT_COLS, H, W), generator=g, device=cuda)
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16)
    before = _kernels.launches["retile"]
    out = ut.retile(img, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["retile"] == before + 1
    assert torch.equal(out, ut.retile_plain(img, **kw))


def test_blend_backward_kernel_matches_plain_and_leaves_the_tail(cuda):
    """The kernel writes every slot below n_valid (a NaN-poisoned buffer
    keeps NaN only past it, which ``expansion_order``'s select removes) and
    sums in its twin's order."""
    _, proj = _scene_proj(cuda)
    gx, gy = _grid()
    layout = inst.build_instances(proj, grid_x=gx, grid_y=gy,
                                  capacity=inst.required_capacity(3000, 2.0), grad_layout=True)
    fields = blend_fields(proj)
    args = (layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields)
    packed = bl.blend_forward(*args, grid_x=gx)
    g = torch.Generator(device=cuda).manual_seed(2)
    ct = torch.randn((gx * gy, 256, bl.CT_COLS), generator=g, device=cuda)
    out = torch.full((layout.sorted_owner.shape[0], bl.NUM_FIELDS), float("nan"), device=cuda)
    before = _kernels.launches["blend_backward"]
    bl.launch_blend_backward(*args, packed, ct, gx, out)
    torch.cuda.synchronize()
    assert _kernels.launches["blend_backward"] == before + 1
    n = int(layout.n_valid)
    assert not bool(out[:n].isnan().any()) and bool(out[n:].isnan().all())
    ref = bl.blend_backward_plain(*args, packed, ct, grid_x=gx)
    scale = ref[:n].abs().amax(dim=0) + 1e-30
    assert float(((out[:n] - ref[:n]).abs() / scale).max()) <= 1e-6
    assert float(out[:n].abs().sum()) > 1.0
    assert torch.equal(bl.blend_backward(*args, packed, ct, grid_x=gx)[:n], out[:n])
    assert not bool(expansion_order(out, layout).isnan().any())


def test_segment_reduce_kernel_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    lengths = torch.randint(1, 9, (5000,), generator=g, device=cuda)
    lengths[100:200] = 0
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=cuda), lengths.cumsum(0)])
    n = int(offsets[-1])
    rows = torch.randn((n + 300, sr.COLS), generator=g, device=cuda)
    offsets = offsets.clamp(max=n - 50).to(torch.int32)  # a clamped (overflowed) tail
    before = _kernels.launches["segment_reduce"]
    out = sr.segment_reduce_rows(rows, offsets)
    torch.cuda.synchronize()
    assert _kernels.launches["segment_reduce"] == before + 1
    assert torch.equal(out, sr.segment_reduce_rows_plain(rows, offsets))
    assert bool((out[100:200] == 0).all())


def test_render_gradients_kernels_match_plain_path(cuda):
    s, _ = _scene_proj(cuda)
    leaves = [t.clone().requires_grad_(True)
              for t in (s.means3d, s.scales, s.quats, s.opacities, s.sh)]
    tap = torch.zeros((3000, 2), device=cuda, requires_grad=True)

    def grads(kernels):
        out = _render(*leaves, s.cam, s.bg, sh_degree=3, means2d_tap=tap, kernels=kernels)
        loss = out.image.square().sum() + out.invdepth.sum()
        return torch.autograd.grad(loss, leaves + [tap])

    counts = dict(_kernels.launches)
    fast = grads(True)
    torch.cuda.synchronize()
    for name in _kernels.TRAIN_KERNELS:
        assert _kernels.launches[name] == counts[name] + 1, name
    plain = grads(False)
    for a, b in zip(fast, plain):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 3e-4 * scale


def test_segscan_kernel_matches_plain(cuda):
    """K7 against its twin, bitwise (compared as int32 bit patterns, so a
    signed zero counts), with long, short, empty-valued and leading
    segments."""
    from gaussian_splatting_torch.ops import segscan as ss

    g = torch.Generator(device=cuda).manual_seed(4)
    n = 40_000
    vals = torch.randn((10, n), generator=g, device=cuda)
    vals[:, 5000:7000] = 0.0
    vals[:, 9000] = -0.0
    flags = (torch.rand((n,), generator=g, device=cuda) < 0.3).to(torch.float32)
    flags[:50] = 0.0  # a leading run before the first flag
    flags[5000] = flags[7000] = flags[9000] = 1.0
    flags[5001:7000] = 0.0
    flags[20_000:21_500] = 0.0  # one long segment
    before = _kernels.launches["segscan"]
    out = ss.segmented_cumsum(vals, flags)
    torch.cuda.synchronize()
    assert _kernels.launches["segscan"] == before + 1
    ref = ss.segmented_cumsum_plain(vals, flags)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert bool((out[:, 5000:7000].view(torch.int32) == 0).all())
