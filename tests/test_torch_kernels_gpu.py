"""Card-only tests: each hand-written CUDA kernel against its plain PyTorch
twin at a small size, on the card, and the render's gradients through the
kernels against the all-twin path; then the evaluation suite's LPIPS and
analytic shader on the card against the CPU.

They skip without a card.  On a machine with one (which need not have JAX;
``--noconftest`` keeps the JAX-pinning conftest out):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import _kernels
from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.models.gaussians import GaussianModel
from gaussian_splatting_torch.ops import blend as bl
from gaussian_splatting_torch.ops import expand as ex
from gaussian_splatting_torch.ops import instances as inst
from gaussian_splatting_torch.ops import project as pj
from gaussian_splatting_torch.ops import segreduce as sr
from gaussian_splatting_torch.ops import untile as ut
from gaussian_splatting_torch.ops.camera_math import look_at, make_camera
from gaussian_splatting_torch.ops.lpips import make_lpips
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.ops.rasterize import _render, blend_fields, expansion_order, render
from gaussian_splatting_torch.render import render_camera
from gaussian_splatting_torch.utils.synthetic_dataset import _analytic_scene, shade_analytic
from gaussian_splatting_torch.utils.testing import (
    EXPAND_EDGE_CASES,
    SEGREDUCE_EDGE_CASES,
    SEGSCAN_EDGE_CASES,
    analytic_test_rays,
    expand_edge_table,
    random_lpips_weights,
    random_scene,
    random_stored,
    segreduce_edge_table,
    segscan_edge_table,
)

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
    layout = inst.build_instances(*inst.build_table(proj), grid_x=gx, grid_y=gy,
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


@pytest.mark.parametrize("sh_degree", [3, 4])
@pytest.mark.parametrize("antialiasing", [False, True])
def test_render_kernels_match_plain_path(cuda, antialiasing, sh_degree):
    s, _ = _scene_proj(cuda, sh_degree)
    cfg = RasterizeConfig(antialiasing=antialiasing)
    args = (s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, s.bg)
    fast = render(*args, sh_degree=sh_degree, cfg=cfg, inference=True)
    plain = _render(*args, sh_degree=sh_degree, cfg=cfg, kernels=False)
    assert not bool(fast.overflow)
    for name in ("image", "invdepth", "final_T"):
        torch.testing.assert_close(getattr(fast, name), getattr(plain, name),
                                   atol=2e-4, rtol=0)
    assert torch.equal(fast.radii, plain.radii)
    assert int(fast.num_instances) == int(plain.num_instances)


# K8's cases: (Gaussians, stored SH degree, active degree, antialiasing,
# scale modifier, image size).  Every case has dead slots, Gaussians behind
# the near plane and at the frame's edges (``random_stored``); P is no
# multiple of the kernel's 128-thread block but in "one_block".
PROJECT_CASES = {
    "degree0": (3001, 0, 0, False, 1.0, (200, 120)),
    "degree1_aa": (3001, 1, 1, True, 1.0, (200, 120)),
    "degree2_modifier": (3001, 2, 2, False, 0.6, (200, 120)),
    "degree3_active1_aa": (3001, 3, 1, True, 1.0, (200, 120)),
    "degree3_tall_rects": (4001, 3, 3, False, 2.5, (640, 400)),
    "degree3_tall_rects_aa_1080p": (5003, 3, 3, True, 1.0, (1920, 1080)),
    "degree4_aa_modifier": (3001, 4, 4, True, 1.3, (97, 61)),
    "degree4_active3": (3001, 4, 3, False, 1.0, (200, 120)),
    "one_block": (128, 3, 3, False, 1.0, (200, 120)),
    "one_gaussian": (1, 3, 3, True, 1.0, (200, 120)),
}


def _bits(t):
    """Bit pattern of a float32 or int32 tensor, so that NaNs and signed
    zeros compare too."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("case", sorted(PROJECT_CASES))
def test_project_kernel_matches_plain_bitwise(cuda, case):
    P, degree, active, aa, modifier, (width, height) = PROJECT_CASES[case]
    g = random_stored(P, max_sh_degree=degree, sh_degree=active, seed=P + degree, device=cuda)
    R, t = look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    cam = make_camera(R, t, 0.9, 0.9 * height / width, width, height, device=cuda)
    kw = dict(sh_degree=degree, scale_modifier=modifier, antialiasing=aa)
    before = _kernels.launches["project"]
    out = pj.project_table(g, cam, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["project"] == before + 1
    ref = pj.project_table_plain(g, cam, **kw)
    assert torch.equal(_bits(out.fields), _bits(ref.fields))
    assert torch.equal(out.radii, ref.radii)
    for name, col in out.table._asdict().items():
        assert torch.equal(_bits(col), _bits(getattr(ref.table, name))), name
    assert int(out.total) == int(ref.total)
    if "tall_rects" in case:  # visible Gaussians on the full-rect mapping
        assert bool(((out.table.span_flag == 0) & (out.radii > 0)).any())


def test_render_camera_fused_matches_plain_path_at_1080p(cuda):
    """``render_camera`` through K8 against the render of the activated
    tensors (the plain stage, then K1-K3): image, radii and slot demand
    bitwise."""
    g = random_stored(20000, max_sh_degree=3, sh_degree=3, seed=11, device=cuda)
    model = GaussianModel(g.means3d, g.features_dc, g.features_rest, g.opacities, g.scales,
                          g.quats, g.alive, max_sh_degree=3, sh_degree=3)
    R, t = look_at([0.3, -0.2, -4.0], [0.0, 0.0, 0.0])
    camera = SimpleNamespace(cam=make_camera(R, t, 0.9, 0.9 * 1080 / 1920, 1920, 1080,
                                             device=cuda))
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    # the scene asks ~300 slots a Gaussian: one overflow retry, one K8 launch
    # per attempt
    raster = RasterizeConfig(instance_slack=256.0)
    before = _kernels.launches["project"]
    image, out, retries = render_camera(model, camera, raster, bg)
    torch.cuda.synchronize()
    assert retries == 1 and _kernels.launches["project"] == before + 2
    plain = render(*model.activated_params(), camera.cam, bg, sh_degree=3,
                   cfg=RasterizeConfig(instance_slack=512.0), inference=True)
    assert _kernels.launches["project"] == before + 2
    assert torch.equal(image, plain.image)
    assert torch.equal(out.radii, plain.radii)
    assert int(out.num_instances) == int(plain.num_instances)
    assert float(image.std()) > 0.01


# K3's edges: images whose sides are not multiples of 16, records wider than
# the columns taken (the paths' 5 of 8), as wide (5 of 5), one column, one
# tile.  (width, height, floats per record, columns taken)
UNTILE_CASES = {
    "1000x563_row8_cols5": (1000, 563, 8, 5),
    "1000x563_row5_cols5": (1000, 563, 5, 5),
    "1000x563_row8_cols1": (1000, 563, 8, 1),
    "17x9_row8_cols5": (17, 9, 8, 5),
    "17x9_row5_cols5": (17, 9, 5, 5),
    "17x9_row8_cols1": (17, 9, 8, 1),
    "one_tile_16x16": (16, 16, 8, 5),
    "one_tile_11x7": (11, 7, 5, 3),
}


@pytest.mark.parametrize("case", sorted(UNTILE_CASES))
def test_untile_kernel_edges_match_plain(cuda, case):
    width, height, row, cols = UNTILE_CASES[case]
    gx, gy = -(-width // 16), -(-height // 16)
    g = torch.Generator(device=cuda).manual_seed(width * height + row)
    packed = torch.randn((gx * gy, 256, row), generator=g, device=cuda)[:, :, : max(cols, 1)]
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16, width=width, height=height,
              cols=cols)
    before = _kernels.launches["untile"]
    out = ut.untile(packed, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["untile"] == before + 1
    assert out.shape == (cols, height, width)
    assert torch.equal(out, ut.untile_plain(packed, **kw))


@pytest.mark.parametrize("name", EXPAND_EDGE_CASES)
def test_expand_kernel_edges_match_plain(cuda, name):
    """K1's block decomposition at its edges (the tables of
    ``utils.testing.expand_edge_table``, emulated on the CPU by
    tests/test_torch_expand_blocks.py): a Gaussian over several blocks, a
    run of sentinels longer than a block, zero-count offsets entries, P of 0
    and 1, demand equal to the capacity, a capacity off the block size, and
    spans longer than the staged rows."""
    table, capacity, gx, num_tiles = expand_edge_table(name, device=cuda)
    kw = dict(capacity=capacity, grid_x=gx, num_tiles=num_tiles)
    before = _kernels.launches["expand"]
    keys, owner = ex.expand_instances(table, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["expand"] == before + 1
    keys_p, owner_p = ex.expand_instances_plain(table, **kw)
    assert torch.equal(owner, owner_p)
    assert torch.equal(keys, keys_p)


def test_kernels_raise_on_wrong_input(cuda):
    gx, gy = _grid()
    packed = torch.zeros((gx * gy, 256, 8), device=cuda)
    with pytest.raises(ValueError):
        ut.untile(packed[:, :, ::2], grid_x=gx, grid_y=gy, tile_w=16, tile_h=16,
                  width=W, height=H, cols=3)
    # K1 loads the first 16 bytes of each span row at once
    table, capacity, egx, num_tiles = expand_edge_table("ragged_capacity", device=cuda)
    P = table.depth_key.shape[0]
    shifted = torch.zeros(P * 16 + 1, dtype=torch.int32, device=cuda)[1:].view(P, 16)
    shifted.copy_(table.span_cum)
    with pytest.raises(ValueError):
        ex.expand_instances(table._replace(span_cum=shifted), capacity=capacity, grid_x=egx,
                            num_tiles=num_tiles)


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


RETILE_SIZES = {"17x9": (17, 9), "1000x563": (1000, 563), "1920x1080": (1920, 1080)}


@pytest.mark.parametrize("cols", [1, 5, 8])
@pytest.mark.parametrize("size", sorted(RETILE_SIZES))
def test_retile_kernel_edges_match_plain(cuda, size, cols):
    """K4's one thread per record at odd image sizes (padding in both
    directions) and record widths other than the path's 5."""
    width, height = RETILE_SIZES[size]
    gx, gy = -(-width // 16), -(-height // 16)
    g = torch.Generator(device=cuda).manual_seed(width + cols)
    img = torch.randn((cols, height, width), generator=g, device=cuda)
    kw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16)
    before = _kernels.launches["retile"]
    out = ut.retile(img, **kw)
    torch.cuda.synchronize()
    assert _kernels.launches["retile"] == before + 1
    assert out.shape == (gx * gy, 256, cols)
    assert torch.equal(out, ut.retile_plain(img, **kw))


def test_retile_kernel_wide_records(cuda):
    """Records too wide for a pair of tiles in 48 KB of shared memory
    (30 floats) are stored straight from registers."""
    g = torch.Generator(device=cuda).manual_seed(30)
    img = torch.randn((30, 9, 17), generator=g, device=cuda)
    kw = dict(grid_x=2, grid_y=1, tile_w=16, tile_h=16)
    assert torch.equal(ut.retile(img, **kw), ut.retile_plain(img, **kw))


def _segment_totals_by_segscan(rows, offsets):
    """K7 over the segments' rows, flagged at each non-empty segment's first
    row: (its value at each non-empty segment's last row, which segments)."""
    from gaussian_splatting_torch.ops import segscan as ss

    lo, hi = int(offsets[0]), int(offsets[-1])
    first, last = offsets[:-1].long() - lo, offsets[1:].long() - lo
    nonempty = last > first
    flags = torch.zeros(hi - lo, device=rows.device)
    flags[first[nonempty]] = 1.0
    scan = ss.segmented_cumsum(rows[lo:hi].t().contiguous(), flags)
    return scan[:, last[nonempty] - 1].t(), nonempty


@pytest.mark.parametrize("name", SEGREDUCE_EDGE_CASES)
def test_segment_reduce_kernel_edges_match_plain_and_segscan(cuda, name):
    """K6's warp decomposition at its edges (the tables of
    ``utils.testing.segreduce_edge_table``, emulated on the CPU by
    tests/test_torch_segreduce_warps.py), bitwise against its twin and
    against K7's totals: every segment empty, one segment of 100k rows,
    offsets clamped to N, P of 0, runs of empty segments longer than a
    warp's 32, N odd, and a segment crossing the staging windows at each
    offset of the staging width."""
    rows, offsets = segreduce_edge_table(name, device=cuda)
    before = _kernels.launches["segment_reduce"]
    out = sr.segment_reduce_rows(rows, offsets)
    torch.cuda.synchronize()
    assert _kernels.launches["segment_reduce"] == before + 1
    assert out.shape == (offsets.shape[0] - 1, sr.COLS)
    want = sr.segment_reduce_rows_plain(rows, offsets)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    if int(offsets[-1]) > int(offsets[0]):
        totals, nonempty = _segment_totals_by_segscan(rows, offsets)
        assert torch.equal(totals.view(torch.int32), out[nonempty].view(torch.int32))


def test_segment_reduce_kernel_unaligned_rows(cuda):
    """Rows that do not start on a 16-byte boundary (a view one row in)
    are staged float by float."""
    rows, offsets = segreduce_edge_table("window_offset_1", device=cuda)
    base = torch.zeros((rows.shape[0] + 1, sr.COLS), device=cuda)
    base[1:] = rows
    view = base[1:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(sr.segment_reduce_rows(view, offsets),
                       sr.segment_reduce_rows_plain(rows, offsets))


def test_blend_backward_kernel_matches_plain_and_leaves_the_tail(cuda):
    """The kernel writes every slot below n_valid (a NaN-poisoned buffer
    keeps NaN only past it, which ``expansion_order``'s select removes) and
    sums in its twin's order."""
    _, proj = _scene_proj(cuda)
    gx, gy = _grid()
    layout = inst.build_instances(*inst.build_table(proj), grid_x=gx, grid_y=gy,
                                  capacity=inst.required_capacity(3000, 2.0),
                                  grad_layout=True)
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


def test_train_step_sparse_adam_exposure_kernels_match_plain_path(cuda, monkeypatch):
    """One training step under sparse Adam with a non-identity exposure,
    through the kernels and through their twins (``_render(kernels=False)``
    in the step's place): the same visible rows, Adam moments within 3e-4
    of each leaf's largest, the exposure's gradient finite and nonzero, and
    the moments of rows with ``radii == 0`` unmoved."""
    import functools

    from gaussian_splatting_torch.config import OptimizationConfig
    from gaussian_splatting_torch.models.gaussians import GaussianModel
    from gaussian_splatting_torch.train import step as tstep
    from gaussian_splatting_torch.utils.testing import random_arrays

    means, scales, quats, opac, sh = (torch.from_numpy(a).to(cuda) for a in random_arrays(
        3000, sh_degree=3, seed=3, scale_range=(0.005, 0.03)))
    means[:300] += 40.0  # off screen: radii 0
    g = torch.Generator(device=cuda).manual_seed(2)
    gt = torch.rand((3, H, W), generator=g, device=cuda)
    batch = tstep.StepBatch(gt, torch.ones((1, H, W), device=cuda),
                            torch.zeros((H, W), device=cuda), torch.zeros((H, W), device=cuda),
                            torch.tensor(1, device=cuda), torch.zeros(3, device=cuda))
    cam = random_scene(4, width=W, height=H, seed=3, device=cuda).cam
    opt = OptimizationConfig(optimizer_type="sparse_adam")
    exposure_shift = 0.05 * torch.randn((3, 4), generator=g, device=cuda)

    def run(kernels):
        model = GaussianModel(means.clone(), sh[:, :1].clone(), sh[:, 1:].clone(),
                              torch.log(opac / (1 - opac)), torch.log(scales), quats.clone(),
                              torch.ones(3000, dtype=torch.bool, device=cuda),
                              max_sh_degree=3, sh_degree=3)
        state = tstep.init_train_state(model, num_images=2)
        state.exposures[1] += exposure_shift
        before = {k: v.clone() for k, v in state.tensors().items()}
        if not kernels:
            monkeypatch.setattr(tstep, "render", functools.partial(_render, kernels=False))
        state, m = tstep.train_step(state, cam, batch, opt=opt, raster=RasterizeConfig(),
                                    use_exposure=True)
        monkeypatch.undo()
        return state, m, before

    counts = dict(_kernels.launches)
    fast, m_fast, before = run(True)
    torch.cuda.synchronize()
    for name in _kernels.TRAIN_KERNELS:
        assert _kernels.launches[name] > counts[name], name
    plain, m_plain, _ = run(False)
    assert not bool(m_fast["overflow"]) and not bool(m_plain["overflow"])
    assert abs(float(m_fast["loss"]) - float(m_plain["loss"])) <= 1e-6
    assert torch.equal(fast.model.max_radii2d, plain.model.max_radii2d)
    hidden = fast.model.max_radii2d == 0
    assert 300 <= int(hidden.sum()) < 3000
    for k, v in fast.tensors().items():
        if k.startswith("adam.") and v.dim() > 0:
            ref = plain.tensors()[k]
            assert float((v - ref).abs().max()) <= 3e-4 * (float(ref.abs().max()) + 1e-30), k
            assert torch.equal(v[hidden], before[k][hidden]), k
    g_exp = fast.exp_adam.mu["exposures"][1] / 0.1
    assert bool(torch.isfinite(g_exp).all()) and float(g_exp.abs().max()) > 0
    ref = plain.exp_adam.mu["exposures"]
    assert float((fast.exp_adam.mu["exposures"] - ref).abs().max()) <= 3e-4 * float(
        ref.abs().max())


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


@pytest.mark.parametrize("rows", [1, 10, 13])
@pytest.mark.parametrize("name", SEGSCAN_EDGE_CASES)
def test_segscan_kernel_edges_match_plain_and_segment_reduce(cuda, name, rows):
    """K7's windows at their edges (the tables of
    ``utils.testing.segscan_edge_table``, emulated on the CPU by
    tests/test_torch_segscan_blocks.py), bitwise against its twin and, with
    10 rows, at each segment's last index against K6's sums of the same
    segments: n of 0, 1 and odd, every index a start, one segment over all
    of n, zero segments, and segments crossing window boundaries into the
    staged tail and past it at each row alignment; 13 rows take two groups."""
    from gaussian_splatting_torch.ops import segscan as ss

    vals, flags = segscan_edge_table(name, rows, device=cuda)
    n = vals.shape[1]
    before = _kernels.launches["segscan"]
    out = ss.segmented_cumsum(vals, flags)
    torch.cuda.synchronize()
    assert _kernels.launches["segscan"] == before + (n > 0)
    want = ss.segmented_cumsum_plain(vals, flags)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    if rows == sr.COLS and n > 0:
        is_start = flags > 0
        is_start[0] = True
        starts = torch.nonzero(is_start).flatten()
        offsets = torch.cat([starts, starts.new_full((1,), n)]).to(torch.int32)
        seg = sr.segment_reduce_rows(vals.t().contiguous(), offsets)
        totals = out[:, offsets[1:].long() - 1].t()
        assert torch.equal(totals.contiguous().view(torch.int32), seg.view(torch.int32))


@pytest.mark.parametrize("name", ["odd", "crossing_1", "one_segment"])
def test_segscan_kernel_unaligned_rows(cuda, name):
    """Values, flags and output that do not start on a 16-byte boundary
    (views one float in) are staged, read and stored float by float."""
    from gaussian_splatting_torch.ops import segscan as ss

    vals, flags = segscan_edge_table(name, 10, device=cuda)
    base_v = torch.zeros(vals.numel() + 1, device=cuda)
    base_v[1:] = vals.reshape(-1)
    base_f = torch.zeros(flags.numel() + 1, device=cuda)
    base_f[1:] = flags
    v, f = base_v[1:].view(vals.shape), base_f[1:]
    out = ss.segmented_cumsum(v, f)
    torch.cuda.synchronize()
    want = ss.segmented_cumsum_plain(vals, flags)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# Edge cases of K2's and K5's staging: batches of 256 (K2) and 128 (K5)
# instances, double-buffered, with the owner index loaded a batch ahead, and
# K5's warps of 64 pixels (8x8 quarters, two pixels per thread) that skip
# the instances past their pixels' largest NB.
# Each case is a row of 16x16 tiles with hand-placed Gaussians; both kernels
# are held against their twins, K5 into a NaN-poisoned buffer with a tail
# past n_valid.


def _wide(rng, tile_x, n, opacity):
    """n Gaussians that cover tile ``tile_x`` (tiny conics), with seeded
    centres, opacities drawn from ``opacity`` = (lo, hi) and colours."""
    f = np.zeros((n, bl.NUM_FIELDS), np.float32)
    f[:, bl.F_X] = 16 * tile_x + rng.uniform(2, 14, n)
    f[:, bl.F_Y] = rng.uniform(2, 14, n)
    f[:, bl.F_CA] = rng.uniform(1e-3, 2e-2, n)
    f[:, bl.F_CB] = rng.uniform(-1e-3, 1e-3, n)
    f[:, bl.F_CC] = rng.uniform(1e-3, 2e-2, n)
    f[:, bl.F_OP] = rng.uniform(*opacity, n)
    f[:, bl.F_R : bl.F_INVD + 1] = rng.uniform(0, 1, (n, 4))
    return f


def _capped(tile_x, n):
    """n Gaussians whose alpha caps at 0.99 on every pixel of the tile."""
    f = np.zeros((n, bl.NUM_FIELDS), np.float32)
    f[:, bl.F_X] = 16 * tile_x + 8
    f[:, bl.F_Y] = 8
    f[:, bl.F_CA] = f[:, bl.F_CC] = 1e-5
    f[:, bl.F_OP] = 1.0
    f[:, bl.F_R : bl.F_INVD + 1] = 0.5
    return f


def _spots(rng, tile_x, n):
    """n Gaussians, each eligible on one pixel only (conic 50 around an
    integer pixel centre): every warp-step has at most one contributing
    lane."""
    f = np.zeros((n, bl.NUM_FIELDS), np.float32)
    f[:, bl.F_X] = 16 * tile_x + rng.integers(0, 16, n)
    f[:, bl.F_Y] = rng.integers(0, 16, n)
    f[:, bl.F_CA] = f[:, bl.F_CC] = 50.0
    f[:, bl.F_OP] = rng.uniform(0.05, 0.6, n)
    f[:, bl.F_R : bl.F_INVD + 1] = rng.uniform(0, 1, (n, 4))
    return f


def _edge_case(name):
    """Per-tile field blocks of one row of tiles, in stream order."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "tile_longer_than_two_batches":
        return [_wide(rng, 0, 700, (0.004, 0.01)), _wide(rng, 1, 530, (0.004, 0.05))]
    if name == "nb_on_batch_edges":
        # capped pairs at p - 1, p put NB at p: on the first and the last
        # instance of K2's and K5's batches, and elsewhere
        tiles = []
        for x, p in enumerate((1, 63, 64, 127, 128, 255, 256, 511, 512)):
            f = _wide(rng, x, 600, (0.004, 0.01))
            f[p - 1 : p + 1] = _capped(x, 2)
            tiles.append(f)
        return tiles
    if name == "nb_differs_by_quarter":
        # eight opaque Gaussians of radius ~2 px at positions p - 7 .. p
        # saturate a few pixels at the centre of one 8x8 quarter: two
        # quarters at different positions, so K5's warps skip from
        # different instances, and the other two never saturate
        f = _wide(rng, 0, 300, (0.004, 0.01))
        for (cx, cy), p in (((4, 4), 41), ((12, 12), 201)):
            spot = _capped(0, 8)
            spot[:, bl.F_X], spot[:, bl.F_Y] = cx, cy
            spot[:, bl.F_CA] = spot[:, bl.F_CC] = 0.3
            f[p - 7 : p + 1] = spot
        return [f]
    if name == "empty_next_to_full":
        return [np.zeros((0, bl.NUM_FIELDS), np.float32), _wide(rng, 1, 300, (0.2, 0.9)),
                np.zeros((0, bl.NUM_FIELDS), np.float32), _wide(rng, 3, 300, (0.2, 0.9)),
                np.zeros((0, bl.NUM_FIELDS), np.float32)]
    if name == "all_alpha_capped":
        return [_capped(0, 70), _capped(1, 1)]
    if name == "one_lane_contributes":
        return [_spots(rng, 0, 300), _spots(rng, 1, 90)]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["tile_longer_than_two_batches", "nb_on_batch_edges",
                                  "nb_differs_by_quarter", "empty_next_to_full",
                                  "all_alpha_capped", "one_lane_contributes"])
def test_blend_kernels_staging_edge_cases(cuda, name):
    blocks = _edge_case(name)
    counts = [len(b) for b in blocks]
    n = sum(counts)
    fields = torch.from_numpy(np.concatenate(blocks)).to(cuda)
    ends = torch.tensor(np.cumsum(counts), dtype=torch.int32, device=cuda)
    starts = ends - torch.tensor(counts, dtype=torch.int32, device=cuda)
    # owners in a shuffled table; a tail of 37 slots past n_valid
    perm = torch.from_numpy(np.random.default_rng(n).permutation(n)).to(cuda)
    table = torch.empty_like(fields)
    table[perm] = fields
    owner = torch.cat([perm, torch.zeros(37, dtype=perm.dtype, device=cuda)]).to(torch.int32)
    gx = len(blocks)
    args = (owner, starts, ends, table)

    packed = bl.blend_forward(*args, grid_x=gx)
    ref = bl.blend_forward_plain(*args, grid_x=gx)
    torch.testing.assert_close(packed[..., :5], ref[..., :5], atol=1e-5, rtol=0)
    assert torch.equal(packed[..., bl.O_NB], ref[..., bl.O_NB])
    nb = packed[..., bl.O_NB]
    if name == "nb_on_batch_edges":
        expect = torch.tensor([1, 63, 64, 127, 128, 255, 256, 511, 512], device=cuda) + starts
        assert torch.equal(nb, expect.float()[:, None].expand(-1, 256))
    if name == "empty_next_to_full":
        assert bool((packed[0::2, :, bl.O_T] == 1.0).all())
        assert bool((nb[1::2] < bl.NB_BIG).all())
    if name == "tile_longer_than_two_batches":
        assert bool((nb[0] == bl.NB_BIG).all())
    if name == "nb_differs_by_quarter":
        quarter = nb[0].view(2, 8, 2, 8).transpose(1, 2)  # (row half, column half, 8, 8)
        for (qy, qx), p in (((0, 0), 41), ((1, 1), 201)):
            done = quarter[qy, qx][quarter[qy, qx] < bl.NB_BIG]
            assert done.numel() > 0 and bool(((done >= p - 7) & (done <= p)).all())
        assert bool((quarter[0, 1] == bl.NB_BIG).all() and (quarter[1, 0] == bl.NB_BIG).all())

    g = torch.Generator(device=cuda).manual_seed(n)
    ct = torch.randn((gx, 256, bl.CT_COLS), generator=g, device=cuda)
    out = torch.full((owner.shape[0], bl.NUM_FIELDS), float("nan"), device=cuda)
    bl.launch_blend_backward(*args, packed, ct, gx, out)
    torch.cuda.synchronize()
    assert not bool(out[:n].isnan().any()) and bool(out[n:].isnan().all())
    grad = bl.blend_backward_plain(*args, packed, ct, grid_x=gx)[:n]
    scale = grad.abs().amax(dim=0) + 1e-30
    assert float(((out[:n] - grad).abs() / scale).max()) <= 1e-6
    if name == "all_alpha_capped":
        # zero gradient on the capped branch: positions, conics, opacity
        assert bool((out[:n, : bl.F_OP + 1] == 0).all())
        assert bool((out[starts.long(), bl.F_R] != 0).all())
    if name == "one_lane_contributes":
        assert bool((out[:n, bl.F_OP] != 0).any())


def test_blend_kernels_raise_on_unaligned_fields(cuda):
    """The kernels copy 8-byte halves of each field row: a table that starts
    4 bytes off an 8-byte boundary is refused."""
    fields = torch.zeros(4 * bl.NUM_FIELDS + 1, device=cuda)[1:].view(4, bl.NUM_FIELDS)
    owner = torch.arange(4, dtype=torch.int32, device=cuda)
    starts = torch.tensor([0], dtype=torch.int32, device=cuda)
    ends = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bl.blend_forward(owner, starts, ends, fields, grid_x=1)
    packed = torch.zeros((1, 256, bl.OUT_COLS), device=cuda)
    ct = torch.zeros((1, 256, bl.CT_COLS), device=cuda)
    with pytest.raises(ValueError):
        bl.blend_backward(owner, starts, ends, fields, packed, ct, grid_x=1)


# The evaluation suite on the card: no kernel of its own, but the port's
# LPIPS convolutions and the analytic shader must give on the card what they
# give on the CPU.
TOL_LPIPS_REL = 1e-4


@pytest.mark.parametrize("shape", [(48, 64), (1080, 1920)])
def test_lpips_on_the_card_matches_the_cpu(cuda, tmp_path, shape):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "lpips_rand.npz")
    np.savez(path, **random_lpips_weights(rng))
    a = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    on_card = make_lpips(path, device=cuda)(a, b)
    on_cpu = make_lpips(path, device="cpu")(a, b)
    assert on_cpu > 0
    assert abs(on_card - on_cpu) <= TOL_LPIPS_REL * on_cpu


@pytest.mark.parametrize("name", ["spheres", "thicket", "glossy"])
def test_float32_shader_on_the_card_matches_float64_on_the_cpu(cuda, name):
    """JAX's own tolerance for its float32 shader against its float64 one."""
    spheres, plane = _analytic_scene(0, name)
    eye, d = analytic_test_rays()
    rgb64, a64, t64 = (x.numpy() for x in shade_analytic(
        torch.from_numpy(eye), torch.from_numpy(d), spheres, plane, dtype=torch.float64))
    out = shade_analytic(torch.from_numpy(eye).to(cuda), torch.from_numpy(d).to(cuda),
                         spheres, plane)
    assert out[0].dtype == torch.float32 and out[0].is_cuda
    rgb, a, t = (x.double().cpu().numpy() for x in out)
    np.testing.assert_array_equal(a, a64)
    hit = a64 > 0
    np.testing.assert_allclose(t[hit], t64[hit], rtol=2e-3, atol=2e-3)
    assert np.quantile(np.abs(rgb - rgb64).max(axis=1), 0.97) < 0.02


def test_gshard_stripes_match_their_twins_and_the_single_render(cuda):
    """gshard's stripes, 4 ranks emulated in one process: each stripe's
    forward (K1-K3) and the backward of sum(colour) + sum(inverse depth)
    through K4-K6 bitwise equal to the twins; the stitched image within 3e-5
    of the single render."""
    from gaussian_splatting_torch.ops.preprocess import clip
    from gaussian_splatting_torch.parallel.gshard import stripe_from_records
    from gaussian_splatting_torch.utils.testing import emulated_exchange

    s = random_scene(3000, sh_degree=3, width=W, height=H, seed=3,
                     scale_range=(0.005, 0.03), bg=(0.1, 0.2, 0.3), device=cuda)
    arrays = (s.means3d, s.scales, s.quats, s.opacities, s.sh)
    with torch.no_grad():
        received, kw, routed, overflow = emulated_exchange(*arrays, s.cam, n=4, sh_degree=3)
    assert not overflow
    stripes = []
    for d, flat in enumerate(received):
        outs = []
        for kernels in (True, False):
            leaf = flat.clone().requires_grad_(True)
            color, invd, ovf, _ = stripe_from_records(leaf, d=d, bg_color=s.bg,
                                                      kernels=kernels, **kw)
            (g,) = torch.autograd.grad(color.sum() + invd.sum(), leaf)
            assert not bool(ovf)
            outs.append((color.detach(), invd.detach(), g))
        for a, b in zip(*outs):
            assert torch.equal(a, b), f"stripe {d}"
        stripes.append(outs[0][0])
    image = clip(torch.cat(stripes, dim=1)[:, :H], 0.0, 1.0)
    single = render(*arrays, s.cam, s.bg, sh_degree=3, inference=True).image
    assert float((image - single).abs().max()) <= 3e-5
    assert sum(map(sum, routed)) >= int((s.opacities > 0).sum()) // 2
