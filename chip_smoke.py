#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card, at full width.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):
  1. device   name, count, and nvidia-smi's name / power limit
  2. build    nvcc builds every kernel of gaussian_splatting_torch/csrc at once
  3. fixture  from --seed: a Blender scene of 1920x1080 PNGs (3 test views
              on an orbit of radius 4 around the y axis at height -0.3,
              looking at the origin, fovx 0.9) and a trained-model directory
              holding the bench scene (500k Gaussians, SH degree 3) and the
              raster_state.json a trainer leaves: the instance slack that fits
              the worst test view's measured slot demand plus 5%
  4. main     ``gaussian_splatting_torch.render.main`` renders the 3 test
              views on the card, once each; every kernel must have launched
  5. parity   each kernel against its plain PyTorch twin on the main path's
              inputs, the whole render against the all-plain path, and a
              small render against the dense oracle
  6. timing   CUDA-event times of each kernel, its twin and the library
              yardstick, beside the bound computed from this run's inputs
  7. profile  one view under torch.profiler: device time of each of the
              three kernels and of the largest others, and the device's busy
              share of the wall time
The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}.  Needs a card: without one it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# (pixel, instance) pair in the blend: ~20 float operations + one expf
BLEND_OPS_PER_PAIR = 21

NUM_GAUSSIANS = 500_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 3
ITERATION = 30_000
TOL_BLEND = 1e-5  # kernel vs twin on the card: RGB, T, inverse depth
TOL_IMAGE = 2e-4  # whole render vs the all-plain path / the dense oracle
NB_DIFF_MAX = 1e-4  # share of pixels whose NB may differ (fp rounding at T_EPS)


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the card")
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} x{count}")
    print(smi)
    return kind, count


def build_phase():
    from gaussian_splatting_torch import _kernels

    phase("build")
    t0 = time.perf_counter()
    reports = _kernels.build(force=True)
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")


def make_fixture(root: str, seed: int, device: str = "cuda"):
    import numpy as np

    from gaussian_splatting_torch.data.ply import save_gaussian_ply, save_point_cloud_ply
    from gaussian_splatting_torch.ops.camera_math import look_at
    from gaussian_splatting_torch.utils.image import write_image
    from gaussian_splatting_torch.utils.testing import random_arrays

    phase("fixture")
    t0 = time.perf_counter()
    scene_dir = os.path.join(root, "scene")
    model_dir = os.path.join(root, "model")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(scene_dir, "test"))
    os.makedirs(os.path.join(scene_dir, "train"))

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH]

    def frame(kind, i, eye):
        R, t = look_at(eye, [0.0, 0.0, 0.0])
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, as Blender stores them
        rel = f"{kind}/r_{i}"
        base = rng.uniform(0, 255, 3)
        pix = (base + 0.05 * xx[..., None] + 0.1 * yy[..., None]) % 256
        write_image(os.path.join(scene_dir, rel + ".png"), pix.astype(np.uint8))
        return {"file_path": rel, "transform_matrix": c2w.tolist()}

    def orbit(k, n):
        a = 2 * math.pi * k / n
        return [4.0 * math.sin(a), -0.3, -4.0 * math.cos(a)]

    for kind, eyes in (("train", [orbit(0.5, 3)]), ("test", [orbit(k, 3) for k in range(3)])):
        frames = [frame(kind, i, e) for i, e in enumerate(eyes)]
        with open(os.path.join(scene_dir, f"transforms_{kind}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)
    pts = rng.uniform(-1.3, 1.3, (1000, 3)).astype(np.float32)
    save_point_cloud_ply(os.path.join(scene_dir, "points3d.ply"), pts,
                         rng.integers(0, 256, (1000, 3), dtype=np.uint8))

    means, scales, quats, opac, sh = random_arrays(
        NUM_GAUSSIANS, sh_degree=SH_DEGREE, seed=seed, spread=2.0,
        scale_range=(0.0025, 0.012),
    )
    pc_dir = os.path.join(model_dir, "point_cloud", f"iteration_{ITERATION}")
    os.makedirs(pc_dir)
    save_gaussian_ply(
        os.path.join(pc_dir, "point_cloud.ply"),
        means3d=means, features_dc=sh[:, :1], features_rest=sh[:, 1:],
        opacities=np.log(opac / (1.0 - opac)), scales=np.log(scales), quats=quats,
    )
    with open(os.path.join(model_dir, "cfg_args.json"), "w") as f:
        json.dump({"sh_degree": SH_DEGREE, "source_path": scene_dir,
                   "model_path": model_dir, "resolution": 1, "eval": True}, f)
    demand, slack, capacity = write_raster_state(model_dir, device)
    print(f"fixture in {time.perf_counter() - t0:.2f} s: {NUM_GAUSSIANS} Gaussians, "
          f"{WIDTH}x{HEIGHT}, 3 test views; worst slot demand {demand}, "
          f"instance_slack {slack:.6f}, capacity {capacity}")
    return scene_dir, model_dir


def write_raster_state(model_dir, device):
    """The raster_state.json that the JAX trainer's ``save_raster_state``
    leaves beside a model: the instance slack that fits the worst test view's
    slot demand (sentinels included) with 5% headroom, the rule bench.py
    sizes its capacity by."""
    import torch

    from gaussian_splatting_torch.config import ModelConfig, load_config
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.scene import Scene

    cfg = load_config(ModelConfig, os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, load_iteration=-1, device=torch.device(device))
    model = scene.gaussians
    params = model.activated_params()
    with torch.no_grad():
        demand = max(
            int(inst.build_table(preprocess(*params, c.cam, sh_degree=SH_DEGREE))[1])
            for c in scene.get_test_cameras()
        )
    slack = 1.05 * demand / model.capacity
    capacity = inst.required_capacity(model.capacity, slack)
    with open(os.path.join(model_dir, "raster_state.json"), "w") as f:
        json.dump({"instance_slack": slack, "capacity": capacity}, f)
    return demand, slack, capacity


def main_path_phase(model_dir, device="cuda"):
    import numpy as np

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch import render as render_cli
    from gaussian_splatting_torch.utils.image import read_image

    phase("main path")
    _kernels.reset_launches()
    records = render_cli.main(["-m", model_dir, "--skip_train", "--device", device])
    launches = dict(_kernels.launches)
    print(f"launches during the main path: {launches}")
    if len(records) != 3:
        raise RuntimeError(f"expected 3 rendered views, got {len(records)}")
    for r in records:
        img = read_image(r["path"])
        if img.shape != (HEIGHT, WIDTH, 3) or int(img.max()) == 0:
            raise RuntimeError(f"bad render {r['path']}: {img.shape}, max {img.max()}")
        print(f"  view {r['index']}: {r['seconds'] * 1e3:.1f} ms wall (synchronised), "
              f"slot demand (num_instances) {r['num_instances']}, retries {r['retries']}, "
              f"peak {(r['peak_bytes'] or 0) / 2**20:.0f} MiB, mean pixel {img.mean():.1f}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    if any(r["retries"] for r in records):
        raise RuntimeError("a view overflowed the capacity sized from its measured demand")
    return launches


def cuda_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def parity(model_dir, device="cuda"):
    """Kernel vs plain on the main path's inputs (view 0).  Returns what the
    timing phase needs."""
    import torch

    from gaussian_splatting_torch.config import ModelConfig, RasterizeConfig, load_config
    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.ops.rasterize import _render, blend_fields
    from gaussian_splatting_torch.render import load_raster_state
    from gaussian_splatting_torch.scene import Scene

    phase("parity at full width")
    cuda = torch.device(device)
    cfg = load_config(ModelConfig, os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, load_iteration=-1, device=cuda)
    model = scene.gaussians
    camera = scene.get_test_cameras()[0]
    cam = camera.cam
    slack = load_raster_state(model_dir, RasterizeConfig()).instance_slack
    capacity = inst.required_capacity(model.capacity, slack)
    params = model.activated_params()
    with torch.no_grad():
        proj = preprocess(*params, cam, sh_degree=SH_DEGREE)
        gx, gy = -(-WIDTH // 16), -(-HEIGHT // 16)
        num_tiles = gx * gy
        cap_int = inst.internal_capacity(capacity)
        table, total = inst.build_table(proj)

        # K1: keys and owners bitwise (the blend's fields are read through
        # the owner, so equal owners mean equal sorted fields)
        ekw = dict(capacity=cap_int, grid_x=gx, num_tiles=num_tiles)
        keys, owner = ex.expand_instances(table, **ekw)
        keys_p, owner_p = ex.expand_instances_plain(table, **ekw)
        torch.cuda.synchronize()
        if not (torch.equal(keys, keys_p) and torch.equal(owner, owner_p)):
            raise RuntimeError("expand kernel disagrees with its plain version")
        err_expand = max(int((keys - keys_p).abs().max()), int((owner - owner_p).abs().max()))
        layout = inst.layout_from_keys(keys, owner, total, capacity=capacity,
                                       num_tiles=num_tiles)
        if bool(layout.overflow):
            raise RuntimeError("parity capacity overflowed")
        print(f"expand: bitwise equal over {cap_int} slots; demand {int(total)}, "
              f"valid instances {int(layout.n_valid)}")

        # K2
        fields = blend_fields(proj)
        bargs = (layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields)
        packed = bl.blend_forward(*bargs, grid_x=gx)
        packed_p = bl.blend_forward_plain(*bargs, grid_x=gx)
        err_blend = float((packed[..., :5] - packed_p[..., :5]).abs().max())
        nb_diff = int((packed[..., bl.O_NB] != packed_p[..., bl.O_NB]).sum())
        n_pix = num_tiles * 256
        print(f"blend: max |kernel - plain| over RGB/T/invd {err_blend:.3e} "
              f"(tolerance {TOL_BLEND}); NB differs on {nb_diff} of {n_pix} pixels")
        if not err_blend <= TOL_BLEND or nb_diff > NB_DIFF_MAX * n_pix:
            raise RuntimeError("blend kernel disagrees with its plain version")

        # K3
        ukw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16, width=WIDTH,
                   height=HEIGHT, cols=bl.CT_COLS)
        img = ut.untile(packed, **ukw)
        img_p = ut.untile_plain(packed, **ukw)
        if not torch.equal(img, img_p):
            raise RuntimeError("untile kernel disagrees with its plain version")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError("non-finite render")
        print("untile: bitwise equal")

        # whole render: kernel path vs all-plain path, and a small render vs
        # the dense oracle
        rcfg = RasterizeConfig(instance_slack=slack)
        bg = torch.zeros(3, device=cuda)
        fast = _render(*params, cam, bg, sh_degree=SH_DEGREE, cfg=rcfg)
        plain = _render(*params, cam, bg, sh_degree=SH_DEGREE, cfg=rcfg, kernels=False)
        err_render = float((fast.image - plain.image).abs().max())
        print(f"render kernels vs plain path: max |image diff| {err_render:.3e} "
              f"(tolerance {TOL_IMAGE})")
        if not err_render <= TOL_IMAGE:
            raise RuntimeError("kernel render disagrees with the plain path")
        check_small_vs_oracle(cuda)

        # pairs each pixel must visit, and instances each tile must read
        starts = layout.tile_starts.long()[:, None]
        ends = layout.tile_ends.long()[:, None]
        nb = packed[..., bl.O_NB].long()
        done = nb < int(bl.NB_BIG)
        pairs = int(torch.where(done, nb - starts + 1, ends - starts).sum())
        need = torch.where(done.all(dim=1), nb.max(dim=1).values + 1, ends[:, 0])
        n_read = int((need - starts[:, 0]).sum())
        print(f"blend pairs visited {pairs}, instances read {n_read}")
    return dict(table=table, ekw=ekw, cap_int=cap_int, bargs=bargs, gx=gx, gy=gy,
                num_tiles=num_tiles, packed=packed, ukw=ukw, pairs=pairs,
                n_read=n_read, err_expand=err_expand, err_blend=err_blend,
                model=model, camera=camera, slack=slack)


def profile_phase(ctx, top=12):
    """Where one view's time goes: a warm render_camera (one render, no
    retry) under torch.profiler; the device time of each of the three kernels,
    the largest other entries, and the device's busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.render import render_camera

    phase("profile")
    cfg = RasterizeConfig(instance_slack=ctx["slack"])
    bg = torch.zeros(3, device="cuda")
    for _ in range(2):
        render_camera(ctx["model"], ctx["camera"], cfg, bg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_camera(ctx["model"], ctx["camera"], cfg, bg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): CPU ops would
    # count their kernels a second time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"steady-state view: wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device ops")
    for name in _kernels.KERNELS:
        own = [e for e in events if f"::{name}_kernel(" in e.key]
        if not own:
            raise RuntimeError(f"profile shows no {name} kernel on the device")
        print(f"  {name} kernel: {sum(e.self_device_time_total for e in own) / 1e3:.4f} ms "
              f"device time, x{sum(e.count for e in own)}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")


def timing(ctx, launches):
    import torch

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import untile as ut

    phase("timing")
    table, ekw, bargs, packed, ukw = (ctx[k] for k in ("table", "ekw", "bargs", "packed", "ukw"))
    gx, gy, num_tiles = ctx["gx"], ctx["gy"], ctx["num_tiles"]
    with torch.no_grad():
        rows = []
        t_bytes = expand_bytes(table, ctx["cap_int"])
        print(f"expand moves at least {t_bytes} bytes")
        rows.append(kernel_row(
            "expand", "gaussian_splatting_tpu/ops/expand.py:310", launches, ctx["err_expand"],
            cuda_ms(lambda: ex.expand_instances(table, **ekw)),
            cuda_ms(lambda: ex.expand_instances_plain(table, **ekw)),
            t_bytes, 0, None,
        ))
        b_bytes = ctx["n_read"] * (4 + 4 * bl.NUM_FIELDS) + num_tiles * (8 + 256 * bl.OUT_COLS * 4)
        rows.append(kernel_row(
            "blend_forward", "gaussian_splatting_tpu/ops/blend_pallas.py:518", launches,
            ctx["err_blend"],
            cuda_ms(lambda: bl.blend_forward(*bargs, grid_x=gx)),
            cuda_ms(lambda: bl.blend_forward_plain(*bargs, grid_x=gx), iters=5, warmup=1),
            b_bytes, ctx["pairs"] * BLEND_OPS_PER_PAIR, None,
        ))
        u_bytes = 2 * bl.CT_COLS * WIDTH * HEIGHT * 4
        view = packed.view(gy, gx, 16, 16, bl.OUT_COLS)[..., : bl.CT_COLS]
        rows.append(kernel_row(
            "untile", "gaussian_splatting_tpu/ops/untile.py:45", launches, 0.0,
            cuda_ms(lambda: ut.untile(packed, **ukw)),
            cuda_ms(lambda: ut.untile_plain(packed, **ukw)),
            u_bytes, 0,
            cuda_ms(lambda: view.permute(4, 0, 2, 1, 3).contiguous()),
        ))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.4f} by {r['bound_by']})")
    return rows


def expand_bytes(table, cap_int):
    """Bytes the expand must move on this table: every Gaussian's offset and
    depth key; for each Gaussian with instances, its mapping flag and first
    rect row, then either its whole span_cum row and the span_x0 entries of
    its occupied rows (span mapping) or its rect x0 and width (rect mapping);
    and the 12-byte key and owner written per slot."""
    import torch

    from gaussian_splatting_torch.ops import expand as ex

    P = table.depth_key.numel()
    live = table.depth_key < ex.BIG
    span = live & (table.span_flag != 0)
    n_span = int(span.sum())
    n_rect = int(live.sum()) - n_span
    cum = table.span_cum[span]
    row_cells = torch.diff(cum, dim=1, prepend=torch.zeros_like(cum[:, :1]))
    occupied_rows = int((row_cells > 0).sum())
    per_gaussian = 4 * (P + 1) + 4 * P
    span_reads = n_span * (4 + 4 + 4 * ex.MAX_SPAN_ROWS) + 4 * occupied_rows
    rect_reads = n_rect * 4 * 4
    return per_gaussian + span_reads + rect_reads + cap_int * (8 + 4)


def check_small_vs_oracle(cuda):
    import torch

    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.utils.testing import random_scene

    s = random_scene(1500, sh_degree=SH_DEGREE, width=128, height=96, seed=7,
                     scale_range=(0.005, 0.04), bg=(0.1, 0.2, 0.3), device=cuda)
    args = (s.means3d, s.scales, s.quats, s.opacities, s.sh, s.cam, s.bg)
    fast = render(*args, sh_degree=SH_DEGREE, inference=True)
    dense = render(*args, sh_degree=SH_DEGREE, impl="dense", inference=True)
    err = max(float((getattr(fast, k) - getattr(dense, k)).abs().max())
              for k in ("image", "invdepth", "final_T"))
    print(f"small render (1500 Gaussians, 128x96) vs dense oracle: max diff {err:.3e} "
          f"(tolerance {TOL_IMAGE})")
    if bool(fast.overflow) or not err <= TOL_IMAGE or not torch.equal(fast.radii, dense.radii):
        raise RuntimeError("kernel render disagrees with the dense oracle")


def kernel_row(name, replaces, launches, err, ms, plain_ms, n_bytes, n_ops, library_ms):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"gaussian_splatting_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    kind, count = device_phase()
    build_phase()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    _, model_dir = make_fixture(root, args.seed)
    launches = main_path_phase(model_dir)
    ctx = parity(model_dir)
    rows = timing(ctx, launches)
    profile_phase(ctx)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


if __name__ == "__main__":
    sys.exit(main())
