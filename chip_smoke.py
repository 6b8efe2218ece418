#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card, at full width.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):
  1. device   name, count, and nvidia-smi's name / power limit
  2. build    nvcc builds every kernel of gaussian_splatting_torch/csrc, and
              K7's first design (SEGSCAN_FIRST_DESIGN), all at once
  3. fixture  from --seed: a Blender scene of 1920x1080 PNGs (3 test views
              on an orbit of radius 4 around the y axis at height -0.3,
              looking at the origin, fovx 0.9) and a trained-model directory
              holding the bench scene (500k Gaussians, SH degree 3) and the
              raster_state.json a trainer leaves: the instance slack that fits
              the worst test view's measured slot demand plus 5%
  4. render path    ``gaussian_splatting_torch.render.main`` renders the 3
              test views on the card, once each; K1-K3 must have launched
  5. render parity  K1-K3 against their plain PyTorch twins on the render
              path's inputs, the whole render against the all-plain path, and
              a small render against the dense oracle; K1's global loads and
              sectors per warp-load before its block design and now
              (``expand_work``), K3's bytes moved before its record-order
              design and now, and its sector floor (``untile_work``); the
              blend's pairs, instances per tile and K2's warp-steps
              (``blend_work``)
  6. render timing  CUDA-event times of K1-K3, their twins and the library
              yardsticks, beside the bounds computed from this run's inputs
  7. render profile one view under torch.profiler
  8. train parity   on the first training step's own inputs (the fixture
              model with seeded noise, view 0, full width): K3 and K4
              bitwise, K5 and K6 within their tolerances against their twins,
              the whole field gradient against the all-twin path, and a small
              scene's gradients against the dense oracle's autograd; K2's and
              K5's warp-steps, shared-memory instructions and shuffles, before
              their current design and now
  9. train path     ``train.step.train_step`` 13 times over the 3 views (the
              last one profiled), then ``densify_step`` and
              ``opacity_reset_step``, against the fixture model's own renders;
              no overflow, finite losses, each view's loss falls, K1-K6 launch
 10. train timing   K4-K6 as in phase 6, on phase 8's inputs, K4 and K6 also
              under torch.profiler; K6's warp-steps and sectors per load before
              its warp design and now (``segreduce_work``)
 11. bench          bench.py's quantity on the port: forward + backward of
              sum(image) + sum(invdepth) at 1080p on bench.py's scene, px/s
 12. train CLI scene  8 train and 2 test 1080p views on orbits of radius 20
              (see CLI_ORBIT_RADIUS), each the port's render of the fixture
              model, and points3d.ply with its 500k means and DC colours
 13. train CLI      ``python -m gaussian_splatting_torch.train`` in-process:
              300 iterations from create_from_pcd (densify at 100, 200, 300,
              opacity reset at 200, eval, snapshots, a checkpoint at 300), a
              resume to 310, the render CLI on the result; K1-K6 launch, the
              JAX trainer's files exist, the resume starts at 301, the
              test-view PSNR beats the initial model's by 1 dB, and K1 is
              bitwise equal to its twin on both models' test-view tables;
              prints the steady and boundary wall times, the loop's slack
              reports, and K4's and K6's times and K6's work counts on the
              profiled iteration's own inputs
 14. configurations the switches that change what K1-K6 see, at full width:
              one training step each under SH degree 4 (the fixture model
              widened to 25 coefficients, 9 drawn from --seed), antialiasing,
              precomputed colours and covariances, sparse Adam (moments of
              Gaussians with radii 0 unmoved) and a non-identity exposure (its
              gradient finite and nonzero), each with K1-K6 bitwise against
              their twins on the step's inputs and the field gradients against
              the all-twin path; then the training CLI for 110 iterations
              (densify at 100, eval) with --sh_degree 4 from a degree-4
              checkpoint (every step at active degree 4, a 72-column
              snapshot), and with --antialiasing --optimizer_type sparse_adam
              --train_test_exp --random_background, each followed by the
              render CLI; steady iteration times beside phase 13's
 15. depth maps     2 of the CLI scene's train views with 16-bit depth PNGs
              (the fixture model's rendered inverse depth x 512), loaded by
              the port's Scene through the training CLI's ``-d``; 3
              iterations, each with a finite, nonzero depth term
 16. COLMAP scene   the CLI scene's 10 views as a COLMAP capture written by
              the port's writers (1920x1080 JPEGs, 16-bit depth PNGs through a
              known affine, points3D.bin with the 500k means, observations);
              ``python -m gaussian_splatting_torch.make_depth_scale`` (every
              scale within 5% of the affine's); the training CLI with the
              default -r -1 (images resized to 1600x900), -d depths --eval,
              30 iterations (K1-K6 launch, finite nonzero depth terms); the
              render CLI on the test views
 17. segscan        K7 on phase 8's expansion-order gradient rows (10 x ~1.76M,
              flagged at each Gaussian segment's first slot): one launch as
              its path, then bitwise against its twin and, at each segment's
              last slot, bitwise against K6's sums; timed and profiled, with
              its first design timed on the same rows
 18. evaluation     the analytic "spheres" scene at JAX's defaults (100 train
              and 12 test views at 800x600 from 1600x1200 rays each, depth
              maps), shaded on the card once its float32 shader agrees with
              float64 on the CPU; the training CLI for 500 iterations with
              the viewer on while a client thread asks for test view 0 twice;
              the trained model's viewer frames against the render CLI's PNG
              and a direct render at scaling modifier 0.5; the render CLI at
              iterations 1 and 500; ``metrics`` with LPIPS weights drawn from
              --seed (finite scores, a 1 dB PSNR gain); LPIPS on the card
              against the CPU.  Prints each step's wall time
 19. corpus         the three analytic scenes of the quality corpus at full
              width (800x600, 100 train and 12 test views, 100k random
              points, --capacity 262144, each scene's switches) through
              ``gaussian_splatting_torch.corpus.run_scene``: generated on the
              card ("spheres" reuses phase 18's views), trained on the
              reference's 30,000-iteration schedule and ended after
              iteration 1000 (densify from 600, the first SH step), the
              render and metrics CLIs on the snapshot there; K1-K6 launch in
              each scene and equal their twins bitwise on iteration 1000's
              arguments, the test PSNR at 1000 at least JAX's (its
              results/<scene>_train.log) less 1 dB; the three scenes at
              once, each in a child process (``--corpus-child``); the
              Gaussian count,
              overflow no-ops and steady iteration time beside JAX's; K4 and
              K6 timed on thicket's inputs at iteration 1000; a 360 s watchdog
 20. multi-GPU      gshard at n = 4 ranks emulated in one process on the bench
              scene: each stripe through K1-K6 bitwise against the twins
              (forward, and the backward of sum(colour) + sum(inverse depth))
              and the stitched image within 3e-5 of the single render, with
              the records routed and each stripe's instances; on an NCCL
              world of one, 3 steps each of train_step, dp_train_step (within
              1e-6) and gshard_train_step (within 2e-4; after its first step
              the gradients, densification statistics and means too); the
              training CLI with --parallel gshard (110 iterations, through the
              densify at 100) and --parallel dp (30) in subprocesses on the
              CLI scene: K1-K6 launch, rank 0's files,
              finite losses, the steady iteration time beside phase 13's
 21. late state     the committed fixture LATE_STATE (the port's "spheres"
              corpus run at iteration 15000, the central window of a test
              view; ``tools/torch_c4_probe.py --cut``) through one training
              step on the card: K1-K6 launch, each bitwise equal to its twin
              on the step's own arguments, and the render within 2e-4 of the
              all-plain path with equal radii
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
# Float operations per (pixel, instance) pair, counted from the kernels'
# code (expf counts as one; nothing is fused, the kernels build with
# -fmad=false).  A pair "contributes" when its alpha is eligible (power <=
# POWER_EPS, alpha >= 1/255) and its stream position is below the pixel's
# NB; other visited pairs only compute alpha.
# csrc/blend_forward.cu, ``blend_forward_kernel``'s inner loop: dx, dy (2),
# power (9), opacity * expf (2), the 0.99 cap (1), the two eligibility
# compares (2) on every pair visited; then 1 - alpha, T (1 - alpha), the
# T_EPS compare (3) on an eligible pair, and the weight and four weighted
# adds (9) on a contributing one.
BLEND_VISIT_OPS = 16
BLEND_ELIGIBLE_OPS = 3
BLEND_CONTRIB_OPS = 9
# csrc/blend_backward.cu, ``replay`` per pixel: alpha as in the forward plus
# the NB compare (17; a thread's two pixels share one dx, still counted per
# pixel); ``terms`` on a contributing pair: q (7), w, w q, the prefix (3),
# gl (7), T (1), the 9 products of the summed terms (9); and one add into
# each of the instance's 10 sums (10: the add of a thread's two pixels or a
# butterfly or warp-partial add).
BLEND_BWD_VISIT_OPS = 17
BLEND_BWD_CONTRIB_OPS = 7 + 3 + 7 + 1 + 9 + 10

NUM_GAUSSIANS = 500_000
WIDTH, HEIGHT = 1920, 1080
SH_DEGREE = 3
ITERATION = 30_000
TOL_BLEND = 1e-5  # kernel vs twin on the card: RGB, T, inverse depth
TOL_IMAGE = 2e-4  # whole render vs the all-plain path / the dense oracle
NB_DIFF_MAX = 1e-4  # share of pixels whose NB may differ (fp rounding at T_EPS)
# K5 vs its twin, relative to each gradient column's largest magnitude.  The
# twin repeats every operation and every sum in the kernel's order (built
# with -fmad=false), so the two should agree to the bit; the tolerance only
# admits a last-bit difference in a library exp or division.
TOL_BLEND_BWD = 1e-6
TOL_GRAD = 3e-4  # gradients vs the all-twin path / the dense oracle, scaled
TRAIN_STEPS = 12  # counted steps over the 3 views, then one profiled step
REPO = os.path.dirname(os.path.abspath(__file__))
# K7's first design, kept as a variant; the segscan phase times it beside
# the package's kernel on the same inputs
SEGSCAN_FIRST_DESIGN = os.path.join("tools", "kernel_variants", "segscan_thread")


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script needs the card")
    phase("device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device {kind} x{count}")
    print(card())
    return kind, count


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def build_phase():
    """nvcc on every kernel of the package and on K7's first design, all at
    once; returns the first design's library."""
    from gaussian_splatting_torch import _kernels

    phase("build")
    t0 = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "chip_smoke_variants")
    os.makedirs(out_dir, exist_ok=True)
    first_lib = os.path.join(out_dir, "libsegscan_first.so")
    first = subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", first_lib,
         os.path.join(REPO, SEGSCAN_FIRST_DESIGN, "segscan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        reports = _kernels.build(force=True)
    finally:
        log, _ = first.communicate()
    if first.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SEGSCAN_FIRST_DESIGN}/segscan.cu:\n{log}")
    reports["segscan (first design)"] = log
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.2f} s")
    for name, log in sorted(reports.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")
    return first_lib


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
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=torch.device(device))
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

    phase("render path")
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
    missing = [k for k in _kernels.RENDER_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the render path: {missing}")
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
    from gaussian_splatting_torch.train.loop import load_raster_state
    from gaussian_splatting_torch.scene import Scene

    phase("render parity at full width")
    cuda = torch.device(device)
    cfg = load_config(ModelConfig, os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=cuda)
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
        expand_work(table, ekw)

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
        untile_work(packed, ukw)

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
        contrib, _ = contributing_pairs(layout, fields, packed, gx)
        n_done = int(done.sum())
        blend_ops = (BLEND_VISIT_OPS * pairs + BLEND_CONTRIB_OPS * contrib
                     + BLEND_ELIGIBLE_OPS * (contrib + n_done))
        print(f"blend pairs visited {pairs}, of which contributing {contrib} "
              f"({100 * contrib / pairs:.2f}%), pixels saturated {n_done}; instances read "
              f"{n_read}; {blend_ops} float operations")
        blend_work(layout, packed)
    return dict(table=table, ekw=ekw, cap_int=cap_int, bargs=bargs, gx=gx, gy=gy,
                num_tiles=num_tiles, packed=packed, ukw=ukw, blend_ops=blend_ops,
                n_read=n_read, err_expand=err_expand, err_blend=err_blend,
                model=model, camera=camera, slack=slack)


def contributing_pairs(layout, fields, packed, grid_x, chunk=1 << 15):
    """(pixel, instance) pairs whose alpha is eligible and whose stream
    position is below the pixel's NB: each valid slot against its tile's
    256 pixels, alpha formed as the kernels and their twins form it.  Also,
    for each warp layout of ``warp_view``, the (instance, warp) steps in
    which at least one of the warp's pixels contributes."""
    import torch

    from gaussian_splatting_torch.ops import blend as bl

    dev = fields.device
    lp = torch.arange(256, device=dev)
    nb = packed[..., bl.O_NB]
    n = int(layout.n_valid)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    warps = {d: torch.zeros((), dtype=torch.int64, device=dev) for d in WARP_LAYOUTS}
    for s0 in range(0, n, chunk):
        pos = torch.arange(s0, min(s0 + chunk, n), dtype=torch.int32, device=dev)
        tile = torch.searchsorted(layout.tile_ends, pos, right=True)
        f = fields[layout.sorted_owner[pos].long()]
        dx = f[:, bl.F_X, None] - (((tile % grid_x) * 16)[:, None] + lp % 16).float()
        dy = f[:, bl.F_Y, None] - (((tile // grid_x) * 16)[:, None] + lp // 16).float()
        power = -0.5 * (f[:, bl.F_CA, None] * dx * dx + f[:, bl.F_CC, None] * dy * dy) - (
            f[:, bl.F_CB, None] * dx * dy)
        alpha = torch.clamp(f[:, bl.F_OP, None] * torch.exp(power), max=bl.ALPHA_CAP)
        c = (power <= bl.POWER_EPS) & (alpha >= bl.ALPHA_MIN) & (pos.float()[:, None] < nb[tile])
        total += c.sum()
        for d in WARP_LAYOUTS:
            warps[d] += warp_view(c, d).any(dim=-1).sum()
    return int(total), {d: int(w) for d, w in warps.items()}


# The pixels of a tile (16 row + col) each warp covers: "rows", 8 warps of
# one thread per pixel, warp w on rows 2w and 2w + 1 (K2, and K5 before this
# design); "quarters", 4 warps of two pixels per thread, warp w on the 8x8
# quarter (w % 2, w // 2) (K5 now).
WARP_LAYOUTS = ("rows", "quarters")


def warp_view(x, layout):
    """(..., 256) per-pixel values as (..., warps, pixels of the warp)."""
    lead = x.shape[:-1]
    if layout == "rows":
        return x.reshape(*lead, 8, 32)
    return x.reshape(*lead, 2, 8, 2, 8).transpose(-3, -2).reshape(*lead, 4, 64)


# Each kernel's warp layout, and its shared-memory instructions and shuffles
# per warp-step (one staged instance against a warp's pixels), counted from
# the kernels' code, before this design (PR 3) and now.  K2 reads 6 fields
# on every step and the 4 colour fields on a step where a pixel contributes:
# 10 scalar reads before, 3 float4 broadcasts now.  K5 reads all 10 fields
# on every step and stores the warp's 10 sums on every step: lane 0's 10
# scalar stores before, one store by 10 lanes now.  It sums over the warp
# only on a step where a pixel contributes: ten 5-level shuffle-down trees
# before, the 12-shuffle xor reduce-scatter now.
BLEND_DESIGNS = {  # (warp layout, reads, stores, shuffles)
    "K2": {"PR 3": ("rows", 10, 0, 0), "now": ("rows", 3, 0, 0)},
    "K5": {"PR 3": ("rows", 10, 10, 50), "now": ("quarters", 3, 1, 12)},
}
K5_BATCH_PR3 = 128  # PR 3's K5 replayed whole batches of 128 instances


def blend_work(layout, packed, contrib_warps=None):
    """What the blend kernels do on these inputs, from the twin's NB and
    contributor masks, for PR 3's design and this one: the instances per
    tile; K2's warp-steps (each warp walks until its last pixel is done);
    K5's (PR 3: every warp replayed every instance of each staged batch until
    all the tile's pixels were past their NB; now: every warp replays the
    instances below its own pixels' largest NB) with those that hold a
    contributing pixel; and the shared-memory instructions and shuffles."""
    import torch

    from gaussian_splatting_torch.ops import blend as bl

    starts = layout.tile_starts.long()
    ends = layout.tile_ends.long()
    counts = (ends - starts).clamp(min=0)
    q = torch.quantile(counts.double(), torch.tensor([0.5, 0.99], dtype=torch.float64,
                                                     device=counts.device)).tolist()
    print(f"  instances per tile: max {int(counts.max())}, p50 {q[0]:.1f}, p99 {q[1]:.1f}, "
          f"mean {float(counts.double().mean()):.2f}; {int((counts == 0).sum())} of "
          f"{counts.numel()} tiles empty")
    nb = packed[..., bl.O_NB].long()
    done = nb < int(bl.NB_BIG)
    visited = torch.where(done, nb - starts[:, None] + 1, counts[:, None])
    k2_steps = int(warp_view(visited, "rows").amax(dim=-1).sum())
    need = torch.where(done.all(dim=1), nb.max(dim=1).values, ends) - starts
    rounds = (need.clamp(min=0) + K5_BATCH_PR3 - 1) // K5_BATCH_PR3
    steps = {"K2": {"PR 3": k2_steps, "now": k2_steps},
             "K5": {"PR 3": 8 * int(torch.minimum(counts, rounds * K5_BATCH_PR3).sum()),
                    "now": int((torch.minimum(warp_view(nb, "quarters").amax(dim=-1),
                                              ends[:, None])
                                - starts[:, None]).clamp(min=0).sum())}}
    kernels = ("K2", "K5") if contrib_warps is not None else ("K2",)
    for name in kernels:
        for design, (layout_name, rd, st, sh) in BLEND_DESIGNS[name].items():
            n_steps = steps[name][design]
            cw = contrib_warps[layout_name] if name == "K5" else 0
            held = (f", {cw} ({100 * cw / n_steps:.2f}%) with a contributing pixel"
                    if name == "K5" else "")
            print(f"  {name} {design} ({layout_name}): {n_steps} warp-steps{held}; per "
                  f"warp-step {rd} shared reads, {st} stores, {sh} shuffles on a "
                  f"contributing step; in all {rd * n_steps} reads, {st * n_steps} stores, "
                  f"{sh * cw} shuffles")
    return {"warp_steps": steps, "k5_contributing_warp_steps": contrib_warps}


def profile_call(fn, kernels, top=12):
    """``fn`` once under torch.profiler: its synchronised wall time, the
    device's busy share of it, each named kernel's own device time and the
    largest other entries.  Returns each kernel's device ms per launch that
    the profiler recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): CPU ops would
    # count their kernels a second time
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"wall {wall_ms:.3f} ms, device busy {device_ms:.3f} ms "
          f"({100 * device_ms / wall_ms:.1f}%), {sum(e.count for e in events)} device ops")
    own_ms = {}
    for name in kernels:
        own = [e for e in events if f"::{name}_kernel(" in e.key]
        if not own:
            raise RuntimeError(f"profile shows no {name} kernel on the device")
        # K1 runs a partition grid before each expand grid: its time counts too
        extra = [e for e in events if f"::{name}_partition_kernel(" in e.key]
        total_ms = sum(e.self_device_time_total for e in own + extra) / 1e3
        count = sum(e.count for e in own)
        own_ms[name] = total_ms / count
        print(f"  {name} kernel: {total_ms:.4f} ms device time, x{count}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")
    return own_ms


def profile_phase(ctx):
    """Where one view's time goes: a warm render_camera (one render, no
    retry) under torch.profiler."""
    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.render import render_camera

    phase("render profile")
    cfg = RasterizeConfig(instance_slack=ctx["slack"])
    bg = torch.zeros(3, device="cuda")
    for _ in range(2):
        render_camera(ctx["model"], ctx["camera"], cfg, bg)
    torch.cuda.synchronize()
    print("steady-state view:", end=" ")
    profile_call(lambda: render_camera(ctx["model"], ctx["camera"], cfg, bg),
                 _kernels.RENDER_KERNELS)


def timing(ctx):
    import torch

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import untile as ut

    phase("render timing")
    table, ekw, bargs, packed, ukw = (ctx[k] for k in ("table", "ekw", "bargs", "packed", "ukw"))
    gx, gy, num_tiles = ctx["gx"], ctx["gy"], ctx["num_tiles"]
    with torch.no_grad():
        rows = []
        t_bytes = expand_bytes(table, ctx["cap_int"])
        print(f"expand moves at least {t_bytes} bytes")
        rows.append(kernel_row(
            "expand", "gaussian_splatting_tpu/ops/expand.py:310", ctx["err_expand"],
            cuda_ms(lambda: ex.expand_instances(table, **ekw)),
            cuda_ms(lambda: ex.expand_instances_plain(table, **ekw)),
            t_bytes, 0, None,
        ))
        b_bytes = ctx["n_read"] * (4 + 4 * bl.NUM_FIELDS) + num_tiles * (8 + 256 * bl.OUT_COLS * 4)
        rows.append(kernel_row(
            "blend_forward", "gaussian_splatting_tpu/ops/blend_pallas.py:518", ctx["err_blend"],
            cuda_ms(lambda: bl.blend_forward(*bargs, grid_x=gx)),
            cuda_ms(lambda: bl.blend_forward_plain(*bargs, grid_x=gx), iters=5, warmup=1),
            b_bytes, ctx["blend_ops"], None,
        ))
        u_bytes = 2 * bl.CT_COLS * WIDTH * HEIGHT * 4
        view = packed.view(gy, gx, 16, 16, bl.OUT_COLS)[..., : bl.CT_COLS]
        rows.append(kernel_row(
            "untile", "gaussian_splatting_tpu/ops/untile.py:45", 0.0,
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


SECTOR = 32  # bytes the memory system moves per request


def _warp_loads(group, addr, active):
    """One load instruction per warp: ``group`` names each lane's
    (warp, instruction), ``addr`` its byte address, ``active`` whether it
    loads.  Returns (instructions issued, distinct 32-byte sectors touched)."""
    import torch

    g, a = group[active].long(), addr[active].long()
    if g.numel() == 0:
        return 0, 0
    return int(torch.unique(g).numel()), int(torch.unique(g * (1 << 40) + a // SECTOR).numel())


# csrc/expand.cu's NT (threads per block), VT (merged items per thread) and
# STAGED_ROWS (span rows staged per Gaussian)
EXPAND_NT, EXPAND_VT, EXPAND_STAGED_ROWS = 256, 2, 4


def _merge_path_loads(off, M, N, d):
    """csrc/expand.cu's ``merge_path`` for each diagonal of ``d`` (one warp,
    32 probes per step): the splits, and (warp-loads, sectors)."""
    import torch

    lo = (d - N).clamp(min=0)
    hi = d.clamp(max=M)
    lane = torch.arange(32, device=d.device)
    row = torch.arange(d.numel(), device=d.device)[:, None] * 64
    loads = [0, 0]
    step = 0
    while bool((lo < hi).any()):
        act = lo < hi
        s = (hi - lo + 31) >> 5
        j = lo[:, None] + (lane + 1) * s[:, None] - 1
        inr = act[:, None] & (j < hi[:, None])
        i, sec = _warp_loads((row + step).expand_as(j), j * 4, inr)
        loads[0] += i
        loads[1] += sec
        p = ~inr | (off[j.clamp(0, M - 1)] > (d[:, None] - 1 - j))
        anyp = p.any(dim=1)
        f = p.long().argmax(dim=1)
        lo, hi = (torch.where(act & anyp, lo + f * s, torch.where(act, hi, lo)),
                  torch.where(act & anyp, torch.minimum(lo + (f + 1) * s - 1, hi), hi))
        step += 1
    return lo, loads


def expand_work(table, ekw):
    """K1's global loads on this table, per warp-load instruction: the
    distinct sectors its lanes touch, for the per-slot search this design
    replaced (csrc/expand.cu before it: a binary search over the offsets
    per slot, then the owner's fields and its whole 16-entry span_cum row
    and one span_x0 entry) and for the block design now (a 32-probe
    merge-path search per block end, each block's window of fields staged
    with coalesced loads, and span rows past the staged ones read per
    slot)."""
    import torch

    from gaussian_splatting_torch.ops import expand as ex

    dev = table.offsets.device
    P = table.depth_key.numel()
    cap = ekw["capacity"]
    rows = ex.MAX_SPAN_ROWS
    off = table.offsets.long()
    live = (table.depth_key < ex.BIG)
    span = live & (table.span_flag != 0)
    loads = {}

    # before: one thread per slot, warps of 32 consecutive slots
    slot = torch.arange(cap, device=dev)
    warp = slot // 32
    lo = torch.zeros_like(slot)
    hi = torch.full_like(slot, P)
    n_steps = 0
    search = [0, 0]
    while bool((lo < hi).any()):
        act = lo < hi
        mid = (lo + hi + 1) >> 1
        i, sec = _warp_loads(warp * 64 + n_steps, mid * 4, act)
        search[0] += i
        search[1] += sec
        le = off[mid.clamp(max=P)] <= slot
        lo = torch.where(act & le, mid, lo)
        hi = torch.where(act & ~le, mid - 1, hi)
        n_steps += 1
    g = lo
    gc = g.clamp(max=max(P - 1, 0))
    inside = g < P
    valid = inside & live[gc] if P else inside
    sp = valid & span[gc] if P else valid
    rc = valid & ~sp
    local = slot - off[g]
    cum = table.span_cum[gc].long() if P else torch.zeros((cap, rows), device=dev)
    r = (cum <= local[:, None]).sum(dim=1)
    per = [("depth_key", gc * 4, inside), ("offsets", g * 4, valid), ("span_flag", gc * 4, valid),
           ("rect_y0", gc * 4, valid), ("rect_w", gc * 4, rc), ("rect_x0", gc * 4, rc)]
    per += [(f"span_cum[{j}]", (gc * rows + j) * 4, sp) for j in range(rows)]
    per += [("span_x0[r]", (gc * rows + r.clamp(max=rows - 1)) * 4, sp & (r < rows))]
    fields = [0, 0]
    for k, (_, a, act) in enumerate(per):
        i, sec = _warp_loads(warp * 64 + k, a, act)
        fields[0] += i
        fields[1] += sec
    loads["before"] = {"search": search, "fields and span scan": fields}

    # now: the merge path of csrc/expand.cu, blocks of NV merged items
    NT, NV, STAGED = EXPAND_NT, EXPAND_NT * EXPAND_VT, EXPAND_STAGED_ROWS
    M = P + 1
    n_blocks = -(-(cap + M) // NV)
    d = (torch.arange(n_blocks + 1, device=dev) * NV).clamp(max=cap + M)
    split, mp = _merge_path_loads(off, M, cap, d)  # the partition launch, a warp per end
    # every warp of a block loads the block's two ends
    mp = [mp[0] + 2 * n_blocks * (NT // 32), mp[1] + 2 * n_blocks * (NT // 32)]
    nw = split[1:] - split[:-1] + 1  # window Gaussians j0 - 1 .. j1 - 1 of each block
    blk = torch.repeat_interleave(torch.arange(n_blocks, device=dev), nw)
    w = torch.arange(int(nw.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(nw, 0) - nw, nw)
    gw = torch.repeat_interleave(split[:-1] - 1, nw) + w
    gwc = gw.clamp(0, max(P - 1, 0))
    grp = (blk * (NV // 32 + 1) + w // 32) * 16
    ins = (gw >= 0) & (gw < P)
    spw = ins & span[gwc] if P else ins
    stage = [(gw.clamp(min=0) * 4, gw >= 0)] + [(gwc * 4, ins)] * 5 + [(gwc * 64, spw)] * 2
    staged = [0, 0]
    for k, (a, act) in enumerate(stage):
        i, sec = _warp_loads(grp + k, a, act)
        staged[0] += i
        staged[1] += sec
    # span rows past the staged ones, per slot (threads take slots i0 + t + k NT)
    past = sp & (r >= STAGED)
    d_slot = slot + torch.searchsorted(off, slot, right=True)  # merged position of each slot
    sblk = d_slot // NV
    i0 = d[:-1] - split[:-1]
    t = slot - i0[sblk]
    pgrp = (sblk * EXPAND_VT + t // NT) * (NT // 32) + (t % NT) // 32
    tail = [0, 0]
    for j in range(STAGED, rows):
        i, sec = _warp_loads(pgrp * 64 + j, (gc * rows + j) * 4, past & (r >= j))
        tail[0] += i
        tail[1] += sec
    for name, a, act in (("base", (gc * rows + (r - 1).clamp(min=0)) * 4, past & (r > STAGED)),
                         ("x0", (gc * rows + r.clamp(max=rows - 1)) * 4, past & (r < rows))):
        i, sec = _warp_loads(pgrp * 64 + 32 + (name == "x0"), a, act)
        tail[0] += i
        tail[1] += sec
    loads["now"] = {"merge path": mp, "staging": staged, "span rows past 4": tail}
    for design, parts in loads.items():
        n_i = sum(v[0] for v in parts.values())
        n_s = sum(v[1] for v in parts.values())
        detail = "; ".join(f"{k} {v[0]} loads, {v[1]} sectors" for k, v in parts.items())
        print(f"  expand {design}: {n_i} warp-loads touching {n_s} sectors "
              f"({n_s / max(n_i, 1):.2f} per load, {n_s * SECTOR} bytes at most); {detail}")
    print(f"  expand: {int(sp.sum())} span slots, {int(past.sum())} of them past the "
          f"{STAGED} staged rows; {n_blocks} blocks, window sizes max {int(nw.max())}")
    return loads


def untile_work(packed, ukw):
    """K3's bytes on these inputs: written, the planes once; read, the
    sectors of the cropped pixels' records that hold their wanted columns,
    once per plane under the mapping this design replaced (one thread per
    output value, plane by plane; the packed block outgrows the L2, so no
    pass finds the last one's sectors) and once in all now (one thread per
    record).  The sector floor is the second read plus the writes at the
    card's peak rate; the table's bound counts only the wanted bytes."""
    import torch

    dev = packed.device
    cols, w, h = ukw["cols"], ukw["width"], ukw["height"]
    gx, tw, th = ukw["grid_x"], ukw["tile_w"], ukw["tile_h"]
    row = packed.stride(1)
    y = torch.arange(h, device=dev)[:, None]
    x = torch.arange(w, device=dev)[None, :]
    rec = (((y // th) * gx + x // tw) * (tw * th) + (y % th) * tw + x % tw).reshape(-1)
    sec = torch.stack([(rec * row + c) * 4 // SECTOR for c in range(cols)])
    old_read = sum(int(torch.unique(sec[c]).numel()) for c in range(cols)) * SECTOR
    new_read = int(torch.unique(sec).numel()) * SECTOR
    written = cols * w * h * 4
    floor_ms = (new_read + written) / PEAK_BYTES_PER_S * 1e3
    useful = 2 * written
    print(f"  untile: writes {written} B; reads {old_read} B before (one plane per pass), "
          f"{new_read} B now (each record once): {old_read + written} -> "
          f"{new_read + written} B moved; sector floor {floor_ms:.4f} ms; the bound counts "
          f"{useful} B, {useful / PEAK_BYTES_PER_S * 1e3:.4f} ms")
    return {"old_bytes": old_read + written, "new_bytes": new_read + written,
            "floor_ms": floor_ms}


# csrc/segment_reduce.cu's WINDOW (rows a warp stages at a time)
SEGREDUCE_WINDOW = 128


def segreduce_work(offsets, n_rows):
    """K6's work on these offsets, from the offsets alone: the rows, the
    segments and the longest; the warp-steps (the sum over warps of their
    longest run of rows, which sets a warp's pace) against the sum of
    lengths; and the global loads per warp-load instruction and the distinct
    32-byte sectors they touch, under the mapping this design replaced (one
    thread per Gaussian summing from global memory: at step k a warp's 10
    scalar loads take the k-th row of 32 segments) and under the warp design
    now (a warp per 32 Gaussians: its 33 offsets, then its rows in windows
    of SEGREDUCE_WINDOW, staged with 16-byte copies)."""
    import torch

    dev = offsets.device
    off = offsets.long()
    P = off.numel() - 1
    if P <= 0:
        return {}
    lo, hi = off[:-1], off[1:]
    length = hi - lo
    total = int(length.sum())
    cols = 10
    seg = torch.repeat_interleave(torch.arange(P, device=dev), length)
    k = torch.arange(total, device=dev) - torch.repeat_interleave(
        torch.cumsum(length, 0) - length, length)
    row = lo[seg] + k
    longest = int(length.max())
    warp = seg // 32

    def warp_steps(key, steps):
        """Sum over groups (``key`` per item) of the group's largest ``steps``."""
        best = torch.zeros(int(key.max()) + 1, dtype=torch.long, device=dev)
        return int(best.scatter_reduce(0, key, steps, "amax").sum())

    # before: warps of 32 consecutive Gaussians, 10 loads a step
    old_steps = warp_steps(torch.arange(P, device=dev) // 32, length)
    grp = warp * (longest + 1) + k
    old = [0, 0]
    for c in range(cols):
        i, sec = _warp_loads(grp * cols + c, row * 4 * cols + 4 * c,
                             torch.ones_like(row, dtype=torch.bool))
        old[0] += i
        old[1] += sec

    # now: a warp per 32 Gaussians, its rows [wlo, whi) in windows
    n_warps = -(-P // 32)
    wlo = off[torch.arange(n_warps, device=dev) * 32]
    whi = off[(torch.arange(n_warps, device=dev) * 32 + 32).clamp(max=P)]
    # a warp's pace: per window, the most rows one lane adds
    win = (row - wlo[warp]) // SEGREDUCE_WINDOW
    n_win = (whi - wlo + SEGREDUCE_WINDOW - 1) // SEGREDUCE_WINDOW
    max_win = int(n_win.max())
    lane_rows = torch.zeros(n_warps * max_win * 32, dtype=torch.long, device=dev)
    lane_rows.index_add_(0, (warp * max_win + win) * 32 + seg % 32, torch.ones_like(row))
    new_steps = int(lane_rows.view(-1, 32).max(dim=1).values.sum())
    # loads: each lane's offset, the broadcast end, then per window the
    # 16-byte copies from a 16-byte boundary
    ow = torch.arange(P, device=dev)
    offs = _warp_loads(ow // 32, ow * 4, torch.ones_like(ow, dtype=torch.bool))
    offs = (offs[0] + n_warps, offs[1] + n_warps)
    wk = torch.repeat_interleave(torch.arange(n_warps, device=dev), n_win)
    j = torch.arange(int(n_win.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(n_win, 0) - n_win, n_win)
    c0 = wlo[wk] + j * SEGREDUCE_WINDOW
    c1 = torch.minimum(c0 + SEGREDUCE_WINDOW, whi[wk])
    a0 = (c0 * cols) & ~3
    n4 = (c1 * cols - a0 + 3) // 4
    cw = torch.repeat_interleave(torch.arange(n4.numel(), device=dev), n4)
    q = torch.arange(int(n4.sum()), device=dev) - torch.repeat_interleave(
        torch.cumsum(n4, 0) - n4, n4)
    per_window = -(-(SEGREDUCE_WINDOW * cols + 5) // 128)  # copy instructions, at most
    staged = _warp_loads(cw * per_window + q // 32, (a0[cw] + 4 * q) * 4,
                         torch.ones_like(q, dtype=torch.bool))
    new = {"offsets": list(offs), "rows": list(staged)}
    n_i = sum(v[0] for v in new.values())
    n_s = sum(v[1] for v in new.values())
    print(f"  segment_reduce: {total} rows in {P} segments (mean {total / P:.3f}), longest "
          f"{longest}; {int((length == 0).sum())} empty; {n_rows} rows in the array")
    print(f"  segment_reduce before: {old_steps} warp-steps against {total} rows "
          f"({32 * old_steps / max(total, 1):.2f} lane-steps per row); {old[0]} warp-loads "
          f"touching {old[1]} sectors ({old[1] / max(old[0], 1):.2f} per load)")
    detail = "; ".join(f"{k} {v[0]} loads, {v[1]} sectors" for k, v in new.items())
    print(f"  segment_reduce now: {n_warps} warps, {int(n_win.sum())} windows (at most "
          f"{max_win} a warp); {new_steps} warp-steps from shared memory "
          f"({32 * new_steps / max(total, 1):.2f} lane-steps per row); {n_i} warp-loads "
          f"touching {n_s} sectors ({n_s / max(n_i, 1):.2f} per load); {detail}")
    return {"rows": total, "segments": P, "longest": longest,
            "before": {"warp_steps": old_steps, "loads": old},
            "now": {"warp_steps": new_steps, "windows": int(n_win.sum()),
                    "loads": [n_i, n_s]}}


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


def train_setup(model_dir, seed, device="cuda"):
    """The training start: the fixture model with seeded noise on means3d,
    features_dc and opacities (alive slots only), the scene extent from the
    port's get_nerfpp_norm on the 3 test cameras, and as ground truth the
    fixture model's own renders of those views."""
    import torch

    from gaussian_splatting_torch.config import ModelConfig, RasterizeConfig, load_config
    from gaussian_splatting_torch.data.dataset import get_nerfpp_norm
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.train.loop import load_raster_state
    from gaussian_splatting_torch.scene import Scene
    from gaussian_splatting_torch.train.step import StepBatch, init_train_state

    dev = torch.device(device)
    cfg = load_config(ModelConfig, os.path.join(model_dir, "cfg_args.json"))
    scene = Scene(cfg, load_iteration=-1, shuffle=False, device=dev)
    model = scene.gaussians
    cams = scene.get_test_cameras()
    raster = load_raster_state(model_dir, RasterizeConfig())
    bg = torch.zeros(3, device=dev)
    batches = []
    with torch.no_grad():
        for i, c in enumerate(cams):
            gt = render(*model.activated_params(), c.cam, bg, sh_degree=SH_DEGREE,
                        cfg=raster, inference=True).image
            h, w = gt.shape[1:]
            batches.append(StepBatch(gt, torch.ones((1, h, w), device=dev),
                                     torch.zeros((h, w), device=dev),
                                     torch.zeros((h, w), device=dev),
                                     torch.tensor(i, device=dev), bg))
        g = torch.Generator(device=dev).manual_seed(seed)
        alive = model.alive.to(torch.float32)
        for name, sigma in (("means3d", 0.002), ("features_dc", 0.2), ("opacities", 0.3)):
            p = getattr(model, name)
            noise = torch.randn(p.shape, generator=g, device=dev) * sigma
            p.add_(noise * alive.reshape((-1,) + (1,) * (p.dim() - 1)))
    model.spatial_lr_scale = get_nerfpp_norm([c.info for c in cams])["radius"]
    print(f"train start: {int(model.num_alive())} alive of {model.capacity} slots, "
          f"spatial_lr_scale {model.spatial_lr_scale:.6f}, instance_slack "
          f"{raster.instance_slack:.6f}")
    return dict(state=init_train_state(model, num_images=len(cams)), cams=cams,
                batches=batches, raster=raster, seed=seed, device=dev)


def _field_grads(setup, view, kernels, state=None, raster=None, exposure=None):
    """The first step's loss differentiated to the (P, 10) blend fields
    through the render core and the untile (all kernels, or all twins), and
    the pieces the kernel checks take apart.  ``state`` and ``raster``
    default to the setup's; ``exposure`` (3, 4) is applied to the image
    before the loss, as ``train_step`` applies it."""
    import torch

    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.losses import photometric_loss
    from gaussian_splatting_torch.ops.preprocess import clip
    from gaussian_splatting_torch.ops.rasterize import (
        _detached,
        _RasterCore,
        blend_fields,
        project,
    )
    from gaussian_splatting_torch.train.step import apply_exposure

    state = state or setup["state"]
    raster = raster or setup["raster"]
    model, cam, batch = state.model, setup["cams"][view].cam, setup["batches"][view]
    with torch.no_grad():
        proj = project(*model.activated_params(), cam, sh_degree=model.max_sh_degree,
                       cfg=raster)
    fields = blend_fields(proj).requires_grad_(True)
    gx, gy = -(-WIDTH // 16), -(-HEIGHT // 16)
    capacity = inst.required_capacity(model.capacity, raster.instance_slack)
    packed5, overflow, _ = _RasterCore.apply(fields, _detached(proj), gx, gy, 16, 16,
                                             capacity, kernels)
    img = ut.untile_differentiable(packed5, grid_x=gx, grid_y=gy, tile_w=16, tile_h=16,
                                   width=WIDTH, height=HEIGHT, kernels=kernels)
    image = clip(img[:3] + img[3][None] * batch.bg_color[:, None, None], 0.0, 1.0)
    if exposure is not None:
        image = apply_exposure(image, exposure)
    loss = photometric_loss(image, batch.gt_image, 0.2)
    (d_fields,) = torch.autograd.grad(loss, fields)
    return d_fields, proj, fields.detach(), capacity, bool(overflow)


def backward_inputs(setup, proj, fields, capacity):
    """The blend backward's inputs on the first training step (view 0): the
    layout, K2's packed output, and the loss's gradient with respect to the
    untiled image (K4 retiles it into K5's cotangent)."""
    import torch

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.losses import photometric_loss
    from gaussian_splatting_torch.ops.preprocess import clip

    gx, gy = -(-WIDTH // 16), -(-HEIGHT // 16)
    batch = setup["batches"][0]
    with torch.no_grad():
        layout = inst.build_instances(proj, grid_x=gx, grid_y=gy, capacity=capacity,
                                      grad_layout=True)
        args = (layout.sorted_owner, layout.tile_starts, layout.tile_ends, fields)
        packed = bl.blend_forward(*args, grid_x=gx)
        ukw = dict(grid_x=gx, grid_y=gy, tile_w=16, tile_h=16)
        img = ut.untile(packed, **ukw, width=WIDTH, height=HEIGHT, cols=bl.CT_COLS)
    img.requires_grad_(True)
    image = clip(img[:3] + img[3][None] * batch.bg_color[:, None, None], 0.0, 1.0)
    (d_img,) = torch.autograd.grad(photometric_loss(image, batch.gt_image, 0.2), img)
    return layout, args, packed, d_img, ukw


def train_parity(setup):
    """Each training kernel against its twin on the first step's own inputs
    (view 0 at full width), the whole field gradient against the all-twin
    path, and a small scene's gradients against the dense oracle."""
    import torch

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.rasterize import expansion_order

    phase("train parity at full width")
    d_fields, proj, fields, capacity, overflow = _field_grads(setup, 0, kernels=True)
    d_fields_p, *_ = _field_grads(setup, 0, kernels=False)
    if overflow:
        raise RuntimeError("the first training step's render overflowed")
    scale = d_fields_p.abs().amax(dim=0) + 1e-30
    err_fields = float(((d_fields - d_fields_p).abs() / scale).max())
    print(f"field gradients, kernel path vs all-twin path: max scaled diff "
          f"{err_fields:.3e} (tolerance {TOL_GRAD})")
    if not err_fields <= TOL_GRAD:
        raise RuntimeError("kernel gradients disagree with the all-twin path")

    layout, args, packed, d_img, ukw = backward_inputs(setup, proj, fields, capacity)
    gx = ukw["grid_x"]
    num_tiles = gx * ukw["grid_y"]
    with torch.no_grad():
        # K4
        ct = ut.retile(d_img, **ukw)
        torch.cuda.synchronize()
        if not torch.equal(ct, ut.retile_plain(d_img, **ukw)):
            raise RuntimeError("retile kernel disagrees with its plain version")
        print(f"retile: bitwise equal over {ct.numel()} values")

        # K3 on the step's own blend output
        ikw = dict(ukw, width=WIDTH, height=HEIGHT, cols=bl.CT_COLS)
        img = ut.untile(packed, **ikw)
        torch.cuda.synchronize()
        if not torch.equal(img, ut.untile_plain(packed, **ikw)):
            raise RuntimeError("untile kernel disagrees with its plain version")
        print(f"untile: bitwise equal over {img.numel()} values")

        # K5, into a NaN-poisoned buffer: every valid slot must be written
        n = int(layout.n_valid)
        d_sorted = torch.full((layout.sorted_owner.shape[0], bl.NUM_FIELDS), float("nan"),
                              device=ct.device)
        bl.launch_blend_backward(*args, packed, ct, gx, d_sorted)
        d_sorted_p = bl.blend_backward_plain(*args, packed, ct, grid_x=gx)
        torch.cuda.synchronize()
        if bool(d_sorted[:n].isnan().any()):
            raise RuntimeError("blend_backward left a valid slot unwritten")
        col = d_sorted_p[:n].abs().amax(dim=0) + 1e-30
        diff = (d_sorted[:n] - d_sorted_p[:n]).abs()
        err_bwd = float((diff / col).max())
        print(f"blend_backward: max scaled |kernel - plain| {err_bwd:.3e} "
              f"(tolerance {TOL_BLEND_BWD}), {int((diff == 0).sum())} of {diff.numel()} "
              f"values bitwise equal; {int(d_sorted[n:].isnan().sum())} NaN left past "
              f"n_valid {n}, removed by the select")
        if not err_bwd <= TOL_BLEND_BWD:
            raise RuntimeError("blend_backward kernel disagrees with its plain version")

        # K6 on the selected, reordered rows
        d_exp = expansion_order(d_sorted, layout)
        offsets = layout.seg_offsets
        seg = sr.segment_reduce_rows(d_exp, offsets)
        seg_p = sr.segment_reduce_rows_plain(d_exp, offsets)
        torch.cuda.synchronize()
        err_seg = float((seg - seg_p).abs().max())
        print(f"segment_reduce: max |kernel - plain| {err_seg:.3e} (summed in the same "
              f"order: bitwise expected); {int((seg == 0).all(dim=1).sum())} Gaussians "
              f"with exact-zero gradients")
        if not torch.equal(seg, seg_p):
            raise RuntimeError("segment_reduce kernel disagrees with its plain version")

        # work this run's data needs: pairs each pixel must replay (positions
        # below its NB), instances each tile must read, rows each segment sums
        starts = layout.tile_starts.long()[:, None]
        ends = layout.tile_ends.long()[:, None]
        nb = packed[..., bl.O_NB].long()
        done = nb < int(bl.NB_BIG)
        pairs = int(torch.where(done, nb - starts, ends - starts).clamp(min=0).sum())
        need = torch.where(done.all(dim=1), nb.max(dim=1).values, ends[:, 0])
        n_read = int((need - starts[:, 0]).clamp(min=0).sum())
        n_rows = int(offsets[-1] - offsets[0])
        contrib, contrib_warps = contributing_pairs(layout, fields, packed, gx)
        bwd_ops = BLEND_BWD_VISIT_OPS * pairs + BLEND_BWD_CONTRIB_OPS * contrib
        print(f"blend_backward pairs replayed {pairs}, of which contributing {contrib} "
              f"({100 * contrib / pairs:.2f}%); {bwd_ops} float operations; instances "
              f"read {n_read}; segment rows {n_rows}")
        blend_work(layout, packed, contrib_warps)
    check_small_grads_vs_oracle(setup["device"])
    return dict(d_img=d_img, ukw=ukw, args=args, packed=packed, ct=ct, gx=gx,
                num_tiles=num_tiles, n_valid=n, d_exp=d_exp, offsets=offsets, bwd_ops=bwd_ops,
                n_read=n_read, n_rows=n_rows, err_bwd=err_bwd, err_seg=err_seg)


def check_small_grads_vs_oracle(dev):
    """The kernel path's gradients against autograd through the dense
    oracle, on the render parity's small scene."""
    import torch

    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.utils.testing import random_scene

    s = random_scene(1500, sh_degree=SH_DEGREE, width=128, height=96, seed=7,
                     scale_range=(0.005, 0.04), bg=(0.1, 0.2, 0.3), device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    wimg = torch.randn((3, 96, 128), generator=g, device=dev)
    winvd = 0.1 * torch.randn((96, 128), generator=g, device=dev)

    def grads(impl):
        leaves = [t.clone().requires_grad_(True)
                  for t in (s.means3d, s.scales, s.quats, s.opacities, s.sh)]
        out = render(*leaves, s.cam, s.bg, sh_degree=SH_DEGREE, impl=impl)
        loss = (out.image * wimg).sum() + (out.invdepth * winvd).sum()
        return torch.autograd.grad(loss, leaves), bool(out.overflow)

    fast, overflow = grads("auto")
    dense, _ = grads("dense")
    errs = [float((a - b).abs().max() / (b.abs().max() + 1e-12)) for a, b in zip(fast, dense)]
    print(f"small scene (1500 Gaussians, 128x96) gradients vs dense oracle: max scaled diff "
          f"{max(errs):.3e} per input {['%.2e' % e for e in errs]} (tolerance {TOL_GRAD})")
    if overflow or not max(errs) <= TOL_GRAD:
        raise RuntimeError("kernel gradients disagree with the dense oracle")


def train_path_phase(setup):
    """The training path at full width: TRAIN_STEPS steps cycling the 3
    views, one more step of view 0 under torch.profiler, then one densify
    and one opacity reset.  Launch counts are zeroed just before and read
    just after."""
    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.config import OptimizationConfig
    from gaussian_splatting_torch.train.step import densify_step, opacity_reset_step, train_step

    phase("train path")
    opt = OptimizationConfig()
    state, cams, batches, raster = (setup[k] for k in ("state", "cams", "batches", "raster"))
    losses = {i: [] for i in range(len(cams))}

    def step(k):
        i = k % len(cams)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = train_step(state, cams[i].cam, batches[i], opt=opt, raster=raster)
        vals = m["packed"].tolist()  # synchronises
        ms = (time.perf_counter() - t0) * 1e3
        print(f"  step {k + 1:2d} view {i}: {ms:8.2f} ms wall (synchronised), loss "
              f"{vals[0]:.6f}, l1 {vals[1]:.6f}, slot demand {int(vals[4])}, "
              f"overflow {bool(vals[3])}")
        if vals[3]:
            raise RuntimeError(f"training step {k + 1} overflowed")
        losses[i].append(vals[0])
        return ms

    _kernels.reset_launches()
    times = [step(k) for k in range(TRAIN_STEPS)]
    print(f"profiled step {TRAIN_STEPS + 1} (view 0):", end=" ")
    profile_call(lambda: step(TRAIN_STEPS), _kernels.TRAIN_KERNELS)
    gen = torch.Generator(device=setup["device"]).manual_seed(setup["seed"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = densify_step(state, gen, opt=opt, max_screen_size=20)
    stats = {k: int(v) for k, v in stats.items()}
    print(f"  densify: {(time.perf_counter() - t0) * 1e3:.2f} ms wall, {stats}")
    opacity_reset_step(state)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    print(f"launches during the train path: {launches}; num_alive "
          f"{int(state.model.num_alive())}, step {int(state.step)}")
    print(f"steps 2-{TRAIN_STEPS}: mean {sum(times[1:]) / (len(times) - 1):.2f} ms wall")
    missing = [k for k in _kernels.TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the train path: {missing}")
    for i, ls in losses.items():
        if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
            raise RuntimeError(f"view {i} losses did not fall: {ls}")
        print(f"  view {i} loss {ls[0]:.6f} -> {ls[-1]:.6f} over {len(ls)} visits")
    return launches


def train_timing(tctx):
    import torch
    import torch.nn.functional as F

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import untile as ut

    phase("train timing")
    d_img, ukw, args, packed, ct = (tctx[k] for k in ("d_img", "ukw", "args", "packed", "ct"))
    gx, num_tiles, n_valid = tctx["gx"], tctx["num_tiles"], tctx["n_valid"]
    rows = []
    with torch.no_grad():
        gw, gh = ukw["grid_x"] * 16, ukw["grid_y"] * 16
        c = bl.CT_COLS
        rows.append(kernel_row(
            "retile", "gaussian_splatting_tpu/ops/untile.py:70", 0.0,
            cuda_ms(lambda: ut.retile(d_img, **ukw)),
            cuda_ms(lambda: ut.retile_plain(d_img, **ukw)),
            c * WIDTH * HEIGHT * 4 + num_tiles * 256 * c * 4, 0,
            cuda_ms(lambda: F.pad(d_img, (0, gw - WIDTH, 0, gh - HEIGHT))
                    .reshape(c, ukw["grid_y"], 16, gx, 16).permute(1, 3, 2, 4, 0).contiguous()),
        ))
        b_bytes = (tctx["n_read"] * (4 + 4 * bl.NUM_FIELDS)
                   + num_tiles * 256 * 4 * (bl.OUT_COLS + bl.CT_COLS) + n_valid * 4 * bl.NUM_FIELDS)
        rows.append(kernel_row(
            "blend_backward", "gaussian_splatting_tpu/ops/blend_pallas.py:954", tctx["err_bwd"],
            cuda_ms(lambda: bl.blend_backward(*args, packed, ct, grid_x=gx), iters=10),
            cuda_ms(lambda: bl.blend_backward_plain(*args, packed, ct, grid_x=gx),
                    iters=1, warmup=0),
            b_bytes, tctx["bwd_ops"], None,
        ))
        d_exp, offsets = tctx["d_exp"], tctx["offsets"]
        P = offsets.shape[0] - 1
        seg_ids = torch.repeat_interleave(
            torch.arange(P, device=d_exp.device), (offsets[1:] - offsets[:-1]).long())
        seg_rows = d_exp[int(offsets[0]): int(offsets[-1])]
        rows.append(kernel_row(
            "segment_reduce", "gaussian_splatting_tpu/ops/segreduce.py:202", tctx["err_seg"],
            cuda_ms(lambda: sr.segment_reduce_rows(d_exp, offsets)),
            cuda_ms(lambda: sr.segment_reduce_rows_plain(d_exp, offsets), iters=3, warmup=1),
            tctx["n_rows"] * 4 * sr.COLS + (P + 1) * 4 + P * 4 * sr.COLS, 0,
            cuda_ms(lambda: torch.zeros((P, sr.COLS), device=d_exp.device)
                    .index_add_(0, seg_ids, seg_rows)),
        ))
        # the profiler's device time per launch (it records none of the first
        # few launches it traces, so trace 50 and average those it recorded)
        for r, fn in ((rows[0], lambda: ut.retile(d_img, **ukw)),
                      (rows[2], lambda: sr.segment_reduce_rows(d_exp, offsets))):
            print(f"50 {r['name']} launches under the profiler:", end=" ")
            r["profiler_ms"] = profile_call(lambda: [fn() for _ in range(50)],
                                            (r["name"],))[r["name"]]
        segreduce_work(offsets, d_exp.shape[0])
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (profiler {r.get('profiler_ms')}, plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']}, bound {r['bound_ms']:.4f} by "
              f"{r['bound_by']})")
    return rows


def bench_phase(device="cuda", iters=10):
    """bench.py's quantity on the port: forward + backward of sum(image) +
    sum(invdepth) on bench.py's scene (500k Gaussians, SH 3, 1920x1080,
    seed 0), capacity from the measured slot demand plus 5%, as pixels/s."""
    import torch

    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.utils.testing import random_scene

    phase("bench")
    s = random_scene(NUM_GAUSSIANS, sh_degree=SH_DEGREE, width=WIDTH, height=HEIGHT, seed=0,
                     spread=2.0, scale_range=(0.0025, 0.012), cam_distance=4.0, device=device)
    args = (s.means3d, s.scales, s.quats, s.opacities, s.sh)
    with torch.no_grad():
        demand = int(inst.build_table(preprocess(*args, s.cam, sh_degree=SH_DEGREE))[1])
    capacity = -(-int(demand * 1.05) // 128) * 128
    leaves = [t.clone().requires_grad_(True) for t in args]

    def step():
        out = render(*leaves, s.cam, s.bg, sh_degree=SH_DEGREE, capacity=capacity)
        grads = torch.autograd.grad(out.image.sum() + out.invdepth.sum(), leaves)
        return grads, out.overflow

    _, overflow = step()
    step()
    torch.cuda.synchronize()
    if bool(overflow):
        raise RuntimeError("bench instance buffer overflowed")
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    print(f"slot demand {demand}, capacity {capacity}; forward + backward {dt * 1e3:.3f} ms "
          f"per iteration over {iters}: {WIDTH * HEIGHT / dt:.1f} pixels/s at "
          f"{WIDTH}x{HEIGHT} on {card()}")


def segscan_inputs(d_exp, offsets):
    """K7's inputs on a step's expansion-order gradient rows: the rows
    field-major, (10, N), flagged at each non-empty Gaussian segment's first
    slot."""
    import torch

    lo, hi = int(offsets[0]), int(offsets[-1])
    vals = d_exp[lo:hi].t().contiguous()
    first, last = offsets[:-1].long() - lo, offsets[1:].long() - lo
    flags = torch.zeros(hi - lo, device=vals.device)
    flags[first[last > first]] = 1.0
    return vals, flags


def segscan_phase(tctx, first_design_lib):
    """K7 on the train parity's own rows (``segscan_inputs``).  One launch is
    the path's; then the twin (bitwise, as int32 patterns), K6's sums at each
    segment's last slot (bitwise), the timings, and the first design's
    (``SEGSCAN_FIRST_DESIGN``, built beside the package's kernels) time on
    the same inputs, also held bitwise to the twin."""
    import ctypes

    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import segscan as ss

    phase("segscan")
    d_exp, offsets = tctx["d_exp"], tctx["offsets"]
    vals, flags = segscan_inputs(d_exp, offsets)
    n = vals.shape[1]
    lo = int(offsets[0])
    first, last = offsets[:-1].long() - lo, offsets[1:].long() - lo
    nonempty = last > first
    with torch.no_grad():
        _kernels.reset_launches()
        out = ss.segmented_cumsum(vals, flags)
        torch.cuda.synchronize()
        launches = dict(_kernels.launches)
        print(f"launches during the segscan path: {launches}")
        if launches["segscan"] != 1:
            raise RuntimeError("segscan kernel did not launch once on its path")
        plain = ss.segmented_cumsum_plain(vals, flags)
        same = torch.equal(out.view(torch.int32), plain.view(torch.int32))
        err = float((out - plain).abs().max())
        lengths = (last - first)[nonempty]
        print(f"segscan: {vals.shape[0]} x {n} values, {int(nonempty.sum())} segments "
              f"(mean {float(lengths.float().mean()):.3f}, longest {int(lengths.max())}); "
              f"bitwise equal to its twin: {same} (max |diff| {err:.3e})")
        if not same:
            raise RuntimeError("segscan kernel disagrees with its plain version")
        seg = sr.segment_reduce_rows(d_exp, offsets)
        ends = out[:, last[nonempty] - 1].t()
        same_k6 = torch.equal(ends.view(torch.int32), seg[nonempty].view(torch.int32))
        print(f"segscan at each segment's last slot vs segment_reduce: bitwise equal {same_k6}")
        if not same_k6:
            raise RuntimeError("segscan segment totals disagree with segment_reduce")
        ms = cuda_ms(lambda: ss.segmented_cumsum(vals, flags))
        plain_ms = cuda_ms(lambda: ss.segmented_cumsum_plain(vals, flags), iters=3, warmup=1)
        copy_ms = cuda_ms(vals.clone)
        print(f"segscan: {ms:.4f} ms per launch (CUDA events), plain {plain_ms:.4f} ms; "
              f"a device copy of the values (clone: the same bytes less the flags) "
              f"{copy_ms:.4f} ms")
        # the profiler records none of the first few launches it traces (none
        # around a lone launch), so trace 50 and average those it recorded
        print("50 launches under the profiler:", end=" ")
        own_ms = profile_call(lambda: [ss.segmented_cumsum(vals, flags) for _ in range(50)],
                              ("segscan",))["segscan"]

        fn = ctypes.CDLL(first_design_lib).gs_segscan
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out_first = torch.full_like(vals, float("nan"))
        stream = _kernels.current_stream(vals.device)

        def first_design():
            err = fn(vals.data_ptr(), flags.data_ptr(), n, vals.shape[0], out_first.data_ptr(),
                     stream)
            if err:
                raise RuntimeError(f"segscan first design: launch failed ({err})")

        first_design()
        torch.cuda.synchronize()
        if not torch.equal(out_first.view(torch.int32), plain.view(torch.int32)):
            raise RuntimeError("segscan first design disagrees with the plain version")
        first_ms = cuda_ms(first_design)
        print("first design, 50 launches under the profiler:", end=" ")
        first_own = profile_call(lambda: [first_design() for _ in range(50)],
                                 ("segscan",))["segscan"]
    row = kernel_row("segscan", "gaussian_splatting_tpu/ops/segscan.py:79", err, ms, plain_ms,
                     2 * vals.numel() * 4 + n * 4, 0, None)
    print(f"  segscan: {ms:.4f} ms (profiler {own_ms:.4f}, plain {plain_ms:.4f}, "
          f"library none, bound {row['bound_ms']:.4f} by {row['bound_by']}); first design "
          f"({SEGSCAN_FIRST_DESIGN}) {first_ms:.4f} ms (profiler {first_own:.4f}), "
          f"bitwise equal to the twin; {card()}")
    return launches, row


CLI_ITERATIONS = 300
CLI_RESUME_ITERATIONS = 310
CLI_PROFILED_ITERATION = 150
CLI_PSNR_GAIN_DB = 1.0
# The training views orbit at radius 20, not the fixture's 4: create_from_pcd
# gives the 500k fixture means 3-NN scales of ~0.04, and from radius 4 each
# then touches ~37 tiles at 1080p, 18.7M slots per view; with the loop's
# 2x headroom that is past the 2^24-slot instance buffer (instances.
# MAX_CAPACITY, the JAX package's limit too).  From radius 20 a view needs
# ~3.4M slots, so the buffer fits even after two capacity growths.
CLI_ORBIT_RADIUS = 20.0


def make_cli_scene(root, model_dir, device="cuda"):
    """The training CLI's Blender scene: 8 train and 2 test views on orbits
    of radius ``CLI_ORBIT_RADIUS`` about the y axis, each the port's render
    of the fixture's model, and ``points3d.ply`` with that model's means and
    DC colours."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.data.ply import save_point_cloud_ply
    from gaussian_splatting_torch.models.gaussians import load_model_ply
    from gaussian_splatting_torch.ops.camera_math import (
        focal_to_fov,
        fov_to_focal,
        look_at,
        make_camera,
    )
    from gaussian_splatting_torch.ops.sh import SH_C0
    from gaussian_splatting_torch.render import render_camera
    from gaussian_splatting_torch.train.loop import load_raster_state
    from gaussian_splatting_torch.utils.image import to_uint8, write_image

    phase("train CLI scene")
    t0 = time.perf_counter()
    scene_dir = os.path.join(root, "cli_scene")
    model = load_model_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply"),
        max_sh_degree=SH_DEGREE, device=device)
    raster = load_raster_state(model_dir, RasterizeConfig())
    bg = torch.zeros(3, device=device)
    fovx = 0.9
    fovy = focal_to_fov(fov_to_focal(fovx, WIDTH), HEIGHT)

    def frame(kind, i, angle, height):
        r = CLI_ORBIT_RADIUS
        eye = [r * math.sin(angle), height, -r * math.cos(angle)]
        R, t = look_at(eye, [0.0, 0.0, 0.0])
        cam = make_camera(R, t, fovx, fovy, WIDTH, HEIGHT, device=device)
        with torch.no_grad():
            img, _, _ = render_camera(model, SimpleNamespace(cam=cam), raster, bg)
        rel = f"{kind}/r_{i}"
        write_image(os.path.join(scene_dir, rel + ".png"),
                    to_uint8(img.cpu().numpy().transpose(1, 2, 0)))
        c2w = np.eye(4)
        c2w[:3, :3] = R
        c2w[:3, 3] = eye
        c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL axes, as Blender stores them
        return {"file_path": rel, "transform_matrix": c2w.tolist()}

    views = {"train": [(2 * math.pi * k / 8, -1.5 if k % 2 else 3.0) for k in range(8)],
             "test": [(2 * math.pi * (k + 0.5) / 8, 0.75) for k in (1, 5)]}
    for kind, poses in views.items():
        os.makedirs(os.path.join(scene_dir, kind))
        frames = [frame(kind, i, a, h) for i, (a, h) in enumerate(poses)]
        with open(os.path.join(scene_dir, f"transforms_{kind}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    n = int(model.num_alive())
    rgb = model.features_dc[:n, 0].detach().cpu().numpy() * SH_C0 + 0.5
    save_point_cloud_ply(os.path.join(scene_dir, "points3d.ply"),
                         model.means3d[:n].detach().cpu().numpy(), to_uint8(rgb))
    print(f"CLI scene in {time.perf_counter() - t0:.2f} s: 8 train + 2 test views at "
          f"{WIDTH}x{HEIGHT} on orbits of radius {CLI_ORBIT_RADIUS}, points3d.ply with {n} "
          f"points")
    return scene_dir


class LoopProbe:
    """Instruments ``train.loop`` for one CLI run, restoring it on exit:
    the host time at which each ``train_step`` is queued and the active SH
    degree it runs at, one profiled steady step with the arguments of its
    first call of each kernel wrapper (K1-K6), and the synchronised wall
    time of each boundary operation (densify, opacity reset, eval, snapshot,
    checkpoint, slack probe, capacity growth).  With ``end_after``, the run
    ends (``corpus.EndRun``) when the loop queues the step after that
    many.  At each step count in ``keep_at`` the step runs unprofiled with
    the arguments of its first call of each kernel wrapper kept in
    ``inputs``, and ``on_kept(probe, iteration)`` is called after it."""

    BOUNDARIES = ("densify_step", "opacity_reset_step", "report_psnr", "save_checkpoint",
                  "estimate_instance_slack", "grow_train_state", "gather_state", "shard_state")

    def __init__(self, profile_iteration=None, step_name="train_step", end_after=None,
                 keep_at=(), on_kept=None):
        self.profile_iteration = profile_iteration
        self.step_name = step_name
        self.end_after = end_after
        self.keep_at = set(keep_at)
        self.on_kept = on_kept
        self.packed = []  # each step's packed metrics (read after the run)
        self.starts = []
        self.first_step = None
        self.boundaries = []  # (iteration, name, ms)
        self.profiled = None
        self.profile_ms = {}  # each kernel's device ms per launch in the profiled step
        self.inputs = {}  # K1-K6 wrappers' arguments in the profiled step, by wrapper name
        self.sh_degrees = []  # each step's active SH degree

    def __enter__(self):
        import torch

        from gaussian_splatting_torch import _kernels, corpus
        from gaussian_splatting_torch.scene import Scene
        from gaussian_splatting_torch.train import loop

        self._saved = [(loop, n, getattr(loop, n))
                       for n in (self.step_name,) + self.BOUNDARIES]
        self._saved.append((Scene, "save", Scene.save))
        real_step = getattr(loop, self.step_name)

        def train_step(state, *args, **kw):
            if self.first_step is None:
                self.first_step = int(state.step)
            if len(self.starts) == self.end_after:
                raise corpus.EndRun(self.first_step + self.end_after)
            self.starts.append(time.perf_counter())
            self.sh_degrees.append(state.model.sh_degree)
            if len(self.starts) == self.profile_iteration:
                torch.cuda.synchronize()
                held = []
                print(f"profiled steady iteration {self.profile_iteration}:", end=" ")
                with KeptInputs(self.inputs):
                    self.profile_ms = profile_call(
                        lambda: held.append(real_step(state, *args, **kw)),
                        _kernels.TRAIN_KERNELS)
                self.profiled = held[0]
                self.packed.append(held[0][1]["packed"])
                return held[0]
            if len(self.starts) in self.keep_at:
                with KeptInputs(self.inputs):
                    result = real_step(state, *args, **kw)
                self.packed.append(result[1]["packed"])
                self.on_kept(self, self.first_step + len(self.starts))
                return result
            result = real_step(state, *args, **kw)
            self.packed.append(result[1]["packed"])
            return result

        def timed(name, fn):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = fn(*args, **kw)
                torch.cuda.synchronize()
                self.boundaries.append(((self.first_step or 0) + len(self.starts), name,
                                        (time.perf_counter() - t0) * 1e3))
                return result
            return wrapper

        setattr(loop, self.step_name, train_step)
        for name in self.BOUNDARIES:
            setattr(loop, name, timed(name, getattr(loop, name)))
        Scene.save = timed("snapshot", Scene.save)
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)
        return False

    def steady_ms(self, below=None):
        """Wall time of each steady iteration k (queue of step k to queue of
        step k + 1), leaving out the first epoch's uploads, the 100-iteration
        boundaries and the iteration after each, and the profiled one; with
        ``below``, only k < below."""
        p = self.profile_iteration or -10
        return [(self.starts[k] - self.starts[k - 1]) * 1e3
                for k in range(10, min(len(self.starts), below or len(self.starts)))
                if k % 100 not in (0, 1) and abs(k - p) > 1]


def train_cli_phase(root, scene_dir, seed, device="cuda"):
    """``python -m gaussian_splatting_torch.train`` in-process at full width:
    300 iterations from create_from_pcd on 500k points at 1080p (densify at
    100, 200 and 300, opacity reset at 200, eval, snapshots at 100 and 300,
    a checkpoint at 300), a resume from that checkpoint to 310, then the
    render CLI on the result.  Checks the files, the launches, the resume
    point and the test-view PSNR gain over the initial model."""
    import contextlib
    import io
    import statistics

    import torch

    from gaussian_splatting_torch import _kernels, corpus
    from gaussian_splatting_torch import render as render_cli
    from gaussian_splatting_torch.train import cli

    phase("train CLI")
    out = os.path.join(root, "cli_model")
    argv = ["-s", scene_dir, "-m", out, "-r", "1", "--eval",
            "--densify_from_iter", "50", "--densification_interval", "100",
            "--densify_until_iter", "301", "--opacity_reset_interval", "200",
            "--test_iterations", "300", "--save_iterations", "100", "300",
            "--checkpoint_iterations", "300", "--disable_viewer", "--seed", str(seed),
            "--device", device]
    kept = io.StringIO()
    tee = corpus.Tee(sys.stdout, kept)
    _kernels.reset_launches()
    with LoopProbe(CLI_PROFILED_ITERATION) as probe, contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        cli.main(argv + ["--iterations", str(CLI_ITERATIONS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    print(f"launches during the train CLI run: {launches}")
    missing = [k for k in _kernels.TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the train CLI path: {missing}")
    if len(probe.starts) != CLI_ITERATIONS or probe.first_step != 0:
        raise RuntimeError(f"expected {CLI_ITERATIONS} steps from 0, got "
                           f"{len(probe.starts)} from {probe.first_step}")
    steady = probe.steady_ms()
    print(f"{CLI_ITERATIONS} iterations in {wall:.3f} s wall; {len(steady)} steady "
          f"iterations: mean {statistics.mean(steady):.3f} ms, stdev "
          f"{statistics.stdev(steady):.3f}, median {statistics.median(steady):.3f}, "
          f"min {min(steady):.3f}, max {max(steady):.3f} ms")
    for it, name, ms in probe.boundaries:
        print(f"  boundary at iteration {it}: {name} {ms:.3f} ms wall (synchronised)")
    reports = [ln for ln in kept.getvalue().splitlines()
               if "instance_slack" in ln or "capacity" in ln or "overflow" in ln]
    print("slack and capacity changes the loop reported:")
    for ln in reports:
        print(f"  {ln.strip()}")
    if any("overflow" in ln for ln in reports):
        print("  (overflowed steps were no-ops and were taken again)")
    cli_kernel_times(probe)

    ckpt = os.path.join(out, f"chkpnt{CLI_ITERATIONS}.pth")
    with LoopProbe() as resumed:
        t0 = time.perf_counter()
        cli.main(argv + ["--iterations", str(CLI_RESUME_ITERATIONS), "--start_checkpoint", ckpt])
        torch.cuda.synchronize()
    print(f"resumed run: first step queued at iteration {resumed.first_step + 1}, "
          f"{len(resumed.starts)} steps, {time.perf_counter() - t0:.3f} s wall")
    if resumed.first_step != CLI_ITERATIONS or len(resumed.starts) != 10:
        raise RuntimeError("the resumed run did not start at iteration 301")
    expected = ["cfg_args.json", "opt_args.json", "pipe_args.json", "cameras.json", "input.ply",
                "raster_state.json", "exposure.json", os.path.basename(ckpt)] + [
        os.path.join("point_cloud", f"iteration_{it}", "point_cloud.ply")
        for it in (100, CLI_ITERATIONS, CLI_RESUME_ITERATIONS)]
    absent = [f for f in expected if not os.path.exists(os.path.join(out, f))]
    if absent:
        raise RuntimeError(f"the train CLI did not write {absent}")
    print(f"files written: {expected}")

    records = render_cli.main(["-m", out, "--skip_train", "--device", device])
    if len(records) != 2:
        raise RuntimeError(f"expected 2 rendered test views, got {len(records)}")
    for r in records:
        print(f"  render CLI view {r['index']}: {r['seconds'] * 1e3:.1f} ms wall, slot demand "
              f"{r['num_instances']}, retries {r['retries']}")
    psnr_gain(scene_dir, out, device)
    first = probe.steady_ms(below=100)
    print(f"steady iterations 10-99: mean {statistics.mean(first):.3f} ms over {len(first)}")
    return launches, {"all": statistics.mean(steady), "10-99": statistics.mean(first)}


def kernel_wrappers():
    """(module, wrapper name, launch counter name) of K1-K6; each wrapper's
    plain twin is ``<wrapper name>_plain`` in the same module."""
    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import untile as ut

    return ((ex, "expand_instances", "expand"), (bl, "blend_forward", "blend_forward"),
            (ut, "untile", "untile"), (ut, "retile", "retile"),
            (bl, "blend_backward", "blend_backward"),
            (sr, "segment_reduce_rows", "segment_reduce"))


class KeptInputs:
    """Within the block, each K1-K6 wrapper keeps the arguments of its first
    call in ``inputs`` (by wrapper name) and then runs as before."""

    def __init__(self, inputs=None):
        self.inputs = {} if inputs is None else inputs

    def __enter__(self):
        self._real = [(module, name, getattr(module, name))
                      for module, name, _ in kernel_wrappers()]
        for module, name, fn in self._real:
            setattr(module, name, self._keep(name, fn))
        return self

    def _keep(self, name, fn):
        def wrapper(*args, **kw):
            self.inputs.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return wrapper

    def __exit__(self, *exc):
        for module, name, fn in self._real:
            setattr(module, name, fn)
        return False


def kept_kernels_bitwise(inputs, what):
    """K1-K6 against their twins, bitwise, on the arguments ``inputs`` holds
    by wrapper name (``LoopProbe.inputs``, ``KeptInputs.inputs``) from
    ``what``.  K5 writes only the sorted slots that lie in a tile's range
    (below the largest tile end); the rest are compared nowhere.  Returns
    the values compared, by launch counter name."""
    import torch

    sizes = {}
    with torch.no_grad():
        for module, name, counter in kernel_wrappers():
            args, kw = inputs[name]
            got, want = (getattr(module, fn)(*args, **kw) for fn in (name, name + "_plain"))
            if name == "blend_backward":
                n = int(args[2].max())  # tile_ends
                got, want = got[:n], want[:n]
            torch.cuda.synchronize()
            pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
            if not all(torch.equal(a, b) for a, b in pairs):
                raise RuntimeError(f"{counter} disagrees with its plain version on the inputs "
                                   f"of {what}")
            sizes[counter] = sum(a.numel() for a, _ in pairs)
    return sizes


def cli_kernel_times(probe):
    """K4 and K6 on the profiled CLI iteration's own inputs: the profiler's
    device time per launch in that step, the CUDA-event time of 20 launches,
    the bound, and K6's work counts (``segreduce_work``)."""
    import torch

    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import untile as ut

    (img,), ukw = probe.inputs["retile"]
    (rows, offsets), _ = probe.inputs["segment_reduce_rows"]
    P = offsets.shape[0] - 1
    n_rows = int(offsets[-1] - offsets[0])
    with torch.no_grad():
        for name, fn, n_bytes in (
            ("retile", lambda: ut.retile(img, **ukw),
             img.numel() * 4 + ukw["grid_x"] * ukw["grid_y"] * 256 * img.shape[0] * 4),
            ("segment_reduce", lambda: sr.segment_reduce_rows(rows, offsets),
             n_rows * 4 * sr.COLS + (P + 1) * 4 + P * 4 * sr.COLS),
        ):
            print(f"  CLI iteration {probe.profile_iteration} {name}: profiler "
                  f"{probe.profile_ms.get(name, float('nan')):.4f} ms per launch in the step, "
                  f"events {cuda_ms(fn):.4f} ms, bound "
                  f"{n_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms (bytes)")
        segreduce_work(offsets, rows.shape[0])
    probe.inputs.clear()


CONFIG_STEPS = ("SH degree 4", "antialiasing", "precomputed colours and covariances",
                "sparse Adam", "exposure")
CONFIG_CLI_ITERATIONS = 110  # through the densify at 100
CONFIG_PROFILED_ITERATION = 105  # after the densify, as phase 13's 150
CONFIG_EXPOSURE_SIGMA = 0.05  # the exposure's seeded shift from the identity
CONFIG_DEADLINE_S = 420.0  # the whole phase; past it the script exits non-zero


def configurations_phase(root, model_dir, scene_dir, seed, cli_steady, device="cuda"):
    """The training switches that change what K1-K6 receive, at full width.
    (a) On the fixture's training start, one step under each of
    ``CONFIG_STEPS`` alone: the field gradients within TOL_GRAD of the
    all-twin path, then the step itself, and K1-K6 bitwise against their
    twins on the arguments the step gave them.  (b) The training CLI on the CLI scene twice,
    each with the render CLI after it: ``--sh_degree 4`` from a degree-4
    checkpoint (every step at active degree 4; a 72-column snapshot), and
    ``--antialiasing --optimizer_type sparse_adam --train_test_exp
    --random_background`` through its densify and eval.  The launches of
    the steps, the CLI runs and the render CLI runs are the phase's."""
    import threading

    import torch

    from gaussian_splatting_torch import _kernels

    phase("configurations")
    t_phase = time.perf_counter()
    watchdog = threading.Timer(CONFIG_DEADLINE_S, _past_deadline,
                               ("configurations", CONFIG_DEADLINE_S))
    watchdog.daemon = True
    watchdog.start()
    total = {name: 0 for name in _kernels.KERNELS}

    def counted(fn):
        _kernels.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        for name, n in _kernels.launches.items():
            total[name] += n
        return result

    setup = train_setup(model_dir, seed, device)
    for name in CONFIG_STEPS:
        configured_step(setup, name, seed, counted)
    del setup
    for run in ("A", "B"):
        config_cli_run(root, scene_dir, seed, run, cli_steady, counted, device)
    watchdog.cancel()
    print(f"launches during the configurations phase: {total}; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s")
    _check_launches(total, _kernels.TRAIN_KERNELS, "the configurations phase")
    return total


def model_copy(model, features_rest=None, sh_degree=None):
    """A copy of ``model``; with ``features_rest`` (its coefficients above
    the DC one) of ``sh_degree``, maximal and active."""
    from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, STAT_NAMES, GaussianModel

    t = {n: getattr(model, n).detach().clone() for n in PARAM_NAMES + ("alive",) + STAT_NAMES}
    if features_rest is not None:
        t["features_rest"] = features_rest
    degree = model.max_sh_degree if sh_degree is None else sh_degree
    return GaussianModel(**{n: t[n] for n in PARAM_NAMES}, alive=t["alive"],
                         max_sh_degree=degree, sh_degree=degree,
                         spatial_lr_scale=model.spatial_lr_scale,
                         stats={n: t[n] for n in STAT_NAMES})


def widen_to_degree_4(model, seed):
    """``model`` with 25 SH coefficients per channel at active degree 4: its
    16, then 9 drawn from ``seed`` with the spread of its degree-3 ones on
    the live slots."""
    import torch

    alive = model.alive
    rest = model.features_rest.detach()
    sigma = float(rest[alive][:, 8:15].std())  # coefficients 9..15
    g = torch.Generator(device=rest.device).manual_seed(seed)
    new = torch.randn((rest.shape[0], 9, 3), generator=g, device=rest.device) * sigma
    new = new * alive[:, None, None]
    print(f"  degree-4 coefficients drawn at sigma {sigma:.6f} (the degree-3 ones' spread)")
    return model_copy(model, torch.cat([rest, new], dim=1), sh_degree=4)


def configured_step(setup, name, seed, counted):
    """One full-width training step of view 0 under configuration ``name``
    from the setup's start: the field gradients against the all-twin path,
    then the step (counted), K1-K6 bitwise against their twins on the
    arguments the step gave them (``KeptInputs``), and the configuration's
    own checks."""
    import dataclasses

    import torch

    from gaussian_splatting_torch.config import OptimizationConfig
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.train.optim import B1
    from gaussian_splatting_torch.train.step import init_train_state, train_step

    print(f"configuration: {name}")
    t0 = time.perf_counter()
    base, dev = setup["state"].model, setup["device"]
    raster, opt, use_exposure = setup["raster"], OptimizationConfig(), False
    view, cam, batch = 0, setup["cams"][0].cam, setup["batches"][0]
    model = widen_to_degree_4(base, seed) if name == "SH degree 4" else model_copy(base)
    state = init_train_state(model, num_images=len(setup["cams"]))
    if name == "antialiasing":
        raster = dataclasses.replace(raster, antialiasing=True)
    elif name == "precomputed colours and covariances":
        raster = dataclasses.replace(raster, convert_SHs_python=True, compute_cov3D_python=True)
    elif name == "sparse Adam":
        opt = OptimizationConfig(optimizer_type="sparse_adam")
    elif name == "exposure":
        use_exposure = True
        g = torch.Generator(device=dev).manual_seed(seed)
        state.exposures += CONFIG_EXPOSURE_SIGMA * torch.randn(
            state.exposures.shape, generator=g, device=dev)
    exposure = state.exposures[view] if use_exposure else None

    if name == "SH degree 4":
        with torch.no_grad():
            img3, img4 = (render(*m.activated_params(), cam, batch.bg_color,
                                 sh_degree=m.max_sh_degree, cfg=raster, inference=True).image
                          for m in (base, model))
        change = float((img4 - img3).abs().max())
        print(f"  image at degree 4 against degree 3: max |diff| {change:.6f}")
        if not change > 0:
            raise RuntimeError("the degree-4 terms did not reach the image")

    grads = [_field_grads(setup, view, kernels, state, raster, exposure)
             for kernels in (True, False)]
    (d_fields, proj, fields, capacity, overflow), (d_fields_p, *_) = grads
    del grads
    if overflow:
        raise RuntimeError(f"{name}: the step's render overflowed")
    scale = d_fields_p.abs().amax(dim=0) + 1e-30
    err = float(((d_fields - d_fields_p).abs() / scale).max())
    print(f"  field gradients, kernel path vs all-twin path: max scaled diff {err:.3e} "
          f"(tolerance {TOL_GRAD})")
    if not err <= TOL_GRAD:
        raise RuntimeError(f"{name}: kernel gradients disagree with the all-twin path")
    before = {k: v.clone() for k, v in state.tensors().items()}
    t1 = time.perf_counter()
    with KeptInputs() as kept:
        _, m = counted(lambda: train_step(state, cam, batch, opt=opt, raster=raster,
                                          use_exposure=use_exposure))
    vals = m["packed"].tolist()
    print(f"  step: {(time.perf_counter() - t1) * 1e3:.2f} ms wall (synchronised, its "
          f"arguments kept), loss {vals[0]:.6f}, slot demand {int(vals[4])}, overflow "
          f"{bool(vals[3])}")
    if vals[3] or not math.isfinite(vals[0]):
        raise RuntimeError(f"{name}: the step overflowed or its loss is not finite")
    sizes = kept_kernels_bitwise(kept.inputs, f"the {name} step")  # after counted: not counted
    del kept
    print(f"  K1-K6 bitwise equal to their twins on the step's inputs: "
          + ", ".join(f"{k} {v} values" for k, v in sizes.items()))
    after = state.tensors()
    if name == "sparse Adam":
        hidden = proj.radii == 0
        live_hidden = int((hidden & base.alive).sum())
        moved = [k for k, v in after.items() if k.startswith("adam.") and v.dim() > 0
                 and not torch.equal(v[hidden], before[k][hidden])]
        print(f"  sparse Adam: {live_hidden} live Gaussians with radii 0; moments moved on "
              f"them: {moved or 'none'}")
        if moved or live_hidden == 0:
            raise RuntimeError("sparse Adam moved the moments of invisible Gaussians")
    if name == "exposure":
        g_exp = after["exp_adam.mu.exposures"][view] / (1.0 - B1)  # the first step's
        print(f"  exposure gradient: max |g| {float(g_exp.abs().max()):.6e}, finite "
              f"{bool(torch.isfinite(g_exp).all())}")
        if not bool(torch.isfinite(g_exp).all()) or not float(g_exp.abs().max()) > 0:
            raise RuntimeError("the exposure gradient is not finite and nonzero")
    print(f"  configuration done in {time.perf_counter() - t0:.3f} s")


def config_cli_run(root, scene_dir, seed, run, cli_steady, counted, device="cuda"):
    """Run A or B of the configurations phase: the training CLI for
    CONFIG_CLI_ITERATIONS on the CLI scene (densify at 100, eval, snapshot
    and checkpoint at the end) under ``LoopProbe``, then the render CLI on
    the test views.  A starts from a degree-4 checkpoint at iteration 0
    (``save_checkpoint`` of the scene's create_from_pcd model at degree 4,
    maximal and active) and must run every step at active degree 4 and
    snapshot 72 ``f_rest_*`` columns; B trains with --antialiasing
    --optimizer_type sparse_adam --train_test_exp --random_background."""
    import statistics

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch import render as render_cli
    from gaussian_splatting_torch.config import ModelConfig
    from gaussian_splatting_torch.scene import Scene
    from gaussian_splatting_torch.train import cli
    from gaussian_splatting_torch.train.loop import save_checkpoint
    from gaussian_splatting_torch.train.step import init_train_state

    it = CONFIG_CLI_ITERATIONS
    out = os.path.join(root, f"config_run_{run}")
    argv = ["-s", scene_dir, "-m", out, "-r", "1", "--eval",
            "--densify_from_iter", "50", "--densification_interval", "100",
            "--densify_until_iter", "301", "--opacity_reset_interval", "200",
            "--iterations", str(it), "--test_iterations", str(it), "--save_iterations", str(it),
            "--checkpoint_iterations", str(it), "--disable_viewer", "--seed", str(seed),
            "--device", device]
    if run == "A":
        ckpt = os.path.join(root, "config_start_sh4.pth")
        scene = Scene(ModelConfig(source_path=scene_dir, sh_degree=4, resolution=1, eval=True),
                      shuffle=False, device=device)
        scene.gaussians.sh_degree = 4
        save_checkpoint(ckpt, init_train_state(scene.gaussians, len(scene.get_train_cameras())),
                        0)
        del scene
        argv += ["--sh_degree", "4", "--start_checkpoint", ckpt]
        what = "--sh_degree 4 from a degree-4 checkpoint"
    else:
        argv += ["--antialiasing", "--optimizer_type", "sparse_adam", "--train_test_exp",
                 "--random_background"]
        what = "--antialiasing --optimizer_type sparse_adam --train_test_exp --random_background"
    with LoopProbe(CONFIG_PROFILED_ITERATION) as probe:
        t0 = time.perf_counter()
        counted(lambda: cli.main(argv))
        wall = time.perf_counter() - t0
    launches = dict(_kernels.launches)  # this run's, as ``counted`` left them
    cli_kernel_times(probe)  # not counted: ``counted`` resets before its next call
    losses = [float(p[0]) for p in probe.packed]
    steady, first = probe.steady_ms(), probe.steady_ms(below=100)
    print(f"run {run} ({what}): {len(probe.starts)} iterations from {probe.first_step} in "
          f"{wall:.3f} s wall (scene load included); {len(steady)} steady iterations: mean "
          f"{statistics.mean(steady):.3f} ms, stdev {statistics.stdev(steady):.3f}, median "
          f"{statistics.median(steady):.3f}; iterations 10-99 {statistics.mean(first):.3f} ms "
          f"(phase train CLI, same run: {cli_steady['all']:.3f} ms, iterations 10-99 "
          f"{cli_steady['10-99']:.3f}); loss {losses[0]:.6f} -> {losses[-1]:.6f}; launches "
          f"{launches}")
    for b_it, name, ms in probe.boundaries:
        print(f"  boundary at iteration {b_it}: {name} {ms:.3f} ms wall (synchronised)")
    if len(probe.starts) != it or probe.first_step != 0:
        raise RuntimeError(f"run {run}: {len(probe.starts)} steps from {probe.first_step}")
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"run {run}: a loss is not finite")
    names = [name for _, name, _ in probe.boundaries]
    if "densify_step" not in names or "report_psnr" not in names:
        raise RuntimeError(f"run {run} did not densify and evaluate: {names}")
    snapshot = os.path.join(out, "point_cloud", f"iteration_{it}", "point_cloud.ply")
    for f in (snapshot, os.path.join(out, f"chkpnt{it}.pth"),
              os.path.join(out, "exposure.json")):
        if not os.path.exists(f):
            raise RuntimeError(f"run {run} did not write {f}")
    if run == "A":
        degrees = sorted(set(probe.sh_degrees))
        with open(snapshot, "rb") as f:
            header = f.read(4096).split(b"end_header")[0]
        columns = header.count(b" f_rest_")
        print(f"  active SH degrees of the steps: {degrees}; the snapshot has {columns} "
              f"f_rest columns")
        if degrees != [4] or columns != 72:
            raise RuntimeError("run A did not train at degree 4 into a degree-4 snapshot")
    records = counted(lambda: render_cli.main(["-m", out, "--skip_train", "--device", device]))
    if len(records) != 2:
        raise RuntimeError(f"run {run}: expected 2 rendered test views, got {len(records)}")
    for r in records:
        print(f"  render CLI view {r['index']}: {r['seconds'] * 1e3:.1f} ms wall, slot demand "
              f"{r['num_instances']}, retries {r['retries']}")
    # A gates on a gain; B's random backgrounds train against black test views,
    # so its PSNR is only reported
    psnr_gain(scene_dir, out, device, iteration=it,
              min_gain=0.0 if run == "A" else -math.inf)


def depth_maps_phase(root, cli_scene_dir, model_dir, seed, device="cuda"):
    """The training CLI with ``-d`` on a Blender scene of 2 of the CLI
    scene's train views, each with a 16-bit depth PNG: the fixture model's
    rendered inverse depth x 512 (the Blender scale the reader divides by).
    The port's Scene loads them on the card; the CLI takes 3 iterations
    with the depth weight on.  Fails unless each step trained with depth
    and its depth term is finite and nonzero."""
    import numpy as np
    import torch
    from PIL import Image

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.data.cameras import load_camera
    from gaussian_splatting_torch.data.dataset import read_blender_scene
    from gaussian_splatting_torch.models.gaussians import load_model_ply
    from gaussian_splatting_torch.render import render_camera
    from gaussian_splatting_torch.train import cli, loop
    from gaussian_splatting_torch.train.loop import load_raster_state

    phase("depth maps")
    scene_dir = os.path.join(root, "depth_scene")
    os.makedirs(os.path.join(scene_dir, "train"))
    os.makedirs(os.path.join(scene_dir, "depths"))
    with open(os.path.join(cli_scene_dir, "transforms_train.json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][:2]
    with open(os.path.join(scene_dir, "transforms_train.json"), "w") as f:
        json.dump(meta, f)
    shutil.copy(os.path.join(cli_scene_dir, "points3d.ply"), scene_dir)
    model = load_model_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply"),
        max_sh_degree=SH_DEGREE, device=device)
    raster = load_raster_state(model_dir, RasterizeConfig())
    bg = torch.zeros(3, device=device)
    for frame in meta["frames"]:
        rel = frame["file_path"] + ".png"
        shutil.copy(os.path.join(cli_scene_dir, rel), os.path.join(scene_dir, rel))
    for info in read_blender_scene(scene_dir).train_cameras:
        cam = load_camera(info, resolution=1, device=device)
        with torch.no_grad():
            _, out, _ = render_camera(model, cam, raster, bg)
        invd = out.invdepth.cpu().numpy()
        png = np.clip(np.rint(invd * 512.0), 0, 65535).astype(np.uint16)
        Image.fromarray(png).save(
            os.path.join(scene_dir, "depths", os.path.splitext(info.image_name)[0] + ".png"))
        print(f"  {info.image_name}: inverse depth {invd.min():.5f}..{invd.max():.5f}, "
              f"16-bit map {int(png.min())}..{int(png.max())}")
    del model

    terms = []
    real_step = loop.train_step

    def train_step(state, cam, batch, **kw):
        state, metrics = real_step(state, cam, batch, **kw)
        terms.append((kw.get("use_depth"), metrics["depth_loss"], metrics["loss"]))
        return state, metrics

    out_dir = os.path.join(root, "depth_model")
    _kernels.reset_launches()
    loop.train_step = train_step
    try:
        cli.main(["-s", scene_dir, "-m", out_dir, "-d", "depths", "-r", "1", "--iterations", "3",
                  "--disable_viewer", "--quiet", "--seed", str(seed), "--device", device])
        torch.cuda.synchronize()
    finally:
        loop.train_step = real_step
    launches = dict(_kernels.launches)
    vals = [(use, float(d), float(total)) for use, d, total in terms]
    print(f"launches during the depth-map run: {launches}")
    for i, (use, d, total) in enumerate(vals):
        print(f"  iteration {i + 1}: use_depth {use}, depth term {d:.6f} of loss {total:.6f}")
    if len(vals) < 3 or not all(use and math.isfinite(d) and d > 0 for use, d, _ in vals):
        raise RuntimeError("the -d run did not train with a finite, nonzero depth term")
    return launches


# The COLMAP phase's capture: the depth maps hold the fixture model's rendered
# inverse depth d as (d - OFFSET) / SCALE at the COLMAP scale (x 65536), so
# the depth-scale fit should find SCALE.  A mean is observed at its pixel
# when its own inverse depth is within COLMAP_AGREE of d there: the fit
# divides mean absolute deviations, and at 2% the selection's own spread
# came near the means' (their depths vary by some 10% across a view at
# radius 20; a 128x96 rehearsal on the CPU fitted 0.26-0.36 for 0.5).  Then
# the training run's length, the most observations kept per view, and the
# size -r -1 gives the 1920-wide images.
COLMAP_DEPTH_SCALE, COLMAP_DEPTH_OFFSET = 0.5, 0.01
COLMAP_SCALE_TOL = 0.05
COLMAP_AGREE = 0.002
COLMAP_ITERATIONS = 30
COLMAP_OBSERVATIONS = 4000
COLMAP_SIZE = (1600, 900)


def colmap_scene_phase(root, cli_scene_dir, model_dir, seed, device="cuda"):
    """The CLI scene's 10 views as a COLMAP capture, written by the port's
    own writers: one PINHOLE camera at the CLI scene's fov; ``images.bin``
    with, per view, up to COLMAP_OBSERVATIONS of the fixture model's means
    whose own inverse depth lies within COLMAP_AGREE (0.2%, well within 2%)
    of the rendered inverse depth at their pixel, observed at that pixel's
    corner so the fit samples it exactly; ``points3D.bin`` with the 500k means and DC colours;
    ``images/`` as 1920x1080 JPEGs at quality 95; ``depths/`` as 16-bit PNGs
    of the rendered inverse depth through a known affine.  Then
    ``python -m gaussian_splatting_torch.make_depth_scale`` (each fitted scale
    within 5% of the affine's), the training CLI in-process with the default
    ``-r -1`` (the JPEGs resized to 1600x900 by the loader's C resize),
    ``-d depths --eval`` for COLMAP_ITERATIONS iterations (K1-K6 launch,
    every depth term finite and nonzero, every loaded image and depth map
    1600x900), and the render CLI on the test views."""
    import statistics
    from types import SimpleNamespace

    import numpy as np
    import torch
    from PIL import Image

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch import render as render_cli
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.data import colmap as cm
    from gaussian_splatting_torch.data.dataset import read_blender_scene
    from gaussian_splatting_torch.models.gaussians import load_model_ply
    from gaussian_splatting_torch.ops.camera_math import fov_to_focal, make_camera
    from gaussian_splatting_torch.ops.sh import SH_C0
    from gaussian_splatting_torch.render import render_camera
    from gaussian_splatting_torch.train import cli, loop
    from gaussian_splatting_torch.train.loop import load_raster_state
    from gaussian_splatting_torch.utils.image import to_uint8
    from gaussian_splatting_torch.utils.testing import write_images_binary_with_tracks

    phase("COLMAP scene")
    t0 = time.perf_counter()
    scene_dir = os.path.join(root, "colmap_scene")
    sparse = os.path.join(scene_dir, "sparse", "0")
    for d in (sparse, os.path.join(scene_dir, "images"), os.path.join(scene_dir, "depths")):
        os.makedirs(d)
    blender = read_blender_scene(cli_scene_dir)
    infos = blender.train_cameras + blender.test_cameras
    model = load_model_ply(
        os.path.join(model_dir, "point_cloud", f"iteration_{ITERATION}", "point_cloud.ply"),
        max_sh_degree=SH_DEGREE, device=device)
    raster = load_raster_state(model_dir, RasterizeConfig())
    bg = torch.zeros(3, device=device)
    n = int(model.num_alive())
    xyz = model.means3d[:n].detach().cpu().numpy().astype(np.float64)
    rgb = to_uint8(model.features_dc[:n, 0].detach().cpu().numpy() * SH_C0 + 0.5)
    fx, fy = fov_to_focal(infos[0].fovx, WIDTH), fov_to_focal(infos[0].fovy, HEIGHT)
    cams = {1: cm.ColmapCamera(1, "PINHOLE", WIDTH, HEIGHT,
                               np.array([fx, fy, WIDTH / 2, HEIGHT / 2]))}
    rng = np.random.default_rng(seed)
    images = {}
    for k, info in enumerate(infos):
        cam = make_camera(info.R, info.T, info.fovx, info.fovy, WIDTH, HEIGHT, device=device)
        with torch.no_grad():
            img, out, _ = render_camera(model, SimpleNamespace(cam=cam), raster, bg)
        name = f"view_{k:02d}"
        Image.fromarray(to_uint8(img.cpu().numpy().transpose(1, 2, 0))).save(
            os.path.join(scene_dir, "images", name + ".jpg"), quality=95)
        invd = out.invdepth.cpu().numpy().astype(np.float64)
        mono = (invd - COLMAP_DEPTH_OFFSET) / COLMAP_DEPTH_SCALE
        Image.fromarray(np.clip(np.rint(mono * 65536.0), 0, 65535).astype(np.uint16)).save(
            os.path.join(scene_dir, "depths", name + ".png"))
        w2c = np.asarray(info.R).T
        pc = xyz @ w2c.T + np.asarray(info.T)
        z = np.where(pc[:, 2] > 1e-6, pc[:, 2], np.inf)
        u, v = fx * pc[:, 0] / z + WIDTH / 2, fy * pc[:, 1] / z + HEIGHT / 2
        idx = np.flatnonzero((z < np.inf) & (u >= 0) & (u < WIDTH) & (v >= 0) & (v < HEIGHT))
        at_pixel = invd[v[idx].astype(np.int64), u[idx].astype(np.int64)]
        seen = idx[np.abs(1.0 / z[idx] - at_pixel) <= COLMAP_AGREE * at_pixel]
        obs = np.sort(rng.choice(seen, size=min(len(seen), COLMAP_OBSERVATIONS), replace=False))
        images[k + 1] = cm.ColmapImage(k + 1, cm.rotmat_to_qvec(w2c),
                                       np.asarray(info.T, np.float64), 1, name + ".jpg",
                                       np.floor(np.stack([u[obs], v[obs]], -1)),
                                       obs.astype(np.int64) + 1)
        print(f"  {name}.jpg: {len(idx)} means in view, {len(seen)} within "
              f"{COLMAP_AGREE:.1%} of the rendered inverse depth, {len(obs)} observations kept")
    cm.write_cameras_binary(os.path.join(sparse, "cameras.bin"), cams)
    write_images_binary_with_tracks(os.path.join(sparse, "images.bin"), images)
    cm.write_points3d_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    del model
    print(f"COLMAP capture in {time.perf_counter() - t0:.2f} s: {len(infos)} views at "
          f"{WIDTH}x{HEIGHT}, {n} points, depth affine scale {COLMAP_DEPTH_SCALE} offset "
          f"{COLMAP_DEPTH_OFFSET}")

    t0 = time.perf_counter()
    fit = subprocess.run([sys.executable, "-m", "gaussian_splatting_torch.make_depth_scale",
                          "--base_dir", scene_dir, "--depths_dir",
                          os.path.join(scene_dir, "depths")],
                         cwd=REPO, capture_output=True, text=True)
    if fit.returncode != 0:
        raise RuntimeError(f"make_depth_scale failed:\n{fit.stdout}\n{fit.stderr}")
    with open(os.path.join(sparse, "depth_params.json")) as f:
        params = json.load(f)
    print(f"make_depth_scale in {time.perf_counter() - t0:.2f} s: {fit.stdout.strip()}")
    for name, p in sorted(params.items()):
        print(f"  {name}: scale {p['scale']:.6f} (applied {COLMAP_DEPTH_SCALE}), offset "
              f"{p['offset']:.6f} (applied {COLMAP_DEPTH_OFFSET})")
    off = [k for k, p in params.items()
           if not abs(p["scale"] / COLMAP_DEPTH_SCALE - 1.0) <= COLMAP_SCALE_TOL]
    if len(params) != len(infos) or off:
        raise RuntimeError(f"depth-scale fits off by more than 5%: {off} of {len(params)}")

    out_dir = os.path.join(root, "colmap_model")
    terms, loaded, load_s = [], [], []
    real_scene = loop.Scene

    def scene(*args, **kw):
        t = time.perf_counter()
        s = real_scene(*args, **kw)
        load_s.append(time.perf_counter() - t)
        loaded.extend((c.image.shape, None if c.invdepth is None else c.invdepth.shape)
                      for c in s.get_train_cameras() + s.get_test_cameras())
        return s

    _kernels.reset_launches()
    with LoopProbe() as probe:
        real_step = loop.train_step

        def train_step(state, cam, batch, **kw):
            state, metrics = real_step(state, cam, batch, **kw)
            terms.append((kw.get("use_depth"), metrics["depth_loss"]))
            return state, metrics

        loop.train_step, loop.Scene = train_step, scene
        try:
            cli.main(["-s", scene_dir, "-m", out_dir, "-d", "depths", "--eval", "--iterations",
                      str(COLMAP_ITERATIONS), "--disable_viewer", "--quiet", "--seed", str(seed),
                      "--device", device])
            torch.cuda.synchronize()
        finally:
            loop.train_step, loop.Scene = real_step, real_scene
    launches = dict(_kernels.launches)
    print(f"launches during the COLMAP training run: {launches}")
    missing = [k for k in _kernels.TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the COLMAP training path: {missing}")
    w, h = COLMAP_SIZE
    shapes = sorted(set(loaded), key=str)
    print(f"scene load (COLMAP reader, {len(loaded)} JPEG decodes and resizes, depth maps, "
          f"create_from_pcd): {load_s[0]:.3f} s; loaded (image, depth) shapes {shapes}")
    if shapes != [((3, h, w), (h, w))]:
        raise RuntimeError(f"loaded images are not {w}x{h} with depth maps: {shapes}")
    steady = probe.steady_ms()
    vals = [(use, float(d)) for use, d in terms]
    print(f"{len(probe.starts)} iterations; {len(steady)} steady: mean "
          f"{statistics.mean(steady):.3f} ms, median {statistics.median(steady):.3f} ms")
    print("depth terms: " + ", ".join(f"{d:.6f}" for _, d in vals))
    if len(vals) != COLMAP_ITERATIONS or not all(use and math.isfinite(d) and d > 0
                                                 for use, d in vals):
        raise RuntimeError("the COLMAP run did not train with finite, nonzero depth terms")

    records = render_cli.main(["-m", out_dir, "--skip_train", "--device", device])
    if len(records) != 2:
        raise RuntimeError(f"expected 2 rendered test views, got {len(records)}")
    for r in records:
        with Image.open(r["path"]) as im:
            size = im.size
        print(f"  render CLI test view {r['index']}: {size[0]}x{size[1]}, "
              f"{r['seconds'] * 1e3:.1f} ms wall, retries {r['retries']}")
        if size != COLMAP_SIZE:
            raise RuntimeError(f"rendered test view is {size}, not {COLMAP_SIZE}")
    return launches


# The evaluation phase: JAX's defaults for the analytic scene, a short
# training run at that size, and the LPIPS comparison's tolerance
EVAL_SCENE = "spheres"
EVAL_SIZE = (800, 600)
EVAL_VIEWS = (100, 12)  # train, test
EVAL_ITERATIONS = 500
# With a white background the JAX loop, and so the port, resets opacities at
# densify_from_iter (500 by default) before it saves that iteration's
# snapshot, where the reference trainer saves first: the phase moves
# densify_from_iter past the run, which changes nothing else in 500
# iterations (densification starts after densify_from_iter)
EVAL_PSNR_GAIN_DB = 1.0
EVAL_DEADLINE_S = 420.0  # the whole phase; past it the script exits non-zero
EVAL_SOCKET_TIMEOUT_S = 120.0
TOL_LPIPS_REL = 1e-4
VIEWER_EQUAL_SHARE = 0.999  # frame values equal to the render CLI's PNG


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _past_deadline(what, seconds):
    print(f"chip_smoke: the {what} phase passed its {seconds:.0f} s deadline",
          file=sys.stderr, flush=True)
    os._exit(1)


def _check_launches(launches, names, what):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on {what}: {missing}")


def evaluation_phase(root, seed, device="cuda"):
    """The evaluation suite at full width on the analytic "spheres" scene
    (JAX's defaults: 800x600 from 1600x1200 rays a view, 100 train and 12
    test views, with depth maps), shaded on the card after its float32
    shader is held to the float64 one on the CPU.  The training CLI runs
    EVAL_ITERATIONS iterations in-process with the viewer on, while a client
    thread asks for test view 0 twice (without and with training); the
    trained model's viewer frames are held to the render CLI's PNG and to a
    direct render at scaling modifier 0.5; the render CLI renders iterations
    1 and EVAL_ITERATIONS; ``metrics`` scores both with LPIPS weights drawn
    from ``seed``; and LPIPS on the card is held to LPIPS on the CPU."""
    import statistics
    import threading
    from types import SimpleNamespace

    import numpy as np
    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch import metrics as metrics_cli
    from gaussian_splatting_torch import render as render_cli
    from gaussian_splatting_torch.config import (
        ModelConfig,
        PipelineConfig,
        RasterizeConfig,
        load_config,
    )
    from gaussian_splatting_torch.data.cameras import load_camera
    from gaussian_splatting_torch.data.dataset import read_blender_scene
    from gaussian_splatting_torch.ops.lpips import make_lpips
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.scene import Scene
    from gaussian_splatting_torch.train import cli
    from gaussian_splatting_torch.train.loop import load_raster_state, render_custom_cam
    from gaussian_splatting_torch.utils import synthetic_dataset as sd
    from gaussian_splatting_torch.utils.image import read_image
    from gaussian_splatting_torch.utils.testing import (
        ViewerClient,
        analytic_test_rays,
        random_lpips_weights,
        viewer_message,
    )
    from gaussian_splatting_torch.viewer.network_gui import (
        ViewerServer,
        _decode_camera,
        image_to_bytes,
        poll_viewer,
    )

    phase("evaluation")
    t_phase = time.perf_counter()
    watchdog = threading.Timer(EVAL_DEADLINE_S, _past_deadline,
                               ("evaluation", EVAL_DEADLINE_S))
    watchdog.daemon = True
    watchdog.start()
    width, height = EVAL_SIZE
    eye, d = analytic_test_rays()
    for name in sd.ANALYTIC_SCENES:
        spheres, plane = sd._analytic_scene(seed, name)
        rgb64, a64, t64 = (x.numpy() for x in sd.shade_analytic(
            torch.from_numpy(eye), torch.from_numpy(d), spheres, plane, dtype=torch.float64))
        rgb, a, t = (x.double().cpu().numpy() for x in sd.shade_analytic(
            torch.from_numpy(eye).to(device), torch.from_numpy(d).to(device), spheres, plane))
        hit = a64 > 0
        q97 = float(np.quantile(np.abs(rgb - rgb64).max(axis=1), 0.97))
        t_err = float(np.abs(t[hit] - t64[hit]).max())
        print(f"shader {name}: float32 on {device} vs float64 on the CPU, {len(d)} rays: "
              f"alpha equal {bool((a == a64).all())}, hit t max err {t_err:.3e}, rgb q97 "
              f"{q97:.3e} (JAX's tolerances: equal, 2e-3 + 2e-3 rel, < 0.02)")
        if not ((a == a64).all() and np.allclose(t[hit], t64[hit], rtol=2e-3, atol=2e-3)
                and q97 < 0.02):
            raise RuntimeError(f"the float32 shader disagrees with float64 on {name}")

    scene_dir = os.path.join(root, "analytic_scene")
    t0 = time.perf_counter()
    sd.generate_analytic_dataset(scene_dir, num_train=EVAL_VIEWS[0], num_test=EVAL_VIEWS[1],
                                 width=width, height=height, seed=seed, scene_name=EVAL_SCENE,
                                 depths=True, device=device)
    gen_s = time.perf_counter() - t0
    n_views = sum(EVAL_VIEWS)
    print(f"generation: {n_views} views of {EVAL_SCENE} at {width}x{height} (supersample 2, "
          f"{4 * width * height} rays a view, depth maps) in {gen_s:.3f} s wall, "
          f"{gen_s / n_views * 1e3:.1f} ms a view")

    info = read_blender_scene(scene_dir).test_cameras[0]
    cam = load_camera(info, resolution=1, white_background=True, is_synthetic=True,
                      device=device).cam
    port = _free_port()
    out = os.path.join(root, "analytic_model")
    served = {}

    def client():
        try:
            c = ViewerClient("127.0.0.1", port, timeout=EVAL_SOCKET_TIMEOUT_S)
            try:
                served["frames"] = [c.request(viewer_message(cam, train=train))
                                    for train in (False, True)]
            finally:
                c.close()
        except OSError as e:  # reported by the checks below
            served["error"] = repr(e)

    thread = threading.Thread(target=client, daemon=True)
    _kernels.reset_launches()
    thread.start()
    with LoopProbe() as probe:
        t0 = time.perf_counter()
        cli.main(["-s", scene_dir, "-m", out, "-w", "--eval", "--iterations",
                  str(EVAL_ITERATIONS), "--test_iterations", str(EVAL_ITERATIONS),
                  "--save_iterations", "1", str(EVAL_ITERATIONS),
                  "--densify_from_iter", str(EVAL_ITERATIONS + 1), "--ip", "127.0.0.1",
                  "--port", str(port), "--quiet", "--seed", str(seed), "--device", device])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    thread.join(timeout=EVAL_SOCKET_TIMEOUT_S)
    launches = dict(_kernels.launches)
    print(f"launches during the training run: {launches}")
    _check_launches(launches, _kernels.TRAIN_KERNELS, "the evaluation training path")
    if len(probe.starts) != EVAL_ITERATIONS or probe.first_step != 0:
        raise RuntimeError(f"expected {EVAL_ITERATIONS} steps from 0, got "
                           f"{len(probe.starts)} from {probe.first_step}")
    steady = probe.steady_ms()
    print(f"training: {EVAL_ITERATIONS} iterations in {train_s:.3f} s wall; {len(steady)} "
          f"steady iterations: mean {statistics.mean(steady):.3f} ms, median "
          f"{statistics.median(steady):.3f} ms")
    for it, name, ms in probe.boundaries:
        print(f"  boundary at iteration {it}: {name} {ms:.3f} ms wall (synchronised)")
    print("  (a traceback above, if any, is the loop dropping the client once it closed, "
          "as the JAX loop does)")
    frames = served.get("frames", [])
    n_bytes = width * height * 3
    print(f"viewer during training: {len(frames)} frames of "
          f"{[len(f or b'') for f, _ in frames]} bytes, verify strings "
          f"{sorted({v for _, v in frames})}, client error {served.get('error')}")
    if thread.is_alive() or len(frames) != 2 or any(
            f is None or len(f) != n_bytes or v != scene_dir for f, v in frames):
        raise RuntimeError("the viewer did not serve two frames of test view 0 while training")

    t0 = time.perf_counter()
    _kernels.reset_launches()
    records = []
    for it in (1, EVAL_ITERATIONS):
        records += render_cli.main(["-m", out, "--iteration", str(it), "--skip_train",
                                    "--device", device])
    render_s = time.perf_counter() - t0
    _check_launches(dict(_kernels.launches), _kernels.RENDER_KERNELS, "the render CLI")
    print(f"render CLI: iterations 1 and {EVAL_ITERATIONS}, {len(records)} test views in "
          f"{render_s:.3f} s wall")
    if len(records) != 2 * EVAL_VIEWS[1]:
        raise RuntimeError(f"expected {2 * EVAL_VIEWS[1]} rendered views, got {len(records)}")

    cfg = load_config(ModelConfig, os.path.join(out, "cfg_args.json"))
    pipe = load_config(PipelineConfig, os.path.join(out, "pipe_args.json"))
    raster = load_raster_state(out, RasterizeConfig(
        antialiasing=pipe.antialiasing, impl=pipe.rasterizer_impl,
        convert_SHs_python=pipe.convert_SHs_python,
        compute_cov3D_python=pipe.compute_cov3D_python))
    model = Scene(cfg, load_iteration=EVAL_ITERATIONS, shuffle=False, device=device).gaussians
    state = SimpleNamespace(model=model)
    bg = torch.ones(3, device=device)
    server = ViewerServer("127.0.0.1", 0, device=device)
    requests = [viewer_message(cam, train=False), viewer_message(cam, train=True,
                                                                 scaling_modifier=0.5)]
    got = []
    viewer = ViewerClient("127.0.0.1", server.listener.getsockname()[1],
                          timeout=EVAL_SOCKET_TIMEOUT_S)
    talk = threading.Thread(target=lambda: got.extend(viewer.request(m) for m in requests),
                            daemon=True)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    talk.start()
    try:
        poll_viewer(server, lambda c, sm: render_custom_cam(state, c, bg, scale_modifier=sm,
                                                            raster=raster),
                    cfg.source_path, EVAL_ITERATIONS, EVAL_ITERATIONS)
        talk.join(timeout=EVAL_SOCKET_TIMEOUT_S)
    finally:
        viewer.close()
        server.close()
    viewer_s = time.perf_counter() - t0
    _check_launches(dict(_kernels.launches), _kernels.RENDER_KERNELS, "the viewer's frames")
    if len(got) != 2 or any(f is None or len(f) != n_bytes for f, _ in got):
        raise RuntimeError("the trained model's viewer did not serve both frames")
    frame = np.frombuffer(got[0][0], np.uint8).reshape(height, width, 3).astype(int)
    png = read_image(os.path.join(out, "test", f"ours_{EVAL_ITERATIONS}", "renders",
                                  "00000.png")).astype(int)
    diff = np.abs(frame - png)
    equal = float((diff == 0).mean())
    with torch.no_grad():
        half = render(*model.activated_params(), _decode_camera(requests[1], device), bg,
                      sh_degree=model.max_sh_degree, scale_modifier=0.5, inference=True,
                      cfg=raster)
    same_half = image_to_bytes(half.image) == got[1][0]
    print(f"viewer on the trained model: 2 frames in {viewer_s:.3f} s wall; scaling 1.0 vs the "
          f"render CLI's PNG: {equal:.6f} of values equal, max diff {int(diff.max())}; scaling "
          f"0.5 vs a direct render: bitwise {same_half}")
    if equal < VIEWER_EQUAL_SHARE or diff.max() > 1 or not same_half:
        raise RuntimeError("the viewer's frames disagree with the render CLI or a direct render")

    weights = os.path.join(root, "lpips_random.npz")
    np.savez(weights, **random_lpips_weights(np.random.default_rng(seed)))
    t0 = time.perf_counter()
    metrics_cli.main(["-m", out, "--lpips_weights", weights, "--device", device])
    metrics_s = time.perf_counter() - t0
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    print(f"metrics: {EVAL_VIEWS[1]} test views x 2 methods in {metrics_s:.3f} s wall: "
          f"{json.dumps(results)}")
    print("  (LPIPS from random weights of VGG16's real shapes, drawn from --seed: it checks "
          "the computation and is no quality measure)")
    first, last = results.get("ours_1", {}), results.get(f"ours_{EVAL_ITERATIONS}", {})
    values = [r.get(k) for r in (first, last) for k in ("SSIM", "PSNR", "LPIPS")]
    if not all(isinstance(v, float) and math.isfinite(v) for v in values):
        raise RuntimeError(f"results.json lacks finite SSIM, PSNR and LPIPS: {results}")
    gain = last["PSNR"] - first["PSNR"]
    print(f"PSNR gain from iteration 1 to {EVAL_ITERATIONS}: {gain:.4f} dB "
          f"(required {EVAL_PSNR_GAIN_DB})")
    if not gain >= EVAL_PSNR_GAIN_DB:
        raise RuntimeError("training did not raise the test PSNR by 1 dB")

    pair = [read_image(os.path.join(out, "test", f"ours_{EVAL_ITERATIONS}", sub, "00000.png"))
            .astype(np.float32)[..., :3] / 255.0 for sub in ("renders", "gt")]
    on_card = make_lpips(weights, device=device)
    on_card(*pair)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_value = on_card(*pair)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu_value = make_lpips(weights, device="cpu")(*pair)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rel = abs(card_value - cpu_value) / abs(cpu_value)
    print(f"LPIPS of one {width}x{height} pair: card {card_value:.8f} ({card_ms:.1f} ms wall), "
          f"CPU {cpu_value:.8f} ({cpu_ms:.1f} ms wall, weights upload included), relative "
          f"difference {rel:.3e} (required <= {TOL_LPIPS_REL})")
    if not rel <= TOL_LPIPS_REL:
        raise RuntimeError("LPIPS on the card disagrees with the CPU")
    watchdog.cancel()
    print(f"evaluation phase: {time.perf_counter() - t_phase:.3f} s wall (generation "
          f"{gen_s:.3f}, training {train_s:.3f}, render {render_s:.3f}, viewer {viewer_s:.3f}, "
          f"metrics {metrics_s:.3f})")
    return launches


CORPUS_ITERATIONS = 1000  # the reference schedule's first evaluation
CORPUS_TIMED = "thicket"  # K4 and K6 timed on its inputs at iteration 1000
CORPUS_DEADLINE_S = 360.0  # the whole phase; past it the script exits non-zero


def corpus_phase(root, seed):
    """The quality corpus (``gaussian_splatting_torch.corpus``) at full width:
    each analytic scene (800x600, 100 train and 12 test views, 100k random
    points, ``--capacity 262144`` and its own switches) generated on the
    card and trained through ``run_scene`` on the reference's
    30,000-iteration schedule, ended after CORPUS_ITERATIONS (the
    white-background opacity reset at 500, densify at 600-1000, the first SH
    step), so that what decays over the run's length (thicket's depth-loss
    weight, glossy's exposure LR) decays as in the run JAX's numbers come
    from; the render and metrics CLIs then score the snapshot there.  The
    three scenes run at once, each in a child process (``corpus_child``):
    the loop's pace is the host's, and the card has room for all three.
    K1-K6 must launch in each scene and equal their twins bitwise on the
    arguments of iteration CORPUS_ITERATIONS, and the test PSNR there must
    reach JAX's (``results/<scene>_train.log``) less ``corpus.BOUNDS_DB``."""
    import threading

    from gaussian_splatting_torch import _kernels, corpus

    phase("corpus")
    t_phase = time.perf_counter()
    children = []

    def stop_children():
        for proc, _ in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def past_deadline():
        stop_children()
        _past_deadline("corpus", CORPUS_DEADLINE_S)

    watchdog = threading.Timer(CORPUS_DEADLINE_S, past_deadline)
    watchdog.daemon = True
    watchdog.start()
    reports, failed = {}, []
    try:
        for name in corpus.SCENES:
            out = open(os.path.join(root, f"corpus_{name}.out"), "w")
            children.append((subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
                 "--corpus-child", name, root], stdout=out, stderr=subprocess.STDOUT), out))
        for name, (proc, out) in zip(corpus.SCENES, children):
            code = proc.wait()
            out.close()
            with open(out.name) as f:
                lines = f.read().splitlines()
            print(f"scene {name}: child exit code {code}")
            for ln in lines:
                print(f"  {name} | {ln}")
            found = [ln for ln in lines if ln.startswith("CORPUS_CHILD ")]
            if code or not found:
                failed.append(name)
            else:
                reports[name] = json.loads(found[-1][len("CORPUS_CHILD "):])
    finally:
        stop_children()
        for _, out in children:
            out.close()
    watchdog.cancel()
    if failed:
        raise RuntimeError(f"the corpus scenes {failed} failed")
    total = {name: 0 for name in _kernels.KERNELS}
    bound = corpus.BOUNDS_DB[CORPUS_ITERATIONS]
    short = []
    for name, r in reports.items():
        for k, n in r["launches"].items():
            total[k] += n
        _check_launches(r["launches"], _kernels.TRAIN_KERNELS, f"the corpus scene {name}")
        print(f"{name}: test PSNR at {CORPUS_ITERATIONS} {r['psnr']} (JAX {r['ref_psnr']}, "
              f"required >= {r['ref_psnr'] - bound:.2f}); child {r['wall_s']:.3f} s wall")
        if r["psnr"] is None or not r["psnr"] >= r["ref_psnr"] - bound:
            short.append(name)
    print(f"launches during the corpus phase: {total}; phase wall "
          f"{time.perf_counter() - t_phase:.3f} s")
    if short:
        raise RuntimeError(f"test PSNR at {CORPUS_ITERATIONS} more than {bound} dB below "
                           f"JAX's on {short}")
    return total


def corpus_child(root, name, seed, device="cuda"):
    """The child of ``corpus_phase`` for scene ``name``: the scene generated
    on the card ("spheres" reuses the evaluation phase's views when ``seed``
    is the corpus's 0: the same images, its depth maps unused), trained
    under ``LoopProbe`` and scored; K1-K6 bitwise against their twins on the
    arguments of iteration CORPUS_ITERATIONS, and K4 and K6 timed on them in
    CORPUS_TIMED; then one line ``CORPUS_CHILD {json}`` with the launches of
    the run and its test PSNR beside JAX's."""
    import statistics

    import torch

    from gaussian_splatting_torch import _kernels, corpus

    t_child = time.perf_counter()
    data = os.path.join(root, f"corpus_{name}")
    reuse = os.path.join(root, "analytic_scene")
    if name == "spheres" and seed == 0 and os.path.isdir(reuse):
        data = reuse
        print(f"{name}: the evaluation phase's views (seed 0, the same generation)")
    else:
        t0 = time.perf_counter()
        corpus.generate(name, data, device=device)
        print(f"{name}: generated on {device} in {time.perf_counter() - t0:.3f} s wall")
    _kernels.reset_launches()
    with LoopProbe(CORPUS_ITERATIONS, end_after=CORPUS_ITERATIONS) as probe:
        run = corpus.run_scene(name, data, os.path.join(root, f"corpus_model_{name}"),
                               save_iterations=(CORPUS_ITERATIONS,), device=device,
                               results_dir=os.path.join(root, f"corpus_results_{name}"),
                               extra_args=("--seed", str(seed)))
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    if len(probe.starts) != CORPUS_ITERATIONS or probe.first_step != 0:
        raise RuntimeError(f"{name}: expected {CORPUS_ITERATIONS} steps from 0, got "
                           f"{len(probe.starts)} from {probe.first_step}")
    with open(os.path.join(REPO, "results", f"{name}_train.log")) as f:
        ref = corpus.trajectory(f.read())
    got = run["trajectory"]
    steady = probe.steady_ms()
    psnr, ref_psnr = got.test_psnr.get(CORPUS_ITERATIONS), ref.test_psnr[CORPUS_ITERATIONS]
    print(f"{name} at iteration {CORPUS_ITERATIONS}: test PSNR {psnr} (JAX {ref_psnr}), "
          f"Gaussians {got.gaussians(CORPUS_ITERATIONS)} (JAX "
          f"{ref.gaussians(CORPUS_ITERATIONS)}), overflow no-ops {len(got.overflows)} (JAX "
          f"{len(ref.overflows)}); training {run['train_s']:.3f} s wall, render and metrics "
          f"{run['score_s']:.3f} s; {len(steady)} steady iterations: mean "
          f"{statistics.mean(steady):.3f} ms, median {statistics.median(steady):.3f} ms (three "
          f"scenes at once); scores {json.dumps(run['results'])}; launches {launches}")
    for it, text in got.events:
        print(f"  [it {it}] {text}")
    for it, b_name, ms in probe.boundaries:
        print(f"  boundary at iteration {it}: {b_name} {ms:.3f} ms wall (synchronised)")
    # after ``launches`` was read: not counted
    sizes = kept_kernels_bitwise(probe.inputs, f"iteration {CORPUS_ITERATIONS}")
    print(f"  K1-K6 bitwise equal to their twins on iteration {CORPUS_ITERATIONS}'s "
          f"inputs: " + ", ".join(f"{k} {v} values" for k, v in sizes.items()))
    if name == CORPUS_TIMED:
        cli_kernel_times(probe)
    probe.inputs.clear()
    print("CORPUS_CHILD " + json.dumps({"scene": name, "launches": launches, "psnr": psnr,
                                        "ref_psnr": ref_psnr,
                                        "wall_s": time.perf_counter() - t_child}))


LATE_STATE = os.path.join("tests", "data", "spheres_15000_crop.npz")
LATE_STATE_CAPACITY = 4096  # slots: the fixture keeps at most 2000 Gaussians


def late_state_phase(device="cuda"):
    """The late-state fixture through one ``train_step`` on the card, at the
    snapshot's SH degree and step count: K1-K6 must launch and equal their
    twins bitwise on the step's arguments (``KeptInputs``); then the render
    of the fixture against the all-plain path (``_render(kernels=False)``):
    RGB, T and inverse depth within TOL_IMAGE, radii equal."""
    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
    from gaussian_splatting_torch.ops.rasterize import _render, project
    from gaussian_splatting_torch.train.step import StepBatch, init_train_state, train_step
    from gaussian_splatting_torch.utils.testing import (read_state_crop, slot_capacity,
                                                        state_crop_camera, state_crop_model)

    phase("late state")
    t0 = time.perf_counter()
    crop = read_state_crop(os.path.join(REPO, LATE_STATE))
    model = state_crop_model(crop, LATE_STATE_CAPACITY, device)
    cam = state_crop_camera(crop, device)
    degree = int(crop["sh_degree"])
    with torch.no_grad():
        demand = int(project(*model.activated_params(), cam, sh_degree=degree)
                     .tiles_touched.sum())
    slots = slot_capacity(demand)
    state = init_train_state(model, 1)
    state.step.fill_(int(crop["iteration"]))
    h, w = crop["gt"].shape[1:]
    bg = torch.ones(3, device=device)
    batch = StepBatch(torch.from_numpy(crop["gt"]).to(device), torch.ones((1, h, w), device=device),
                      torch.zeros((h, w), device=device), torch.zeros((h, w), device=device),
                      torch.tensor(0, device=device), bg)
    raster = RasterizeConfig(instance_slack=slots / LATE_STATE_CAPACITY)
    _kernels.reset_launches()
    with KeptInputs() as kept:
        state, metrics = train_step(state, cam, batch, opt=OptimizationConfig(), raster=raster)
        torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    print(f"fixture: {int(model.alive.sum())} Gaussians at iteration {int(crop['iteration'])}, "
          f"a {w}x{h} window, {demand} slots; step loss {float(metrics['loss']):.6f}, "
          f"overflow {bool(metrics['overflow'])}; launches {launches}")
    _check_launches(launches, _kernels.TRAIN_KERNELS, "the late state's step")
    if bool(metrics["overflow"]) or not math.isfinite(float(metrics["loss"])):
        raise RuntimeError("the late state's step overflowed or gave a non-finite loss")
    sizes = kept_kernels_bitwise(kept.inputs, "the late state's step")
    print("K1-K6 bitwise equal to their twins on the late state's step: "
          + ", ".join(f"{k} {v} values" for k, v in sizes.items()))
    fresh = state_crop_model(crop, LATE_STATE_CAPACITY, device)
    with torch.no_grad():
        got, want = (_render(*fresh.activated_params(), cam, bg, sh_degree=degree,
                             capacity=slots, kernels=k) for k in (True, False))
    torch.cuda.synchronize()
    errs = {name: float((getattr(got, name) - getattr(want, name)).abs().max())
            for name in ("image", "final_T", "invdepth")}
    print(f"render against the all-plain path: max |diff| {errs}, radii equal "
          f"{bool(torch.equal(got.radii, want.radii))}; phase {time.perf_counter() - t0:.3f} s")
    if max(errs.values()) > TOL_IMAGE or not torch.equal(got.radii, want.radii):
        raise RuntimeError("the late state's render disagrees with the all-plain path")
    return launches


MGPU_RANKS = 4  # gshard's n, emulated in one process at full width
MGPU_STEPS = 3  # of each step function at a world of one
MGPU_CLI_ITERATIONS = {"gshard": 110, "dp": 30}  # gshard through its densify at 100
MGPU_DEADLINE_S = 540.0  # the whole phase; past it the script exits non-zero
TOL_STITCH = 3e-5  # JAX tests/test_parallel.py:39
TOL_DP_LOSS_REL = 1e-6
TOL_GSHARD_LOSS_REL = 2e-4  # JAX tests/test_parallel.py:199


def multi_gpu_phase(root, model_dir, scene_dir, seed, single_steady_ms, device="cuda"):
    """gshard and dp at full width.  (1) n = MGPU_RANKS ranks of gshard
    emulated in one process on the bench scene: each stripe through K1-K6
    against the twins (forward, and the backward of sum(colour) + sum(inverse
    depth)), bitwise; the stitched image against the single render.  (2) On
    an NCCL world of one: MGPU_STEPS steps each of ``train_step``,
    ``dp_train_step`` and ``gshard_train_step`` from one state (the fixture
    model with seeded noise).  (3) The training CLI with ``--parallel gshard``
    and ``--parallel dp`` in subprocesses on the CLI scene; their launch
    counts are the phase's.  Returns those counts."""
    import threading

    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops.preprocess import clip, preprocess
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.parallel.gshard import stripe_from_records
    from gaussian_splatting_torch.utils.testing import emulated_exchange, random_scene

    phase("multi-GPU")
    t_phase = time.perf_counter()
    watchdog = threading.Timer(MGPU_DEADLINE_S, _past_deadline, ("multi-GPU", MGPU_DEADLINE_S))
    watchdog.daemon = True
    watchdog.start()
    n = MGPU_RANKS
    s = random_scene(NUM_GAUSSIANS, sh_degree=SH_DEGREE, width=WIDTH, height=HEIGHT, seed=0,
                     spread=2.0, scale_range=(0.0025, 0.012), cam_distance=4.0,
                     bg=(0.1, 0.2, 0.3), device=device)
    arrays = (s.means3d, s.scales, s.quats, s.opacities, s.sh)
    with torch.no_grad():
        proj = preprocess(*arrays, s.cam, sh_degree=SH_DEGREE)
        demand = int(inst.build_table(proj)[1])
        touched = int((proj.valid & (proj.tiles_touched > 0)).sum())
        single = render(*arrays, s.cam, s.bg, sh_degree=SH_DEGREE, inference=True,
                        capacity=-(-int(demand * 1.05) // 128) * 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        received, kw, routed, overflow = emulated_exchange(*arrays, s.cam, n=n,
                                                           sh_degree=SH_DEGREE)
        torch.cuda.synchronize()
        exchange_ms = (time.perf_counter() - t0) * 1e3
    if overflow or bool(single.overflow):
        raise RuntimeError("the emulated exchange or the single render overflowed")
    # every stripe's demand is at most the whole view's plus one sentinel a
    # received row
    kw["capacity"] = -(-(int(demand * 1.05) + received[0].shape[0] + 1024) // 512) * 512
    print(f"bench scene, {n} ranks emulated: {NUM_GAUSSIANS // n} Gaussians a shard, "
          f"{kw['grid_y_local']} tile rows a stripe, cap_x {received[0].shape[0] // n}, "
          f"stripe capacity {kw['capacity']}; projection, packing and routing of all "
          f"shards {exchange_ms:.3f} ms (synchronised)")
    into = [sum(routed[src][d] for src in range(n)) for d in range(n)]
    print(f"records routed (source x destination): {routed}; into each stripe {into}; "
          f"{sum(into)} records for {touched} Gaussians with tiles: "
          f"{100.0 * (sum(into) - touched) / touched:.2f}% cross a stripe boundary")
    stripes = []
    for d, flat in enumerate(received):
        outs = []
        for kernels in (True, False):
            leaf = flat.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            color, invd, ovf, ninst = stripe_from_records(leaf, d=d, bg_color=s.bg,
                                                          kernels=kernels, **kw)
            (grad,) = torch.autograd.grad(color.sum() + invd.sum(), leaf)
            torch.cuda.synchronize()
            outs.append((color.detach(), invd.detach(), grad, bool(ovf), int(ninst),
                         (time.perf_counter() - t0) * 1e3))
        (ck, ik, gk, ovf, ninst, ms), (cp, ip, gp, _, _, plain_ms) = outs
        same = [torch.equal(a, b) for a, b in ((ck, cp), (ik, ip), (gk, gp))]
        print(f"  stripe {d}: {into[d]} records, {ninst} instances (slots, sentinels "
              f"included); forward + backward {ms:.3f} ms through K1-K6, {plain_ms:.3f} ms "
              f"through the twins; bitwise equal: colour {same[0]}, inverse depth "
              f"{same[1]}, record gradients {same[2]}")
        if ovf or not all(same):
            raise RuntimeError(f"stripe {d} overflowed or disagrees with its twins")
        stripes.append(ck)
    image = clip(torch.cat(stripes, dim=1)[:, :HEIGHT], 0.0, 1.0)
    err = float((image - single.image).abs().max())
    print(f"stitched image vs the single render: max |diff| {err:.3e} (tolerance "
          f"{TOL_STITCH}); {card()}")
    if not err <= TOL_STITCH:
        raise RuntimeError("the stitched stripes disagree with the single render")
    del received, stripes, outs, single, proj, s, arrays
    torch.cuda.empty_cache()

    world_of_one_steps(model_dir, seed, device)

    launches = {k: 0 for k in _kernels.KERNELS}
    for mode, iterations in MGPU_CLI_ITERATIONS.items():
        remaining = MGPU_DEADLINE_S - (time.perf_counter() - t_phase) - 10.0
        report = parallel_cli(root, scene_dir, seed, mode, iterations, remaining, device)
        for k, v in report["launches"].items():
            launches[k] += v
        print(f"  steady iteration: --parallel {mode} {report['steady_mean_ms']:.3f} ms mean "
              f"(median {report['steady_median_ms']:.3f}) over {report['steady_count']}; "
              f"single-device train CLI phase {single_steady_ms:.3f} ms mean; {card()}")
    _check_launches(launches, _kernels.TRAIN_KERNELS, "the parallel CLI runs")
    print(f"launches during the parallel CLI runs: {launches}")
    watchdog.cancel()
    print(f"multi-GPU phase: {time.perf_counter() - t_phase:.3f} s wall")
    return launches


def loss_order_step(state, cam, batch, *, opt, raster):
    """The witness for gshard's step: ``train_step`` with its photometric
    loss summed in another order, L1 and SSIM as sums weighted by 1/(3HW)
    (the form gshard's stripe loss takes) instead of means.  The render,
    the backward and Adam are ``train_step``'s, so its gaps to
    ``train_step`` are those the loss's summation order alone opens."""
    import torch

    from gaussian_splatting_torch.ops.losses import absolute, fused_ssim_weighted_sum
    from gaussian_splatting_torch.ops.rasterize import render
    from gaussian_splatting_torch.train.step import apply_gradients, step_metrics

    model = state.model
    leaves = model.params()
    dev = model.means3d.device
    tap = torch.zeros((model.capacity, 2), dtype=torch.float32, device=dev, requires_grad=True)
    denom = 3.0 * cam.height * cam.width
    with torch.enable_grad():
        out = render(*model.activated_params(), cam, batch.bg_color,
                     sh_degree=model.max_sh_degree, cfg=raster, means2d_tap=tap)
        image = out.image * batch.alpha_mask
        gt = batch.gt_image * batch.alpha_mask
        weight = torch.full(image.shape[1:], 1.0 / denom, dtype=torch.float32, device=dev)
        l1 = torch.sum(absolute(image - gt)) / denom
        ssim = fused_ssim_weighted_sum(image, gt, weight)
        loss = (1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * (1.0 - ssim)
        wrt = list(leaves.values()) + [tap]
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]
    with torch.no_grad():
        apply_gradients(state, dict(zip(leaves, grads[:-1])), grads[-1], None, out.radii,
                        out.overflow, opt=opt)
        return state, step_metrics(loss.detach(), l1.detach(), torch.zeros_like(l1),
                                   out.overflow, out.num_instances, model.num_alive())


def world_of_one_steps(model_dir, seed, device="cuda"):
    """MGPU_STEPS steps each of ``train_step``, the witness
    ``loss_order_step``, ``dp_train_step`` and ``gshard_train_step`` in
    lockstep from copies of one state, on an NCCL world of one.  dp's losses
    within TOL_DP_LOSS_REL (and whether every tensor is bitwise equal),
    gshard's within TOL_GSHARD_LOSS_REL.  After every step, gshard's gaps to
    ``train_step`` in the densification statistics and the means (the
    largest |diff|, and the entries past JAX tests/test_parallel.py:202-217's
    tolerances) within WITNESS_FACTOR times the witness's.  After the first
    step, from the same parameters, also: gshard's gradients (Adam's first
    moments, 0.1 g) within TOL_GRAD scaled, its densification statistics
    within JAX's tolerances, and its means within JAX's 5e-4 wherever the
    gradient is above 1e-3 of its largest."""
    import torch

    from gaussian_splatting_torch.config import OptimizationConfig
    from gaussian_splatting_torch.parallel import collectives as coll
    from gaussian_splatting_torch.parallel.dp import dp_train_step
    from gaussian_splatting_torch.parallel.gshard import gshard_train_step, shard_state
    from gaussian_splatting_torch.parallel.mesh import init_distributed, shutdown, world_size
    from gaussian_splatting_torch.train.step import train_step

    dev = init_distributed(device)
    try:
        print(f"a world of {world_size()} on {dev} ({torch.distributed.get_backend()})")
        setup = train_setup(model_dir, seed, device)
        cams, batches, raster = setup["cams"], setup["batches"], setup["raster"]
        opt = OptimizationConfig()
        fns = {"train_step": train_step, "loss_order_step": loss_order_step,
               "dp_train_step": dp_train_step, "gshard_train_step": gshard_train_step}
        states = {name: shard_state(setup["state"], 0, 1) for name in fns}  # copies
        losses = {name: [] for name in fns}
        for k in range(MGPU_STEPS):
            i = k % len(cams)
            walls = {}
            for name, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                states[name], m = fn(states[name], cams[i].cam, batches[i], opt=opt,
                                     raster=raster)
                vals = m["packed"].tolist()
                walls[name] = (time.perf_counter() - t0) * 1e3
                if vals[3]:
                    raise RuntimeError(f"{name} step {k + 1} overflowed")
                losses[name].append(vals[0])
            print(f"  step {k + 1} (view {i}): wall "
                  f"{', '.join(f'{n} {w:.3f}' for n, w in walls.items())} ms (synchronised)")
            gaps = {name: step_gaps(states[name], states["train_step"])
                    for name in ("gshard_train_step", "loss_order_step")}
            witness_checks(k + 1, gaps["gshard_train_step"], gaps["loss_order_step"])
            if k == 0:
                first_step_checks(states["gshard_train_step"], states["train_step"],
                                  states["loss_order_step"], gaps["gshard_train_step"])
        for name, tol in (("dp_train_step", TOL_DP_LOSS_REL),
                          ("gshard_train_step", TOL_GSHARD_LOSS_REL)):
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses[name], losses["train_step"]))
            ref, got = states["train_step"].tensors(), states[name].tensors()
            bitwise = (losses[name] == losses["train_step"]
                       and all(torch.equal(got[key], ref[key]) for key in ref))
            print(f"  {name} vs train_step: losses {losses[name]} against "
                  f"{losses['train_step']}, max relative difference {rel:.3e} (tolerance "
                  f"{tol}); losses and every state tensor bitwise equal: {bitwise}")
            if not rel <= tol:
                raise RuntimeError(f"{name} disagrees with train_step")
        ref, got = states["loss_order_step"].tensors(), states["gshard_train_step"].tensors()
        print(f"  gshard_train_step vs the witness: losses {losses['loss_order_step']}, every "
              f"state tensor bitwise equal: {all(torch.equal(got[k], ref[k]) for k in ref)}")
        send = torch.randn((1, 1 << 20, 16), device=dev)
        all_to_all_ms = cuda_ms(lambda: coll.all_to_all(send))
        print(f"  all_to_all of 2^20 records of 16 floats at a world of one: "
              f"{all_to_all_ms:.4f} ms (CUDA events); {card()}")
    finally:
        shutdown()


WITNESS_FACTOR = 4  # gshard's gaps to train_step, against the witness's
GAP_TOLS = (("denom", 0.0, 1e-6), ("xyz_grad_accum", 2e-2, 1e-5),  # (key, rtol, atol):
            ("means3d", 0.0, 5e-4))  # JAX tests/test_parallel.py:202-217


def step_gaps(got_state, ref_state):
    """{key: (largest |diff|, entries past GAP_TOLS)} of two states."""
    got, ref = got_state.tensors(), ref_state.tensors()
    out = {}
    for key, rtol, atol in GAP_TOLS:
        diff = (got[key] - ref[key]).detach().abs()
        out[key] = (float(diff.max()), int((diff - rtol * ref[key].abs() > atol).sum()))
    return out


def witness_checks(step, gshard_gaps, witness_gaps):
    """gshard's gaps to ``train_step`` within WITNESS_FACTOR times the
    witness's, in the largest |diff| and in the entries past JAX's
    tolerances."""
    print(f"  step {step}: gaps to train_step, largest |diff| and entries past JAX's "
          f"tolerance, gshard | witness: " + "; ".join(
              f"{key} {gshard_gaps[key][0]:.3e}, {gshard_gaps[key][1]} | "
              f"{witness_gaps[key][0]:.3e}, {witness_gaps[key][1]}" for key, _, _ in GAP_TOLS))
    for key, _, _ in GAP_TOLS:
        for got, bound in zip(gshard_gaps[key], witness_gaps[key]):
            if not got <= WITNESS_FACTOR * bound:
                raise RuntimeError(f"step {step}: gshard's {key} is further from train_step's "
                                   f"than {WITNESS_FACTOR}x the witness's")


def first_step_checks(got_state, ref_state, witness_state, gaps):
    """The checks ``world_of_one_steps`` makes after the first step."""
    import torch

    from gaussian_splatting_torch.models.gaussians import PARAM_NAMES

    for key in ("denom", "xyz_grad_accum"):
        if gaps[key][1]:
            raise RuntimeError(f"gshard's {key} disagrees with train_step's")
    worst = 0.0
    for name in PARAM_NAMES:
        g_ref, g_got = ref_state.adam.mu[name], got_state.adam.mu[name]
        worst = max(worst, float((g_got - g_ref).abs().max() / (g_ref.abs().max() + 1e-30)))
    print(f"  step 1: gshard's gradients (Adam's first moments) vs train_step's: max "
          f"scaled diff {worst:.3e} (tolerance {TOL_GRAD})")
    if not worst <= TOL_GRAD:
        raise RuntimeError("gshard's gradients disagree with train_step's")
    g = ref_state.adam.mu["means3d"]
    flips = {name: int((torch.sign(s.adam.mu["means3d"]) != torch.sign(g)).sum())
             for name, s in (("gshard", got_state), ("witness", witness_state))}
    diff = (got_state.model.means3d - ref_state.model.means3d).detach().abs()
    solid = g.abs() > 1e-3 * g.abs().max()
    print(f"  step 1: means3d gradients whose sign differs from train_step's: gshard "
          f"{flips['gshard']}, witness {flips['witness']}; gshard's means vs train_step's: "
          f"max |diff| {float(diff[solid].max()):.3e} over {int(solid.sum())} coordinates "
          f"with solid gradients (atol 5e-4), {int((diff[~solid] > 5e-4).sum())} of the "
          f"{int((~solid).sum())} others past it")
    if not float(diff[solid].max()) <= 5e-4:
        raise RuntimeError("gshard's means disagree with train_step's")


def parallel_cli(root, scene_dir, seed, mode, iterations, timeout_s, device="cuda"):
    """``python -m gaussian_splatting_torch.train --parallel <mode>`` in a
    subprocess (``cli_child``), so its process group ends with it; checks
    the files rank 0 writes, the launches and the losses, and returns the
    child's report."""
    out = os.path.join(root, f"parallel_{mode}")
    argv = ["-s", scene_dir, "-m", out, "-r", "1", "--eval",
            "--densify_from_iter", "50", "--densification_interval", "100",
            "--densify_until_iter", "301", "--opacity_reset_interval", "200",
            "--iterations", str(iterations), "--test_iterations", str(iterations),
            "--checkpoint_iterations", str(iterations), "--disable_viewer",
            "--seed", str(seed), "--parallel", mode, "--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-child", mode,
                           "--", *argv], capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    keep = ("[parallel]", "instance_slack", "capacity", "overflow", "Evaluating", "densify",
            "boundary", "Training complete")
    print(f"--parallel {mode}, {iterations} iterations: exit code {proc.returncode}, "
          f"{wall:.3f} s wall (process start and scene load included)")
    for ln in lines:
        if any(k in ln for k in keep):
            print(f"  | {ln.strip()}")
    if proc.returncode != 0:
        raise RuntimeError(f"--parallel {mode} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    report = json.loads([ln for ln in lines if ln.startswith("CLI_CHILD ")][-1][10:])
    if report["steps"] != iterations or report["first_step"] != 0:
        raise RuntimeError(f"--parallel {mode}: {report['steps']} steps from "
                           f"{report['first_step']}")
    if not all(math.isfinite(x) for x in report["losses"]):
        raise RuntimeError(f"--parallel {mode}: a loss is not finite")
    print(f"  losses {report['losses'][0]:.6f} -> {report['losses'][-1]:.6f}, all finite; "
          f"launches {report['launches']}")
    _check_launches(report["launches"], ("expand", "blend_forward", "untile", "retile",
                                         "blend_backward", "segment_reduce"),
                    f"--parallel {mode}")
    expected = ["cfg_args.json", "opt_args.json", "pipe_args.json", "cameras.json",
                "input.ply", "raster_state.json", "exposure.json", f"chkpnt{iterations}.pth",
                os.path.join("point_cloud", f"iteration_{iterations}", "point_cloud.ply")]
    absent = [f for f in expected if not os.path.exists(os.path.join(out, f))]
    if absent:
        raise RuntimeError(f"--parallel {mode}: rank 0 did not write {absent}")
    return report


def cli_child(mode, argv):
    """The child of ``parallel_cli``: the training CLI under ``LoopProbe``,
    then one line ``CLI_CHILD {json}`` with its launches, steps, losses and
    steady iteration times."""
    import statistics

    import torch

    from gaussian_splatting_torch import _kernels
    from gaussian_splatting_torch.train import cli

    with LoopProbe(step_name=f"{mode}_train_step") as probe:
        cli.main(argv)
        torch.cuda.synchronize()
    for it, name, ms in probe.boundaries:
        print(f"boundary at iteration {it}: {name} {ms:.3f} ms wall (synchronised)")
    steady = probe.steady_ms()
    print("CLI_CHILD " + json.dumps({
        "launches": dict(_kernels.launches), "steps": len(probe.starts),
        "first_step": probe.first_step,
        "losses": [float(p[0]) for p in probe.packed],
        "steady_mean_ms": statistics.mean(steady), "steady_median_ms": statistics.median(steady),
        "steady_count": len(steady),
    }))


def psnr_gain(scene_dir, out, device="cuda", iteration=CLI_ITERATIONS,
              min_gain=CLI_PSNR_GAIN_DB):
    """Mean test-view PSNR of the ``iteration`` snapshot against that of the
    initial create_from_pcd model, both rendered against the test PNGs;
    fails unless it gained ``min_gain`` dB.  Returns both."""
    import torch

    from gaussian_splatting_torch.config import (
        ModelConfig,
        PipelineConfig,
        RasterizeConfig,
        load_config,
    )
    from gaussian_splatting_torch.data.dataset import detect_and_load_scene
    from gaussian_splatting_torch.models.gaussians import create_from_pcd
    from gaussian_splatting_torch.render import render_camera
    from gaussian_splatting_torch.scene import Scene
    from gaussian_splatting_torch.train.loop import load_raster_state
    from gaussian_splatting_torch.utils.image import psnr

    cfg = load_config(ModelConfig, os.path.join(out, "cfg_args.json"))
    snap = Scene(cfg, load_iteration=iteration, shuffle=False, device=device)
    pc = detect_and_load_scene(scene_dir).point_cloud
    init = create_from_pcd(pc.points, pc.colors, max_sh_degree=cfg.sh_degree,
                           spatial_lr_scale=snap.cameras_extent, device=device)
    pipe = load_config(PipelineConfig, os.path.join(out, "pipe_args.json"))
    raster = load_raster_state(out, RasterizeConfig(antialiasing=pipe.antialiasing))
    bg = torch.zeros(3, device=device)

    def mean_psnr(model):
        vals = []
        with torch.no_grad():
            for cam in snap.get_test_cameras():
                img, _, _ = render_camera(model, cam, raster, bg)
                vals.append(float(psnr(img, torch.from_numpy(cam.image).to(device))))
                check_expand(model, cam.cam, raster)
        return sum(vals) / len(vals), vals

    before, b_views = mean_psnr(init)
    after, a_views = mean_psnr(snap.gaussians)
    print("expand: bitwise equal to its twin on the tables of both models' test views")
    print(f"test-view PSNR: initial model {before:.4f} dB {b_views}, iteration "
          f"{iteration} snapshot {after:.4f} dB {a_views}: gain {after - before:.4f} dB "
          f"(required {min_gain})")
    if not after - before >= min_gain:
        raise RuntimeError(f"training did not raise the test-view PSNR by {min_gain} dB")
    return before, after


def check_expand(model, cam, raster):
    """K1 against its twin on one view's expansion table, at the capacity
    the render sizes for it."""
    import torch

    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops.rasterize import project

    with torch.no_grad():
        table, _ = inst.build_table(project(*model.activated_params(), cam,
                                            sh_degree=model.max_sh_degree, cfg=raster))
    cap = inst.internal_capacity(inst.required_capacity(model.capacity, raster.instance_slack))
    gx, gy = -(-cam.width // 16), -(-cam.height // 16)
    ekw = dict(capacity=cap, grid_x=gx, num_tiles=gx * gy)
    keys, owner = ex.expand_instances(table, **ekw)
    keys_p, owner_p = ex.expand_instances_plain(table, **ekw)
    if not (torch.equal(keys, keys_p) and torch.equal(owner, owner_p)):
        raise RuntimeError("expand kernel disagrees with its plain version on a CLI view")


def kernel_row(name, replaces, err, ms, plain_ms, n_bytes, n_ops, library_ms):
    """One kernel's JSON row; ``main`` adds its launches once every path
    has run."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": f"gaussian_splatting_torch/csrc/{name}.cu",
        "replaces": replaces,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def add_launches(rows, launches):
    """Each row's ``launches``: the count on the path that carries the kernel
    (render for K1-K3, train for K4-K6, segscan for K7), with every path's
    count beside it."""
    from gaussian_splatting_torch import _kernels

    for r in rows:
        name = r["name"]
        home = ("render" if name in _kernels.RENDER_KERNELS
                else "train" if name in _kernels.TRAIN_KERNELS else "segscan")
        r["launches"] = launches[home][name]
        r["launches_by_path"] = {path: counts[name] for path, counts in launches.items()}
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cli-child", choices=["dp", "gshard"], help=argparse.SUPPRESS)
    parser.add_argument("--corpus-child", nargs=2, metavar=("SCENE", "ROOT"),
                        help=argparse.SUPPRESS)
    parser.add_argument("cli_argv", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.cli_child:
        return cli_child(args.cli_child, [a for a in args.cli_argv if a != "--"])
    if args.corpus_child:
        return corpus_child(args.corpus_child[1], args.corpus_child[0], args.seed)

    kind, count = device_phase()
    segscan_first_lib = build_phase()
    root = os.path.join(REPO, "build", "chip_smoke")
    _, model_dir = make_fixture(root, args.seed)
    launches = {"render": main_path_phase(model_dir)}
    ctx = parity(model_dir)
    rows = timing(ctx)
    profile_phase(ctx)
    del ctx
    setup = train_setup(model_dir, args.seed)
    tctx = train_parity(setup)
    launches["train"] = train_path_phase(setup)
    rows += train_timing(tctx)
    del setup
    bench_phase()
    scene_dir = make_cli_scene(root, model_dir)
    launches["train CLI"], cli_steady = train_cli_phase(root, scene_dir, args.seed)
    launches["configurations"] = configurations_phase(root, model_dir, scene_dir, args.seed,
                                                      cli_steady)
    launches["depth maps"] = depth_maps_phase(root, scene_dir, model_dir, args.seed)
    launches["COLMAP scene"] = colmap_scene_phase(root, scene_dir, model_dir, args.seed)
    launches["segscan"], row = segscan_phase(tctx, segscan_first_lib)
    rows.append(row)
    del tctx
    launches["evaluation"] = evaluation_phase(root, args.seed)
    launches["corpus"] = corpus_phase(root, args.seed)
    launches["multi-GPU"] = multi_gpu_phase(root, model_dir, scene_dir, args.seed,
                                            cli_steady["all"])
    launches["late state"] = late_state_phase()
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"kernels": add_launches(rows, launches)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))

if __name__ == "__main__":
    sys.exit(main())
