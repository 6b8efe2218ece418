"""Host-side training orchestration: camera sampling, the SH ramp, the
densify / opacity-reset schedule, instance-buffer sizing, capacity growth,
evaluation, snapshots, checkpoints, and the remote viewer.

Counterpart of ``gaussian_splatting_tpu/train/loop.py``, number for number:
the same seeding, epoch camera stack, slack rules and schedule, so a run of
either package writes the same ``raster_state.json``.  The device work is
``train.step``'s; nothing here needs a compile, but the slack still moves in
JAX's quantised steps.  Step metrics are read one iteration late (step i's
``metrics["packed"]`` after step i + 1 is queued), so the host's read of
step i overlaps the card's work on step i + 1; boundary iterations drain the
queue.  An overflowed step leaves the state as it was (``train_step``'s
device-side select); the loop puts its camera back and doubles the slack.
With ``viewer_ip`` set, a viewer server (``viewer.network_gui``) is polled at
the top of every iteration and serves ``render_custom_cam`` frames.

``parallel="dp"`` or ``"gshard"`` runs the same loop on every rank of a
``torch.distributed`` world (``parallel.mesh``: ``torchrun``'s, or a world
of one).  Every rank draws the same cameras from the same seeded ``random``
and makes the same host decisions from metrics that are equal on every
rank.  DP gives rank r the r-th camera of each batch; gshard keeps every
per-Gaussian tensor sharded on its capacity axis, gathers the state at a
boundary (growth, densify, reset, eval, snapshot, checkpoint), runs it
there on every rank alike, and shards it again.  Only rank 0 writes files,
reports PSNR and serves the viewer.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import random
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    RasterizeConfig,
    save_config,
)
from gaussian_splatting_torch.data.cameras import Camera
from gaussian_splatting_torch.models.gaussians import (
    PARAM_NAMES,
    STAT_NAMES,
    GaussianModel,
    grow_capacity,
)
from gaussian_splatting_torch.ops.preprocess import preprocess
from gaussian_splatting_torch.parallel.dp import dp_train_step
from gaussian_splatting_torch.parallel.gshard import (
    default_cap_x,
    gather_state,
    gshard_train_step,
    shard_state,
)
from gaussian_splatting_torch.parallel.mesh import (
    init_distributed,
    is_main_process,
    rank,
    shutdown,
    world_size,
)
from gaussian_splatting_torch.scene import Scene
from gaussian_splatting_torch.train.optim import AdamState
from gaussian_splatting_torch.train.step import (
    StepBatch,
    TrainState,
    densify_step,
    init_train_state,
    opacity_reset_step,
    train_step,
)
from gaussian_splatting_torch.utils.image import psnr

MAX_OVERFLOW_DOUBLINGS = 4


def make_batch(camera: Camera, bg_color: np.ndarray) -> StepBatch:
    """One camera's step inputs, on the camera's device."""
    dev = camera.cam.viewmatrix.device
    h, w = camera.image.shape[1:]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    zeros = np.zeros((h, w), np.float32)
    alpha = camera.alpha_mask
    return StepBatch(
        gt_image=put(camera.image),
        alpha_mask=put(np.ones((1, h, w), np.float32) if alpha is None else alpha[None]),
        invdepth_gt=put(zeros if camera.invdepth is None else camera.invdepth),
        depth_mask=put(zeros if camera.depth_mask is None else camera.depth_mask),
        exposure_idx=torch.tensor(camera.exposure_idx, device=dev),
        bg_color=put(bg_color),
    )


def estimate_instance_slack(
    state: TrainState, cams, raster: RasterizeConfig, num_probe: int = 4,
    headroom: float = 2.0,
) -> float:
    """The slack that fits the worst of a few cameras' slot demand with
    ``headroom``.  Demand counts sentinels: a Gaussian touching no tile
    still takes one (dropped) slot."""
    model = state.model
    worst = 0
    step = max(1, len(cams) // num_probe)
    with torch.no_grad():
        params = model.activated_params()
        for cam in cams[::step][:num_probe]:
            proj = preprocess(*params, cam.cam, sh_degree=model.max_sh_degree)
            worst = max(worst, int(torch.clamp(proj.tiles_touched, min=1).sum()))
    return max(float(raster.instance_slack), headroom * worst / max(model.capacity, 1))


def save_raster_state(model_path: str, raster: RasterizeConfig, capacity: int) -> None:
    """Keep the trained slack (and the final capacity) beside the model, so
    a later render starts from it instead of overflowing its way there."""
    with open(os.path.join(model_path, "raster_state.json"), "w") as f:
        json.dump({"instance_slack": float(raster.instance_slack),
                   "capacity": int(capacity)}, f)


def load_raster_state(model_path: str, raster: RasterizeConfig) -> RasterizeConfig:
    """Raise ``instance_slack`` to the trained value in raster_state.json."""
    path = os.path.join(model_path, "raster_state.json")
    if not os.path.exists(path):
        return raster
    with open(path) as f:
        rs = json.load(f)
    slack = max(float(rs["instance_slack"]), raster.instance_slack)
    return dataclasses.replace(raster, instance_slack=slack)


def grow_train_state(state: TrainState, new_capacity: int) -> TrainState:
    """The state with the model and its Adam moments padded to
    ``new_capacity`` slots."""
    pad = new_capacity - state.model.capacity

    def grow(m):
        return torch.cat([m, m.new_zeros((pad,) + m.shape[1:])])

    adam = AdamState(count=state.adam.count,
                     mu={k: grow(v) for k, v in state.adam.mu.items()},
                     nu={k: grow(v) for k, v in state.adam.nu.items()})
    return dataclasses.replace(state, model=grow_capacity(state.model, new_capacity),
                               adam=adam)


def save_checkpoint(path: str, state: TrainState, iteration: int) -> None:
    """``torch.save`` of every state tensor, the model's static fields and
    the iteration (the reference's ``chkpnt<it>.pth``)."""
    m = state.model
    torch.save({
        "tensors": {k: v.detach() for k, v in state.tensors().items()},
        "max_sh_degree": m.max_sh_degree,
        "sh_degree": m.sh_degree,
        "spatial_lr_scale": m.spatial_lr_scale,
        "iteration": int(iteration),
    }, path)


def load_checkpoint(path: str, device=None) -> Tuple[TrainState, int]:
    """Inverse of ``save_checkpoint``; reads tensors and plain values only
    (``weights_only``)."""
    dev = resolve_device(device)
    data = torch.load(path, map_location=dev, weights_only=True)
    t = data["tensors"]
    model = GaussianModel(
        **{n: t[n] for n in PARAM_NAMES}, alive=t["alive"],
        max_sh_degree=data["max_sh_degree"], sh_degree=data["sh_degree"],
        spatial_lr_scale=data["spatial_lr_scale"], stats={n: t[n] for n in STAT_NAMES},
    )

    def adam(tag):
        mu, nu = f"{tag}.mu.", f"{tag}.nu."
        return AdamState(count=t[f"{tag}.count"],
                         mu={k[len(mu):]: v for k, v in t.items() if k.startswith(mu)},
                         nu={k[len(nu):]: v for k, v in t.items() if k.startswith(nu)})

    state = TrainState(model=model, adam=adam("adam"), exposures=t["exposures"],
                       exp_adam=adam("exp_adam"), step=t["step"])
    return state, int(data["iteration"])


def train(
    model_cfg: ModelConfig,
    opt: OptimizationConfig,
    pipe: PipelineConfig,
    *,
    test_iterations=(7_000, 30_000),
    save_iterations=(7_000, 30_000),
    checkpoint_iterations=(),
    start_checkpoint: str = "",
    seed: int = 0,
    capacity: Optional[int] = None,
    quiet: bool = False,
    on_iteration: Optional[Callable] = None,
    viewer_ip: str = "",
    viewer_port: int = 6009,
    tb_writer=None,
    debug_from: int = -1,
    parallel: str = "none",
    parallel_devices: int = 0,
    device=None,
) -> TrainState:
    """Train a model from the scene at ``model_cfg.source_path`` into
    ``model_cfg.model_path``; returns the final (whole) state.  Runs on the
    card unless ``device`` says otherwise.  ``parallel`` is "none", "dp" or
    "gshard"; ``parallel_devices`` 0 means the world's size, and any other
    value must equal it."""
    random.seed(seed)
    np.random.seed(seed)
    if parallel not in ("none", "dp", "gshard"):
        raise ValueError(f"unknown parallel mode: {parallel}")
    dev = resolve_device(device)
    n_dev, owns_group = 1, False
    if parallel != "none":
        owns_group = not torch.distributed.is_initialized()
        dev = init_distributed(dev)
        n_dev = world_size()
        if parallel_devices and parallel_devices != n_dev:
            if owns_group:
                shutdown()
            raise ValueError(f"parallel_devices={parallel_devices}, but the world has "
                             f"{n_dev} ranks")
        print(f"[parallel] {parallel} over {n_dev} ranks; rank {rank()} on {dev}")
    main = is_main_process()
    sharded = parallel == "gshard"

    def round_cap(c: int) -> int:
        # gshard splits the capacity axis equally over the ranks
        return -(-c // n_dev) * n_dev if sharded else c

    def full_capacity() -> int:
        return state.model.capacity * (n_dev if sharded else 1)

    def whole(s: TrainState) -> TrainState:
        return gather_state(s) if sharded else s

    if model_cfg.model_path and main:
        os.makedirs(model_cfg.model_path, exist_ok=True)
        cfg_path = os.path.join(model_cfg.model_path, "cfg_args.json")
        if not os.path.exists(cfg_path):
            save_config(model_cfg, cfg_path)

    scene = Scene(model_cfg, capacity=capacity, device=dev)
    train_cams = scene.get_train_cameras()
    use_depth = any(c.invdepth is not None for c in train_cams)
    raster = RasterizeConfig(
        antialiasing=pipe.antialiasing,
        impl=pipe.rasterizer_impl,
        convert_SHs_python=pipe.convert_SHs_python,
        compute_cov3D_python=pipe.compute_cov3D_python,
    )

    state = init_train_state(scene.gaussians, len(train_cams))
    first_iter = 0
    if start_checkpoint:
        state, first_iter = load_checkpoint(start_checkpoint, device=dev)
        if state.model.max_sh_degree != model_cfg.sh_degree:
            raise ValueError(f"{start_checkpoint} holds a model of SH degree "
                             f"{state.model.max_sh_degree}, not {model_cfg.sh_degree}")
        print(f"Resumed from {start_checkpoint} at iteration {first_iter}")

    # size the instance buffer from measured demand so the first steps fit
    est = estimate_instance_slack(state, train_cams, raster)
    if est > raster.instance_slack:
        print(f"[init] instance_slack {raster.instance_slack} -> {est:.1f}")
        raster = dataclasses.replace(raster, instance_slack=est)

    bg = np.array([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                  np.float32)
    if sharded:
        if state.model.capacity % n_dev:
            state = grow_train_state(state, round_cap(state.model.capacity))
        state = shard_state(state)
    xcap = 0  # gshard's records per destination stripe (0: its default)

    # device-resident batches, least recently used out past the byte budget
    batch_cache: Dict[int, StepBatch] = collections.OrderedDict()
    batch_cache_budget = int(float(os.environ.get("GS_BATCH_CACHE_GB", "1.5")) * (1 << 30))

    def batch_bytes(b: StepBatch) -> int:
        return sum(x.numel() * x.element_size() for x in b)

    def cache_batch(cam_idx, camera):
        batch = batch_cache.get(cam_idx)
        if batch is not None:
            batch_cache.move_to_end(cam_idx)
            return batch
        batch = make_batch(camera, bg)
        batch_cache[cam_idx] = batch
        total = sum(batch_bytes(b) for b in batch_cache.values())
        while len(batch_cache) > 1 and total > batch_cache_budget:
            _, old = batch_cache.popitem(last=False)
            total -= batch_bytes(old)
        return batch

    viewer = None
    if viewer_ip and main and sharded and n_dev > 1:
        print(f"Viewer not served: under gshard the model is split over {n_dev} ranks")
    elif viewer_ip and main:
        from gaussian_splatting_torch.viewer.network_gui import ViewerServer, poll_viewer

        try:
            viewer = ViewerServer(viewer_ip, viewer_port, device=dev)
        except OSError as e:
            print(f"Viewer server unavailable ({e}); continuing without GUI")

    generator = torch.Generator(device=dev).manual_seed(seed)  # densify noise
    cam_stack = []
    ema_loss = 0.0
    max_demand = 0
    overflow_discards = 0
    pending = []  # queued steps whose metrics are not read yet
    stale_ovf_cutoff = 0  # steps up to this one were queued before a growth
    last_m = np.zeros(6, np.float32)  # the newest read step's packed metrics
    t_start = time.time()

    try:
        for iteration in range(first_iter + 1, opt.iterations + 1):
            t_iter_start = time.time()
            if debug_from >= 0 and iteration == debug_from:
                print(f"[it {iteration}] enabling autograd anomaly detection")
                torch.autograd.set_detect_anomaly(True)
            if viewer is not None:
                poll_viewer(
                    viewer,
                    lambda cam, sm: render_custom_cam(state, cam, bg, scale_modifier=sm,
                                                      raster=raster),
                    model_cfg.source_path, iteration, opt.iterations,
                )
            if iteration % 1000 == 0:
                state.model.one_up_sh_degree()

            if not cam_stack:
                cam_stack = list(range(len(train_cams)))
                random.shuffle(cam_stack)
            cam_idx = cam_stack.pop()
            camera = train_cams[cam_idx]
            step_kw = dict(opt=opt, raster=raster, use_exposure=model_cfg.train_test_exp,
                           use_depth=use_depth)
            if parallel == "dp":
                # one camera per rank, all of this camera's resolution; the
                # epoch's tail samples with replacement (JAX loop.py:448-480)
                sel = dp_cameras(cam_idx, cam_stack, train_cams, n_dev)
                bgs = ([np.random.rand(3).astype(np.float32) for _ in sel]
                       if opt.random_background else None)
                mine = sel[rank()]
                batch = (make_batch(train_cams[mine], bgs[rank()]) if bgs
                         else cache_batch(mine, train_cams[mine]))
                state, metrics = dp_train_step(state, train_cams[mine].cam, batch, **step_kw)
            else:
                if opt.random_background:
                    batch = make_batch(camera, np.random.rand(3).astype(np.float32))
                else:
                    batch = cache_batch(cam_idx, camera)
                if sharded:
                    state, metrics = gshard_train_step(state, camera.cam, batch,
                                                       exchange_capacity=xcap, **step_kw)
                else:
                    state, metrics = train_step(state, camera.cam, batch, **step_kw)

            pending.append((iteration, t_iter_start, cam_idx, metrics))
            need_sync = (
                iteration % 100 == 0
                or iteration == opt.iterations
                or iteration in test_iterations
                or iteration in save_iterations
                or iteration in checkpoint_iterations
                or on_iteration is not None
                or torch.is_anomaly_enabled()
            )
            while pending and (need_sync or len(pending) > 1):
                it_i, t_i, cam_i, metrics_i = pending.pop(0)
                m = metrics_i["packed"].cpu().numpy()
                if m[3] > 0:
                    # step it_i overflowed and changed nothing: its camera goes
                    # back on the stack; grow unless this burst already grew
                    cam_stack.append(cam_i)
                    if it_i > stale_ovf_cutoff:
                        overflow_discards += 1
                        slack = raster.instance_slack * 2.0
                        print(f"[it {it_i}] instance buffer overflow — step was a "
                              f"device-side no-op; instance_slack -> {slack} "
                              f"({overflow_discards} consecutive)")
                        raster = dataclasses.replace(raster, instance_slack=slack)
                        if sharded:
                            # the flag also covers the exchange buffers:
                            # grow them beside the slack
                            pt = full_capacity()
                            xcap = min(2 * (xcap or default_cap_x(pt, n_dev)), pt // n_dev)
                        stale_ovf_cutoff = iteration
                        if overflow_discards >= MAX_OVERFLOW_DOUBLINGS:
                            raise RuntimeError(
                                "instance-buffer overflow persisted across 4 slack "
                                "doublings — aborting instead of silently losing steps. "
                                "Raise instance_slack or reduce resolution.")
                    continue
                overflow_discards = 0
                loss = float(m[0])
                ema_loss = 0.4 * loss + 0.6 * ema_loss
                last_m = m
                max_demand = max(max_demand, int(m[4]))
                if tb_writer is not None:
                    tb_writer.add_scalar("train_loss_patches/l1_loss", float(m[1]), it_i)
                    tb_writer.add_scalar("train_loss_patches/total_loss", loss, it_i)
                    tb_writer.add_scalar("total_points", int(m[5]), it_i)
                    tb_writer.add_scalar("iter_time", (time.time() - t_i) * 1000.0, it_i)

            # grow the slack at 100-iteration boundaries once demand passes 70%
            # of the buffer; shrink it every 500 when demand fell below 30%
            if iteration % 100 == 0:
                cap_now = int(raster.instance_slack * full_capacity())
                new_slack = None
                if max_demand > 0.7 * cap_now:
                    new_slack = raster.instance_slack * 1.5
                elif iteration % 500 == 0 and 0 < max_demand < 0.3 * cap_now:
                    new_slack = max(2.2 * max_demand / full_capacity(), 2.0)
                    if new_slack >= raster.instance_slack:
                        new_slack = None
                if new_slack is not None:
                    print(f"[it {iteration}] instance demand {max_demand} vs cap "
                          f"{cap_now}: instance_slack -> {new_slack:.1f}")
                    raster = dataclasses.replace(raster, instance_slack=new_slack)
                if iteration % 500 == 0:
                    max_demand = 0  # a windowed maximum, so the slack can shrink

            do_grow = iteration % 100 == 0 and int(last_m[5]) > 0.9 * full_capacity()
            do_densify = (opt.densify_from_iter < iteration < opt.densify_until_iter
                          and iteration % opt.densification_interval == 0)
            do_reset = iteration < opt.densify_until_iter and (
                iteration % opt.opacity_reset_interval == 0
                or (model_cfg.white_background and iteration == opt.densify_from_iter)
            )
            if (do_grow or do_densify or do_reset) and sharded:
                state = gather_state(state)  # densify's free slots are global
            if do_grow:
                new_cap = round_cap(int(state.model.capacity * 1.5))
                print(f"[it {iteration}] growing capacity {state.model.capacity} -> {new_cap}")
                state = grow_train_state(state, new_cap)
            if do_densify:
                limit = 20 if iteration > opt.opacity_reset_interval else 0
                state, dstats = densify_step(state, generator, opt=opt, max_screen_size=limit)
                if int(dstats["dropped"]) > 0:
                    state = grow_train_state(state, round_cap(int(state.model.capacity * 1.5)))
            if do_reset:
                state = opacity_reset_step(state)
            if do_densify:
                # re-probe demand after each densify wave, growing in 1.25x steps
                est = estimate_instance_slack(state, train_cams, raster, num_probe=2,
                                              headroom=1.5)
                if est > raster.instance_slack:
                    est = max(est, raster.instance_slack * 1.25)
                    print(f"[it {iteration}] densify re-probe: instance_slack -> {est:.1f}")
                    raster = dataclasses.replace(raster, instance_slack=est)
            if (do_grow or do_densify or do_reset) and sharded:
                state = shard_state(state)

            if not quiet and iteration % 500 == 0:
                print(f"[it {iteration}/{opt.iterations}] loss={ema_loss:.5f} "
                      f"gaussians={int(last_m[5])} inst={int(last_m[4])} "
                      f"({time.time() - t_start:.0f}s)")

            if on_iteration is not None:
                on_iteration(iteration, state, metrics)

            if (iteration in test_iterations or iteration in save_iterations
                    or iteration in checkpoint_iterations):
                full = whole(state)  # every rank takes part; rank 0 uses it
            if iteration in test_iterations and main:
                report_psnr(scene, full, raster, model_cfg, iteration, tb_writer=tb_writer,
                            first_report=iteration == min(test_iterations, default=iteration))

            if iteration in save_iterations and main:
                print(f"\n[ITER {iteration}] Saving Gaussians")
                scene.save(iteration, full.model, full.exposures)
                if model_cfg.model_path:
                    save_raster_state(model_cfg.model_path, raster, full.model.capacity)

            if iteration in checkpoint_iterations and main:
                print(f"\n[ITER {iteration}] Saving Checkpoint")
                save_checkpoint(os.path.join(model_cfg.model_path, f"chkpnt{iteration}.pth"),
                                full, iteration)
        state = whole(state)
    finally:
        if viewer is not None:
            viewer.close()
        if owns_group:
            shutdown()
    return state


def dp_cameras(cam_idx: int, cam_stack: list, train_cams, n: int) -> list:
    """The DP batch of a step: ``cam_idx`` and up to n - 1 cameras of the
    same resolution taken from the top of ``cam_stack`` (removed from it),
    then, at an epoch's tail, cameras of that resolution drawn with
    replacement from ``random``."""
    size = (train_cams[cam_idx].height, train_cams[cam_idx].width)

    def same(i):
        return (train_cams[i].height, train_cams[i].width) == size

    sel = [cam_idx]
    j = len(cam_stack) - 1
    while len(sel) < n and j >= 0:
        if same(cam_stack[j]):
            sel.append(cam_stack.pop(j))
        j -= 1
    if len(sel) < n:
        pool = [i for i in range(len(train_cams)) if same(i)]
        while len(sel) < n:
            sel.append(random.choice(pool))
    return sel


def render_camera(
    state: TrainState, camera: Camera, raster: RasterizeConfig, bg: torch.Tensor,
    use_exposure: bool = False, exposure: Optional[torch.Tensor] = None,
):
    """Eval render of one camera, with the training run's rasterizer
    settings and the overflow retry; ``exposure`` overrides the trained
    per-image affine.  Returns (image, RenderResult)."""
    from gaussian_splatting_torch.render import render_camera as render_view

    if exposure is None and use_exposure:
        exposure = state.exposures[camera.exposure_idx]
    image, out, _ = render_view(state.model, camera, raster, bg, exposure)
    return image, out



@torch.no_grad()
def render_custom_cam(state: TrainState, cam, bg, scale_modifier: float = 1.0,
                      raster: Optional[RasterizeConfig] = None) -> torch.Tensor:
    """The viewer's render of any ``CameraParams``: (3, H, W).  While the
    frame overflows the instance buffer, doubles the slack and renders
    again; past slack 512 it returns the overflowed frame instead of
    raising, since a viewer frame is only looked at."""
    from gaussian_splatting_torch.ops.rasterize import render_stored
    from gaussian_splatting_torch.render import MAX_EVAL_SLACK

    gaussians = state.model.stored()
    bg = torch.as_tensor(bg, dtype=torch.float32, device=gaussians.means3d.device)
    cfg = raster if raster is not None else RasterizeConfig()
    while True:
        out = render_stored(gaussians, cam, bg, sh_degree=state.model.max_sh_degree,
                            scale_modifier=float(scale_modifier), cfg=cfg)
        if not bool(out.overflow) or cfg.instance_slack > MAX_EVAL_SLACK:
            return out.image
        cfg = dataclasses.replace(cfg, instance_slack=cfg.instance_slack * 2.0)


@torch.no_grad()
def report_psnr(
    scene: Scene, state: TrainState, raster: RasterizeConfig, model_cfg: ModelConfig,
    iteration: int, tb_writer=None, first_report: bool = False,
) -> Dict[str, Tuple[float, float]]:
    """In-training eval of the test views and the first 5 train views:
    console L1 / PSNR, and view images, the opacity histogram and the point
    count to ``tb_writer``.  Returns {split: (mean L1, mean PSNR)}."""
    dev = state.model.means3d.device
    bg = torch.tensor([1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    results = {}
    for name, cams in (("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:5])):
        if not cams:
            continue
        psnrs, l1s = [], []
        for vi, cam in enumerate(cams):
            img, _ = render_camera(state, cam, raster, bg,
                                   use_exposure=model_cfg.train_test_exp)
            gt = torch.from_numpy(cam.image).to(dev)
            if tb_writer is not None and vi < 5:
                tb_writer.add_images(f"{name}_view_{cam.image_name}/render",
                                     np.clip(img.cpu().numpy(), 0, 1)[None],
                                     global_step=iteration)
                if first_report:
                    tb_writer.add_images(f"{name}_view_{cam.image_name}/ground_truth",
                                         np.clip(cam.image, 0, 1)[None],
                                         global_step=iteration)
            if model_cfg.train_test_exp:  # evaluate the right half
                img = img[..., img.shape[-1] // 2:]
                gt = gt[..., gt.shape[-1] // 2:]
            psnrs.append(float(psnr(img, gt)))
            l1s.append(float((img - gt).abs().mean()))
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {np.mean(l1s):.5f} "
              f"PSNR {np.mean(psnrs):.2f}")
        if tb_writer is not None:
            tb_writer.add_scalar(f"{name}/loss_viewpoint - l1_loss", np.mean(l1s), iteration)
            tb_writer.add_scalar(f"{name}/loss_viewpoint - psnr", np.mean(psnrs), iteration)
        results[name] = (float(np.mean(l1s)), float(np.mean(psnrs)))
    if tb_writer is not None:
        alive = state.model.alive
        opac = torch.sigmoid(state.model.opacities)[alive].cpu().numpy()
        tb_writer.add_histogram("scene/opacity_histogram", opac, iteration)
        tb_writer.add_scalar("total_points", int(alive.sum()), iteration)
    return results
