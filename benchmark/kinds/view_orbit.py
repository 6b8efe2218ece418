"""Traffic kind ``view_orbit``: one client renders views on a ring through
the scene, each through ``render.render_camera`` and waited for, then asks
for the next.  The model is built from the seed through the port's
``GaussianModel``; warm-up renders the ring once, so the overflow retries
settle the slack before the window, as a trained model's saved slack does.

Traced, the window renders ``trace_views`` views untraced, timed, then the
same views under the profiler.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import harness as hn
from benchmark import scenes, work
from benchmark.reference import compare
from benchmark.reference import render as rr

NUMBERS = compare.VIEW_NUMBERS
# ranges that name the device's idle gaps in the breakdown
RANGES = (("gaussian_splatting_torch.render", "render_camera"),)


def viewer_focal(cfg: dict, width: int, height: int):
    """(fx, fy, tan x, tan y) of a viewer at ``width`` x ``height`` with
    the capture's vertical field of view."""
    tan_y = cfg["height"] / (2.0 * cfg["assumed"]["focal_px"])
    tan_x = tan_y * width / height
    return width / (2.0 * tan_x), height / (2.0 * tan_y), tan_x, tan_y


def ring(cfg: dict, mix: dict):
    """The viewer's poses: between the capture's cameras."""
    a = cfg["assumed"]
    return scenes.ring_poses(mix["ring_views"], a["ring_radius"], a["ring_height"], phase=0.5)


def model_capacity(cfg: dict) -> int:
    """The slots a trained model of the configuration's size loads into."""
    return int(cfg["num_gaussians"] * 1.2) + 1024


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        ranges: hn.Ranges) -> hn.Outcome:
    from gaussian_splatting_torch import render as render_mod
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.models.gaussians import GaussianModel
    from gaussian_splatting_torch.ops.camera_math import make_camera

    capacity = model_capacity(cfg)
    W, H = mix["width"], mix["height"]
    fx, fy, tan_x, tan_y = viewer_focal(cfg, W, H)
    poses = ring(cfg, mix)

    p = scenes.gaussians(cfg, seed, device, capacity, alive_first=True)
    model = GaussianModel(**{k: p[k] for k in scenes.PARAM_NAMES}, alive=p["alive"],
                          max_sh_degree=cfg["sh_degree"], sh_degree=cfg["sh_degree"])
    del p
    cams = [SimpleNamespace(cam=make_camera(rr.qvec_to_rotmat(q).T, t, 2 * math.atan(tan_x),
                                            2 * math.atan(tan_y), W, H, device=device))
            for q, t in poses]
    bg = torch.zeros(3, device=device)
    raster = RasterizeConfig()

    def render(cam):
        nonlocal raster
        image, out, retries = render_mod.render_camera(model, cam, raster, bg)
        hn.sync(device)
        if retries:
            raster = RasterizeConfig(instance_slack=raster.instance_slack * 2.0 ** retries)
        return image, out, retries

    for cam in cams:  # the slack settles here, as a trained model's saved slack does
        render(cam)
    rng = np.random.default_rng(scenes.sub_seed(seed, "views"))
    start = int(rng.integers(len(cams)))
    sample = set(rng.choice(mix["sample_span"], mix["checked_views"], replace=False).tolist())
    prof: dict = {}
    lat, kept, retried, last = [], {}, 0, None
    T = mix["trace_views"]
    plain_s, t_trace, ctx = 0.0, None, None
    hn.guard("after set-up")
    hn.sync(device)
    t_open = time.perf_counter()
    i = 0
    try:
        while (i < 2 * T) if trace else (time.perf_counter() - t_open < seconds):
            if trace and i == T:  # the same views again, under the profiler
                plain_s = time.perf_counter() - t_open
                ranges.__enter__()
                ctx = hn.profiled(prof)
                ctx.__enter__()
                hn.sync(device)
                t_trace = time.perf_counter()
            v = (start + i % T if trace else start + i) % len(cams)
            t = time.perf_counter()
            image, out, retries = render(cams[v])
            lat.append(time.perf_counter() - t)
            retried += retries > 0
            last = (v, image, out.invdepth)
            if i in sample:
                kept[i] = last
            i += 1
        t_close = time.perf_counter()
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
            ranges.__exit__(None, None, None)
    kept[i - 1] = last
    hn.guard("after the window")
    window_s = t_close - (t_trace if trace else t_open)
    prog = [(img, invd) for _, img, invd in kept.values()]
    views = [v for v, _, _ in kept.values()]
    del model, cams, last, image, out
    peak = hn.free_device(device)

    p = scenes.gaussians(cfg, seed, device, capacity, alive_first=True)
    params = {k: p[k] for k in scenes.PARAM_NAMES}
    ref = []
    with rr.precision(False):
        for v in views:
            cam = rr.camera(*poses[v], fx, fy, W, H, device)
            ref.append(rr.view(params, p["alive"], cam, bg, cfg["sh_degree"])[:2])
    numbers = compare.view_numbers(prog, ref)

    notes = [f"views rendered again after an overflow: {retried}"]
    tr = None
    if trace:
        def count(v):
            cam = rr.camera(*poses[v], fx, fy, W, H, device)
            return work.blend_counts(params, p["alive"], cam, bg, cfg["sh_degree"])

        units = [(start + k) % len(poses) for k in range(T)]
        tr = hn.reduce_trace(prof["events"], "view_orbit", window_s)
        tr.units, tr.plain_units, tr.plain_s, tr.count = units, units, plain_s, count
        tr.shapes = {"capacity": capacity, "pixels": W * H}
        notes.append(f"traced stretch {window_s:.6f} s, untraced {plain_s:.6f} s, "
                     f"{T} views each")
    e2e = {"views_per_s": i / window_s,
           "view_ms_p95": 1000.0 * float(np.percentile(lat, 95))}
    return hn.Outcome(e2e=e2e, setup_s=t_open - t0, attempted=i, failed=0,
                      memory_peak_bytes=peak, numbers=numbers, trace=tr, notes=notes)


def tf32_control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The numbers compared, of the reference in TF32 put in the
    program's place, at views of the ring drawn from the seed."""
    W, H = mix["width"], mix["height"]
    fx, fy, _, _ = viewer_focal(cfg, W, H)
    poses = ring(cfg, mix)
    rng = np.random.default_rng(scenes.sub_seed(seed, "control views"))
    views = rng.choice(len(poses), mix["checked_views"], replace=False).tolist()
    p = scenes.gaussians(cfg, seed, device, model_capacity(cfg), alive_first=True)
    params = {k: p[k] for k in scenes.PARAM_NAMES}
    bg = torch.zeros(3, device=device)
    out = {}
    for tf32 in (False, True):
        with rr.precision(tf32):
            out[tf32] = [rr.view(params, p["alive"], rr.camera(*poses[v], fx, fy, W, H, device),
                                 bg, cfg["sh_degree"])[:2] for v in views]
    return compare.view_numbers(out[True], out[False])
