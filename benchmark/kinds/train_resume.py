"""Traffic kind ``train_resume``: a closed loop, the port's training loop
itself (``train.loop.train``) resumed at ``resume_iteration`` from a state
the benchmark makes from the seed, on a COLMAP capture the benchmark writes.
The loop queues its next step whenever the host is free, as training does.
A wrapper on ``loop.train_step`` counts the steps, keeps what the checked
steps produced, and ends the run by raising once the window has passed; the
loop's own one-step lag and its checks every 100 iterations stay as they
are.

Traced, the window is ``trace_iterations`` untraced steps, timed, then as
many under the profiler.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import List

import numpy as np
import torch

from benchmark import harness as hn
from benchmark import scenes, work
from benchmark.reference import compare
from benchmark.reference import render as rr
from benchmark.reference import train as rt

NUMBERS = compare.TRAIN_NUMBERS
# ranges that name the device's idle gaps in the breakdown
RANGES = (("gaussian_splatting_torch.train.step", "step_gradients"),
          ("gaussian_splatting_torch.train.loop", "make_batch"))


def capture_geometry(cfg: dict):
    """Capture poses (in name order) and which of them train."""
    a = cfg["assumed"]
    poses = scenes.ring_poses(cfg["num_views"], a["ring_radius"], a["ring_height"])
    train = [i for i in range(len(poses)) if i % cfg["llffhold"]]
    return poses, train


def _view_matrix(q, t) -> torch.Tensor:
    V = np.eye(4)
    V[:3, :3] = rr.qvec_to_rotmat(q)
    V[:3, 3] = t
    return torch.tensor(V, dtype=torch.float32)


def _match(view: torch.Tensor, poses, candidates) -> int:
    """The capture view whose pose a step's camera was built from."""
    v = view.detach().cpu()
    best = min(candidates, key=lambda i: float((_view_matrix(*poses[i]) - v).abs().max()))
    if float((_view_matrix(*poses[best]) - v).abs().max()) > 1e-4:
        raise RuntimeError("a step ran on a camera that is not in the capture")
    return best


class Probe:
    """Stands in for ``loop.train_step``: runs it, keeps the checked steps'
    outputs, opens the window after ``warmup`` steps and closes it by
    raising ``EndWindow``: after ``seconds``, or, traced, after an untraced
    and a traced stretch of ``trace_units`` steps each."""

    def __init__(self, real, mix: dict, seconds: float, trace: bool, device, ranges):
        self.real = real
        self.checked = mix["checked_steps"]
        self.warmup = mix["warmup_iterations"]
        self.seconds = seconds
        self.trace = trace
        self.trace_units = mix["trace_iterations"]
        self.device = device
        self.ranges = ranges
        self.calls = 0
        self.t_open = self.t_trace = self.t_close = None
        self.plain_s = 0.0
        self.cams: List[torch.Tensor] = []  # checked steps' view matrices
        self.plain_cams: List[torch.Tensor] = []
        self.traced_cams: List[torch.Tensor] = []
        self.packed: List[torch.Tensor] = []  # the window's step metrics
        self.losses: List[torch.Tensor] = []
        self.kept: dict = {}
        self.prof: dict = {}
        self._prof_ctx = None

    def open_window(self):
        hn.guard("after set-up")
        hn.sync(self.device)
        self.t_open = time.perf_counter()

    def start_trace(self):
        hn.sync(self.device)
        self.plain_s = time.perf_counter() - self.t_open
        self.ranges.__enter__()
        self._prof_ctx = hn.profiled(self.prof)
        self._prof_ctx.__enter__()
        hn.sync(self.device)
        self.t_trace = time.perf_counter()

    def close_window(self):
        hn.sync(self.device)
        self.t_close = time.perf_counter()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(None, None, None)
            self.ranges.__exit__(None, None, None)
        raise hn.EndWindow

    def __call__(self, state, cam, batch, **kw):
        i = self.calls
        self.calls += 1
        n = i - self.warmup
        if n == 0:
            self.open_window()
        if n >= 0:
            if self.trace:
                if n == self.trace_units:
                    self.start_trace()
                elif n == 2 * self.trace_units:
                    self.close_window()
                stretch = self.plain_cams if self.t_trace is None else self.traced_cams
                stretch.append(cam.viewmatrix)
            elif time.perf_counter() - self.t_open >= self.seconds:
                self.close_window()
        if i >= self.checked:
            out = self._step(state, cam, batch, kw)
            if n >= 0:
                self.packed.append(out[1]["packed"])
            return out
        self.cams.append(cam.viewmatrix.detach().clone())
        if i == 0:
            out = self._first_step(state, cam, batch, kw)
        else:
            out = self._step(state, cam, batch, kw)
        self.losses.append(out[1]["packed"][0].clone())
        if i == self.checked - 1:
            m = state.model
            self.kept["params"] = {k: v.detach().clone() for k, v in m.params().items()}
            self.kept["mu"] = {k: v.clone() for k, v in state.adam.mu.items()}
            self.kept["nu"] = {k: v.clone() for k, v in state.adam.nu.items()}
            self.kept["stats"] = {k: getattr(m, k).clone() for k in scenes.STAT_NAMES}
        return out

    def _step(self, state, cam, batch, kw):
        if self.t_trace is not None:
            from torch.profiler import record_function

            with record_function("bench.train_step"):
                return self.real(state, cam, batch, **kw)
        return self.real(state, cam, batch, **kw)

    def _first_step(self, state, cam, batch, kw):
        """The first step, with its render's image, inverse depth and slot
        demand kept, and its first moments after it."""
        from gaussian_splatting_torch.train import step as step_mod

        real_render = step_mod.render

        def render(*a, **k):
            out = real_render(*a, **k)
            self.kept["image"] = out.image.detach().clone()
            self.kept["invdepth"] = out.invdepth.detach().clone()
            self.kept["demand"] = out.num_instances.clone()
            return out

        step_mod.render = render
        try:
            out = self.real(state, cam, batch, **kw)
        finally:
            step_mod.render = real_render
        self.kept["mu1"] = {k: v.clone() for k, v in state.adam.mu.items()}
        return out


def _program_state(init: dict, cfg: dict, extent: float, n_train: int, resume: int, device):
    """The program's ``TrainState`` at the resume iteration, from copies
    of the benchmark's tensors."""
    from gaussian_splatting_torch.models.gaussians import GaussianModel
    from gaussian_splatting_torch.train.optim import AdamState
    from gaussian_splatting_torch.train.step import TrainState

    c = {k: v.clone() for k, v in init.items()}
    model = GaussianModel(**{k: c[k] for k in scenes.PARAM_NAMES}, alive=c["alive"],
                          max_sh_degree=cfg["sh_degree"], sh_degree=cfg["sh_degree"],
                          spatial_lr_scale=extent,
                          stats={k: c[k] for k in scenes.STAT_NAMES})
    count = torch.tensor(resume, dtype=torch.int32, device=device)
    adam = AdamState(count=count.clone(), mu={k: c["mu." + k] for k in scenes.PARAM_NAMES},
                     nu={k: c["nu." + k] for k in scenes.PARAM_NAMES})
    eye = torch.cat([torch.eye(3, device=device), torch.zeros(3, 1, device=device)], dim=1)
    exposures = eye[None].repeat(n_train, 1, 1)
    exp_adam = AdamState(count=count.clone(), mu={"exposures": torch.zeros_like(exposures)},
                         nu={"exposures": torch.zeros_like(exposures)})
    return TrainState(model=model, adam=adam, exposures=exposures, exp_adam=exp_adam,
                      step=count.clone())


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device, t0: float,
        ranges: hn.Ranges) -> hn.Outcome:
    from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussian_splatting_torch.train import loop

    a = cfg["assumed"]
    resume = mix["resume_iteration"]
    capacity = a["capacity"]
    poses, train_ids = capture_geometry(cfg)
    extent = scenes.scene_extent([poses[i] for i in train_ids])
    tmp = tempfile.mkdtemp(prefix="gs-bench-")
    try:
        scene_dir = os.path.join(tmp, "scene")
        scenes.write_capture(scene_dir, cfg, poses, seed, device)
        hn.sync(device)
        t_capture = time.perf_counter()
        init = scenes.gaussians(cfg, seed, device, capacity, alive_first=False)
        init.update(scenes.optimizer_state(init, cfg, seed, device))
        state = _program_state(init, cfg, extent, len(train_ids), resume, device)
        hn.sync(device)
        t_state = time.perf_counter()

        probe = Probe(loop.train_step, mix, seconds, trace, device, ranges)
        saved = [(loop, "train_step", loop.train_step),
                 (loop, "load_checkpoint", loop.load_checkpoint)]

        def load_checkpoint(path, device=None):
            return state, resume

        loop.train_step = probe
        loop.load_checkpoint = load_checkpoint
        model_cfg = ModelConfig(sh_degree=cfg["sh_degree"], source_path=scene_dir,
                                model_path=os.path.join(tmp, "model"), images=cfg["images"],
                                eval=True)
        opt = OptimizationConfig(iterations=cfg["iterations"],
                                 densify_until_iter=cfg["densify_until_iter"])
        try:
            loop.train(model_cfg, opt, PipelineConfig(), test_iterations=(), save_iterations=(),
                       checkpoint_iterations=(), start_checkpoint="resume", quiet=True,
                       seed=scenes.sub_seed(seed, "loop") % (1 << 32), device=device)
            raise RuntimeError("the training loop ended before the window closed")
        except hn.EndWindow:
            pass
        finally:
            for mod, attr, real in saved:
                setattr(mod, attr, real)
        del state
        hn.guard("after the window")
        iters = probe.calls - 1 - probe.warmup
        t_open = probe.t_open
        window_s = probe.t_close - (probe.t_trace if trace else t_open)
        packed = torch.stack(probe.packed).cpu() if probe.packed else torch.zeros(0, 6)
        failed = int((packed[:, 3] > 0).sum())
        kept, losses = probe.kept, [float(x) for x in probe.losses]
        cams = [_match(v, poses, train_ids) for v in probe.cams]
        plain_cams = [_match(v, poses, train_ids) for v in probe.plain_cams]
        traced_cams = [_match(v, poses, train_ids) for v in probe.traced_cams]
        trace_events, plain_s = probe.prof.get("events"), probe.plain_s
        probe = None
        peak = hn.free_device(device)

        # the reference follows the checked steps from its own copy of the
        # state the benchmark made
        f = a["focal_px"]
        W, H = cfg["width"], cfg["height"]
        bg = torch.zeros(3, device=device)
        ref_state = {k: v.clone() for k, v in init.items()}
        ref_state["step"] = ref_state["count"] = torch.tensor(resume)
        ref_losses, first = [], None
        with rr.precision(False):
            for i in cams:
                cam = rr.camera(*poses[i], f, f, W, H, device)
                info = rt.step(ref_state, cam, scenes.read_target(scene_dir, cfg, i, device),
                               bg, extent)
                ref_losses.append(info["loss"])
                first = first or info
        numbers = compare.train_numbers(program_outputs(kept, losses, init),
                                        reference_outputs(ref_state, init, first, ref_losses))

        tr = None
        if trace:
            params = {k: ref_state[k] for k in scenes.PARAM_NAMES}

            def count(i):
                cam = rr.camera(*poses[i], f, f, W, H, device)
                return work.blend_counts(params, ref_state["alive"], cam, bg, cfg["sh_degree"])

            tr = hn.reduce_trace(trace_events, "train_resume", window_s)
            tr.units, tr.plain_units, tr.plain_s, tr.count = traced_cams, plain_cams, plain_s, count
            tr.shapes = {"capacity": capacity, "pixels": W * H}
        e2e = {"train_iter_ms": 1000.0 * window_s / max(iters, 1)}
        notes = [f"set-up: capture written {t_capture - t0:.3f} s, state made "
                 f"{t_state - t_capture:.3f} s, loop to the window {t_open - t_state:.3f} s"]
        if trace:
            notes.append(f"traced stretch {window_s:.6f} s, untraced {plain_s:.6f} s, "
                         f"{len(traced_cams)} iterations each")
        return hn.Outcome(e2e=e2e, setup_s=t_open - t0, attempted=iters, failed=failed,
                          memory_peak_bytes=peak, numbers=numbers, trace=tr, notes=notes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def tf32_control(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The numbers compared, of the reference in TF32 put in the
    program's place: three steps from the seed's state at three train
    views drawn from the seed."""
    a = cfg["assumed"]
    poses, train_ids = capture_geometry(cfg)
    extent = scenes.scene_extent([poses[i] for i in train_ids])
    rng = np.random.default_rng(scenes.sub_seed(seed, "control views"))
    views = rng.choice(train_ids, mix["checked_steps"], replace=False).tolist()
    tmp = tempfile.mkdtemp(prefix="gs-bench-control-")
    try:
        scenes.write_capture(tmp, cfg, poses, seed, device)
        targets = {i: scenes.read_target(tmp, cfg, i, device) for i in views}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    init = scenes.gaussians(cfg, seed, device, a["capacity"], alive_first=False)
    init.update(scenes.optimizer_state(init, cfg, seed, device))
    bg = torch.zeros(3, device=device)
    out = {}
    for tf32 in (False, True):
        state = {k: v.clone() for k, v in init.items()}
        state["step"] = state["count"] = torch.tensor(mix["resume_iteration"])
        losses, first = [], None
        with rr.precision(tf32):
            for i in views:
                cam = rr.camera(*poses[i], a["focal_px"], a["focal_px"], cfg["width"],
                                cfg["height"], device)
                info = rt.step(state, cam, targets[i], bg, extent)
                losses.append(info["loss"])
                first = first or info
        out[tf32] = reference_outputs(state, init, first, losses)
        del state
    return compare.train_numbers(out[True], out[False])


def program_outputs(kept: dict, losses: list, init: dict) -> dict:
    """What the program's checked steps produced, as ``compare`` takes it:
    the first step's gradient worked out from its first moments."""
    names = scenes.PARAM_NAMES
    b1 = rt.B1
    return {
        "losses": losses, "image": kept["image"], "invdepth": kept["invdepth"],
        "demand": int(kept["demand"]),
        "grad": {k: (kept["mu1"][k] - b1 * init["mu." + k]) / (1.0 - b1) for k in names},
        "delta": {k: kept["params"][k] - init[k] for k in names},
        "delta_mu": {k: kept["mu"][k] - init["mu." + k] for k in names},
        "delta_nu": {k: kept["nu"][k] - init["nu." + k] for k in names},
        "delta_stats": {k: kept["stats"][k] - init[k] for k in scenes.STAT_NAMES},
    }


def reference_outputs(ref: dict, init: dict, first: dict, losses: list) -> dict:
    names = scenes.PARAM_NAMES
    return {
        "losses": losses, "image": first["image"], "invdepth": first["invdepth"],
        "demand": first["demand"], "grad": first["grads"],
        "delta": {k: ref[k] - init[k] for k in names},
        "delta_mu": {k: ref["mu." + k] - init["mu." + k] for k in names},
        "delta_nu": {k: ref["nu." + k] - init["nu." + k] for k in names},
        "delta_stats": {k: ref[k] - init[k] for k in scenes.STAT_NAMES},
    }
