"""The port's training CLI: the repository's root ``train.py`` flags, plus
``--device``.

    python -m gaussian_splatting_torch.train -s <scene> -m <out> [--eval] [-r 1] [--device cpu]

Writes what the JAX trainer writes: ``cfg_args.json``, ``opt_args.json``,
``pipe_args.json``, ``cameras.json``, ``input.ply``, the
``point_cloud/iteration_<it>/point_cloud.ply`` snapshots with
``exposure.json`` and ``raster_state.json``, and ``chkpnt<it>.pth``
checkpoints, which ``--start_checkpoint`` resumes from.  Runs on the card
unless ``--device cpu`` is given.

``--parallel dp|gshard`` trains on every rank of a ``torch.distributed``
world, one process per card:

    torchrun --nproc_per_node N -m gaussian_splatting_torch.train --parallel gshard -s ... -m ...

Each rank runs on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``); without ``torchrun`` the process forms a world of one.  Rank 0
writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
import uuid
from datetime import datetime
from typing import List, Optional

import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.config import (
    ModelConfig,
    OptimizationConfig,
    PipelineConfig,
    save_config,
)
from gaussian_splatting_torch.parallel.mesh import init_distributed, is_main_process, shutdown


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a Gaussian-splatting model (PyTorch port)")
    # model
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--depths", "-d", type=str, default="")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--train_test_exp", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--data_device", type=str, default="cpu")
    # pipeline
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_from", type=int, default=-1)
    p.add_argument("--detect_anomaly", action="store_true")
    p.add_argument("--antialiasing", action="store_true")
    p.add_argument("--rasterizer_impl", type=str, default="auto")
    # optimisation: every OptimizationConfig field, with its default
    for f in dataclasses.fields(OptimizationConfig):
        if f.type in ("bool", bool):
            p.add_argument(f"--{f.name}", action="store_true")
        else:
            p.add_argument(f"--{f.name}", type=type(f.default), default=f.default)
    # run
    p.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", type=str, default="")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--capacity", type=int, default=0)
    p.add_argument("--disable_viewer", action="store_true")
    p.add_argument("--ip", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--profile", type=str, default="",
                   help="directory for a torch.profiler trace of the training loop")
    p.add_argument("--parallel", type=str, default="none", choices=["none", "dp", "gshard"],
                   help="multi-device strategy: camera data-parallel or Gaussian/tile-sharded")
    p.add_argument("--parallel_devices", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return p


def _extract(cls, args):
    return cls(**{f.name: getattr(args, f.name) for f in dataclasses.fields(cls)
                  if hasattr(args, f.name)})


def main(argv: Optional[List[str]] = None):
    """Train; returns the final ``TrainState``."""
    args = _parser().parse_args(argv)
    args.save_iterations.append(args.iterations)
    device = resolve_device(args.device)
    parallel = args.parallel != "none"
    if parallel:  # this rank's device: cuda:LOCAL_RANK under torchrun
        device = init_distributed(device)
    try:
        return _run(args, device, is_main_process())
    finally:
        if parallel:
            shutdown()


def _run(args, device, is_main: bool):
    if not args.model_path:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        path = [os.path.join("./output", f"{stamp}_{str(uuid.uuid4())[:8]}")]
        if args.parallel != "none":
            torch.distributed.broadcast_object_list(path, src=0)  # rank 0's name
        args.model_path = path[0]
    model_cfg = _extract(ModelConfig, args)
    opt = _extract(OptimizationConfig, args)
    pipe = _extract(PipelineConfig, args)
    if is_main:
        os.makedirs(args.model_path, exist_ok=True)
        print(f"Output folder: {args.model_path}")
        save_config(model_cfg, os.path.join(args.model_path, "cfg_args.json"))
        save_config(opt, os.path.join(args.model_path, "opt_args.json"))
        save_config(pipe, os.path.join(args.model_path, "pipe_args.json"))

    from gaussian_splatting_torch.train.loop import train

    tb_writer = None
    if is_main:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(args.model_path)
        except ImportError:
            print("Tensorboard not available: not logging progress")

    prof = None
    if args.profile and is_main:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    anomaly = args.detect_anomaly or (pipe.debug and args.debug_from < 0)
    t0 = time.time()
    try:
        with torch.autograd.set_detect_anomaly(anomaly):
            state = train(
                model_cfg, opt, pipe,
                debug_from=args.debug_from if pipe.debug else -1,
                test_iterations=set(args.test_iterations),
                save_iterations=set(args.save_iterations),
                checkpoint_iterations=set(args.checkpoint_iterations),
                start_checkpoint=args.start_checkpoint,
                seed=args.seed,
                capacity=args.capacity or None,
                quiet=args.quiet,
                viewer_ip="" if args.disable_viewer else args.ip,
                viewer_port=args.port,
                tb_writer=tb_writer,
                parallel=args.parallel,
                parallel_devices=args.parallel_devices,
                device=device,
            )
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        if tb_writer is not None:
            tb_writer.close()
    print(f"\nTraining complete in {time.time() - t0:.0f}s.")
    return state
