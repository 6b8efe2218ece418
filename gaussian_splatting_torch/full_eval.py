"""The full evaluation suite (the port's ``full_eval.py``).

    python -m gaussian_splatting_torch.full_eval -m360 <dir> -tat <dir> -db <dir> [--use_depth]
        [--use_expcomp] [--aa] [--fast] [--output_path ./eval] [--device cpu]

Trains, renders and scores the 13 standard scenes (MipNeRF360 outdoor and
indoor, Tanks and Temples, Deep Blending) at 7,000 and 30,000 iterations
through the port's three CLIs, with the repository's root ``full_eval.py``'s
scene lists, flags and extra arguments, and appends each scene's training
wall time to ``<output_path>/timing.txt``.  ``--device`` is passed to every
CLI; the suite runs on the card unless it says ``cpu``.

One difference from the root script: each step runs as
``subprocess.run([sys.executable, "-m", "gaussian_splatting_torch.<cli>", ...],
check=True)``, not as ``os.system("python ...")``, so the interpreter that
runs the suite runs every step (a bare ``python`` need not exist where only
``python3`` does), and a failed step raises ``CalledProcessError``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time
from typing import List, Optional

from gaussian_splatting_torch import resolve_device

mipnerf360_outdoor_scenes = ["bicycle", "flowers", "garden", "stump", "treehill"]
mipnerf360_indoor_scenes = ["room", "counter", "kitchen", "bonsai"]
tanks_and_temples_scenes = ["truck", "train"]
deep_blending_scenes = ["drjohnson", "playroom"]
ITERATIONS = (7_000, 30_000)


def run(cmd: List[str]) -> None:
    print(f"$ {shlex.join(cmd)}", flush=True)
    subprocess.run(cmd, check=True)


def _cli(name: str) -> List[str]:
    return [sys.executable, "-m", f"gaussian_splatting_torch.{name}"]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train, render and score the standard scenes")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="", type=str)
    parser.add_argument("--tanksandtemples", "-tat", default="", type=str)
    parser.add_argument("--deepblending", "-db", default="", type=str)
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--use_depth", action="store_true")
    parser.add_argument("--use_expcomp", action="store_true")
    parser.add_argument("--aa", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu', passed to every CLI")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    args = _parser().parse_args(argv)
    device = ["--device", str(resolve_device(args.device))]

    scenes = []
    if args.mipnerf360:
        for s in mipnerf360_outdoor_scenes:
            scenes.append((os.path.join(args.mipnerf360, s), ["-i", "images_4"]))
        for s in mipnerf360_indoor_scenes:
            scenes.append((os.path.join(args.mipnerf360, s), ["-i", "images_2"]))
    if args.tanksandtemples:
        for s in tanks_and_temples_scenes:
            scenes.append((os.path.join(args.tanksandtemples, s), []))
    if args.deepblending:
        for s in deep_blending_scenes:
            scenes.append((os.path.join(args.deepblending, s), []))
    if not scenes:
        raise SystemExit("no dataset roots given (-m360/-tat/-db)")

    os.makedirs(args.output_path, exist_ok=True)
    extra = []
    if args.use_depth:
        extra += ["-d", "depths"]
    if args.use_expcomp:
        # the exposure learning-rate schedule comes with the flag
        extra += ["--exposure_lr_init", "0.001", "--exposure_lr_final", "0.0001",
                  "--exposure_lr_delay_steps", "5000", "--exposure_lr_delay_mult", "0.001",
                  "--train_test_exp"]
    if args.aa:
        extra += ["--antialiasing"]
    if args.fast:
        # --fast is the sparse Adam optimizer; the accelerated rasterizer is
        # already the default path
        extra += ["--optimizer_type", "sparse_adam"]

    timing_path = os.path.join(args.output_path, "timing.txt")
    for src, img_flag in scenes:
        name = os.path.basename(src)
        out = os.path.join(args.output_path, name)
        if not args.skip_training:
            t0 = time.time()
            run(_cli("train") + ["-s", src, *img_flag, "-m", out, "--eval", "--quiet",
                                 "--test_iterations", *map(str, ITERATIONS), *extra, *device])
            with open(timing_path, "a") as f:
                f.write(f"{name}: {(time.time() - t0) / 60:.1f} min\n")
        if not args.skip_rendering:
            for it in ITERATIONS:
                run(_cli("render") + ["-m", out, "--iteration", str(it), "--skip_train",
                                      *device])
    if not args.skip_metrics:
        outs = [os.path.join(args.output_path, os.path.basename(s)) for s, _ in scenes]
        run(_cli("metrics") + ["-m", *outs, *device])


if __name__ == "__main__":
    main()
