"""The quality corpus: the three analytic scenes trained through the
reference's 30,000-iteration schedule and scored on their held-out views
(the port's counterpart of ``tools/run_quality_corpus.sh``, the generation
of ``tools/run_quality_analytic.sh`` and ``tools/corpus_report.py``).

    python -m gaussian_splatting_torch.corpus {spheres|thicket|glossy|all|report}
        [--iterations N] [--device cpu] [--data DIR] [--runs DIR] [--results DIR]
        [--reference DIR] [training CLI flags, e.g. --seed 1 --checkpoint_iterations
        5000 --start_checkpoint FILE]

A scene run generates the scene under ``<data>/<name>`` unless it is there,
trains it with the training CLI (``SCENES`` holds each scene's switches;
flags this CLI does not know go to the training CLI after them), renders and
scores the test views at every saved iteration (the render and metrics
CLIs), and writes ``<results>/torch_<name>_results.json`` (the JAX corpus's
``results.json`` schema) and ``<results>/torch_<name>_train.log`` (the
training CLI's output, then the device, the wall times and the overflow
no-ops).  ``report`` prints ``tools/corpus_report.py``'s table of the JAX
package's ``<reference>/<name>_results.json``, then the port's rows and both
packages' trajectories side by side.  The default directories are under
``build/corpus/`` of the working directory, and ``--reference`` is
``results``: run it from the repository's root, and copy a run's files into
``results/`` by hand.  Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, TextIO, Tuple

import torch

from gaussian_splatting_torch import resolve_device



class CorpusScene(NamedTuple):
    generate: dict  # generate_analytic_dataset arguments beyond its defaults
    switches: Tuple[str, ...]  # training CLI flags beyond COMMON_SWITCHES


# tools/run_quality_corpus.sh:27-30 and :46-51
COMMON_SWITCHES = ("-w", "--eval", "--disable_viewer", "--capacity", "262144")
TEST_ITERATIONS = (1000, 7000, 15000, 30000)
SAVE_ITERATIONS = (7000, 30000)
SCENES: Dict[str, CorpusScene] = {
    "spheres": CorpusScene({}, ()),
    "thicket": CorpusScene({"depths": True}, ("--antialiasing", "-d", "depths")),
    "glossy": CorpusScene({"exposure_jitter": 0.1}, (
        "--train_test_exp", "--exposure_lr_init", "0.001", "--exposure_lr_final", "0.0001",
        "--exposure_lr_delay_steps", "5000", "--exposure_lr_delay_mult", "0.001")),
}
# tools/corpus_report.py's column, word for word
ABLATIONS = {
    "spheres": "defaults (round-3 anchor scene)",
    "thicket": "--antialiasing + depth loss from exact inv-depth GT",
    "glossy": "exposure-jittered train views + --train_test_exp recovery",
}
# the port's test PSNR may fall at most this far below JAX's at each iteration
BOUNDS_DB = {1000: 1.0, 7000: 1.0, 30000: 0.5}
GENERATION_FILE = "corpus_generation.json"


def generate(name: str, root: str, device=None, **sizes) -> str:
    """Raytrace scene ``name`` into ``root`` with ``generate_analytic_dataset``'s
    defaults (100 train and 12 test views at 800x600, supersample 2, seed 0)
    plus the scene's own arguments; ``sizes`` overrides any of them.  The
    arguments are kept in ``root/corpus_generation.json``: the JAX corpus did
    not record its own."""
    from gaussian_splatting_torch.utils.synthetic_dataset import generate_analytic_dataset

    kwargs = {k: p.default for k, p in
              inspect.signature(generate_analytic_dataset).parameters.items()
              if p.default is not inspect.Parameter.empty and k != "device"}
    kwargs.update(SCENES[name].generate, scene_name=name, **sizes)
    generate_analytic_dataset(root, device=device, **kwargs)
    with open(os.path.join(root, GENERATION_FILE), "w") as f:
        json.dump(kwargs, f, sort_keys=True)
    return root


def train_argv(name: str, data: str, out: str, *, iterations: int = 30_000,
               test_iterations: Sequence[int] = TEST_ITERATIONS,
               save_iterations: Sequence[int] = SAVE_ITERATIONS,
               device=None, extra_args: Sequence[str] = ()) -> List[str]:
    """The training CLI's arguments for scene ``name``, as the JAX script
    builds them, then ``extra_args``."""
    argv = ["-s", data, "-m", out, *COMMON_SWITCHES,
            "--test_iterations", *map(str, test_iterations),
            "--save_iterations", *map(str, save_iterations), *SCENES[name].switches,
            "--iterations", str(iterations), *extra_args]
    if device is not None:
        argv += ["--device", str(device)]
    return argv


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        label = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        label = ""
    return label or f"{torch.cuda.get_device_name(index)}, power limit not read"


class Tee:
    """A text stream that writes to several."""

    def __init__(self, *streams: TextIO):
        self.streams = streams

    def write(self, text: str) -> int:
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()


class EndRun(Exception):
    """Raised from inside the training loop, by a caller's hook, to end a
    run after ``iteration`` of its schedule; ``run_scene`` then scores the
    snapshots saved up to there."""

    def __init__(self, iteration: int):
        super().__init__(f"run ended after iteration {iteration}")
        self.iteration = iteration


def run_scene(name: str, data: str, out: str, *, iterations: int = 30_000,
              test_iterations: Sequence[int] = TEST_ITERATIONS,
              save_iterations: Sequence[int] = SAVE_ITERATIONS,
              device=None, results_dir: str = os.path.join("build", "corpus", "results"),
              extra_args: Sequence[str] = ()) -> dict:
    """Train scene ``name`` from ``data`` into ``out`` with the training CLI,
    then render and score the test views at each saved iteration, as
    ``tools/run_quality_corpus.sh`` does; ``extra_args`` go to the training
    CLI after the scene's switches.  Writes ``torch_<name>_train.log`` (the
    CLI's output, then a summary; appended to when ``extra_args`` hold
    ``--start_checkpoint``) and ``torch_<name>_results.json`` into
    ``results_dir``.  A hook that raises ``EndRun`` inside the loop ends the
    run early, on the schedule of ``iterations``.  Returns the scores, the
    trajectory and the wall times."""
    from gaussian_splatting_torch import metrics, render
    from gaussian_splatting_torch.train import cli

    dev = resolve_device(device)
    os.makedirs(results_dir, exist_ok=True)
    log_path = os.path.join(results_dir, f"torch_{name}_train.log")
    argv = train_argv(name, data, out, iterations=iterations, test_iterations=test_iterations,
                      save_iterations=save_iterations, device=dev, extra_args=extra_args)
    label = device_label(dev)
    gen_path = os.path.join(data, GENERATION_FILE)
    generation = "arguments not recorded"
    if os.path.exists(gen_path):
        with open(gen_path) as f:
            generation = f.read().strip()
    last = iterations
    with open(log_path, "a" if "--start_checkpoint" in extra_args else "w") as log:
        tee = Tee(sys.stdout, log)
        print(f"[corpus] scene {name} on {label}; generated with {generation}", file=tee)
        print(f"[corpus] python -m gaussian_splatting_torch.train {' '.join(argv)}", file=tee)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            try:
                cli.main(argv)
            except EndRun as end:
                last = end.iteration
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
        if last != iterations:
            print(f"[corpus] ended after iteration {last} of the {iterations}-iteration "
                  f"schedule", file=tee)
        t0 = time.perf_counter()
        for it in sorted({i for i in (*save_iterations, iterations) if i <= last}):
            render.main(["-m", out, "--skip_train", "--iteration", str(it), "--device", str(dev)])
        metrics.main(["-m", out, "--device", str(dev)])
        score_s = time.perf_counter() - t0
        print(f"[corpus] training: {last} iterations in {train_s:.3f} s wall on {label}",
              file=tee)
        print(f"[corpus] render and metrics: {score_s:.3f} s wall", file=tee)
        log.flush()
        with open(log_path) as f:
            traj = trajectory(f.read())
        print(f"[corpus] overflow no-ops: {len(traj.overflows)}; slack and capacity events: "
              f"{len(traj.events)}", file=tee)
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)
    shutil.copyfile(os.path.join(out, "results.json"),
                    os.path.join(results_dir, f"torch_{name}_results.json"))
    return {"results": results, "trajectory": traj, "train_s": train_s, "score_s": score_s,
            "log": log_path}


@dataclasses.dataclass
class Trajectory:
    """What a training log of either package says, by iteration."""

    progress: Dict[int, dict] = dataclasses.field(default_factory=dict)  # loss, gaussians, ...
    test_psnr: Dict[int, float] = dataclasses.field(default_factory=dict)
    events: List[Tuple[int, str]] = dataclasses.field(default_factory=list)  # slack, growth
    growths: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    overflows: List[int] = dataclasses.field(default_factory=list)  # no-op steps
    wall_s: Optional[float] = None  # the port's training run, with the device it ran on
    device: str = ""

    def gaussians(self, iteration: int) -> Optional[int]:
        row = self.progress.get(iteration)
        return None if row is None else row["gaussians"]


_PROGRESS = re.compile(r"\[it (\d+)/\d+\] loss=([\d.]+) gaussians=(\d+) inst=(\d+) \((\d+)s\)")
_EVAL = re.compile(r"\[ITER (\d+)\] Evaluating test: L1 [\d.]+ PSNR ([\d.]+)")
_EVENT = re.compile(r"\[(?:it (\d+)|init)\] (.*(?:instance_slack|growing capacity).*)")
_GROWTH = re.compile(r"growing capacity (\d+) -> (\d+)")
_OVERFLOW = re.compile(r"\[it (\d+)\] instance buffer overflow")
_CORPUS_WALL = re.compile(r"\[corpus\] training: \d+ iterations in ([\d.]+) s wall on (.*)")


def trajectory(log_text: str) -> Trajectory:
    """Parse a training log of either package (``train/loop.py``'s lines
    are the same in both): the progress lines every 500 iterations, the
    test PSNR of each evaluation, the slack re-sizes, capacity growths and
    densify re-probes, the overflow no-ops, and ``run_scene``'s wall time
    and device line."""
    t = Trajectory()
    for line in log_text.splitlines():
        line = line.strip()
        if m := _PROGRESS.match(line):
            t.progress[int(m[1])] = {"loss": float(m[2]), "gaussians": int(m[3]),
                                     "inst": int(m[4]), "seconds": int(m[5])}
        elif m := _EVAL.match(line):
            t.test_psnr[int(m[1])] = float(m[2])
        elif m := _OVERFLOW.match(line):
            t.overflows.append(int(m[1]))
        elif m := _EVENT.match(line):
            it = int(m[1]) if m[1] else 0
            t.events.append((it, m[2]))
            if g := _GROWTH.search(m[2]):
                t.growths.append((it, int(g[1]), int(g[2])))
        elif m := _CORPUS_WALL.match(line):
            t.wall_s, t.device = float(m[1]), m[2]
    return t


def _read_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_log(path: str) -> Trajectory:
    if not os.path.exists(path):
        return Trajectory()
    with open(path) as f:
        return trajectory(f.read())


def _table(rows, label=lambda name: name) -> None:
    fmt = lambda v: "null" if v is None else f"{v:.3f}"  # noqa: E731
    print("| scene | ablation | iters | PSNR | SSIM | LPIPS |")
    print("|---|---|---|---|---|---|")
    for name, res in rows:
        if res is None:
            print(f"| {label(name)} | {ABLATIONS[name]} | — | (missing) | | |")
            continue
        for method, m in sorted(res.items()):
            it = method.split("_")[-1]
            print(f"| {label(name)} | {ABLATIONS[name]} | {it} | {fmt(m.get('PSNR'))} | "
                  f"{fmt(m.get('SSIM'))} | {fmt(m.get('LPIPS'))} |")


def report(results_dir: str = "results", reference_dir: Optional[str] = None) -> None:
    """``tools/corpus_report.py``'s table of the JAX package's
    ``<reference_dir>/<name>_results.json`` (``reference_dir`` defaults to
    ``results_dir``) byte for byte; then the port's
    ``<results_dir>/torch_<name>_results.json`` rows; then, per scene and
    iteration, the test PSNR of both packages (at 1000 from the logs)
    against ``BOUNDS_DB``, and each log's Gaussian counts, overflow no-ops,
    slack and capacity events and wall time."""
    names = tuple(SCENES)
    reference_dir = reference_dir or results_dir
    jax_res = {n: _read_json(os.path.join(reference_dir, f"{n}_results.json")) for n in names}
    port_res = {n: _read_json(os.path.join(results_dir, f"torch_{n}_results.json"))
                for n in names}
    _table([(n, jax_res[n]) for n in names])
    if not any(port_res.values()):
        return
    print()
    print("The port (gaussian_splatting_torch), `torch_<scene>_results.json`:")
    print()
    _table([(n, port_res[n]) for n in names], label=lambda n: f"{n} (port)")
    print()
    print("| scene | iters | JAX PSNR | port PSNR | port − JAX | bound | held | "
          "Gaussians JAX / port | overflow no-ops JAX / port |")
    print("|---|---|---|---|---|---|---|---|---|")
    logs = {n: (_read_log(os.path.join(reference_dir, f"{n}_train.log")),
                _read_log(os.path.join(results_dir, f"torch_{n}_train.log"))) for n in names}
    fmt = lambda v: "—" if v is None else f"{v:.3f}"  # noqa: E731
    for n in names:
        jt, pt = logs[n]
        for it, bound in BOUNDS_DB.items():
            if it == 1000:  # no snapshot then: the in-training eval, to 2 decimals
                ref, got = jt.test_psnr.get(it), pt.test_psnr.get(it)
            else:
                ref = (jax_res[n] or {}).get(f"ours_{it}", {}).get("PSNR")
                got = (port_res[n] or {}).get(f"ours_{it}", {}).get("PSNR")
            if ref is None and got is None:
                continue
            diff = None if ref is None or got is None else got - ref
            held = "—" if diff is None else ("yes" if diff >= -bound else "NO")
            print(f"| {n} | {it} | {fmt(ref)} | {fmt(got)} | {fmt(diff)} | −{bound} | {held} | "
                  f"{jt.gaussians(it)} / {pt.gaussians(it)} | "
                  f"{len(jt.overflows)} / {len(pt.overflows)} |")
    for n in names:
        jt, pt = logs[n]
        if not pt.progress:
            continue
        print()
        print(f"{n}: port run {pt.wall_s} s wall on {pt.device or 'an unrecorded device'}; "
              f"{len(pt.overflows)} overflow no-ops; events:")
        for it, text in pt.events:
            print(f"  port [it {it}] {text}")
        print(f"  JAX: {len(jt.overflows)} overflow no-ops, {len(jt.events)} events, capacity "
              f"growths at {[g[0] for g in jt.growths]}; port: at {[g[0] for g in pt.growths]}")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train and score the analytic quality corpus; flags this parser does not "
                    "know (--seed, --checkpoint_iterations, --start_checkpoint, ...) go to the "
                    "training CLI")
    p.add_argument("scene", choices=[*SCENES, "all", "report"])
    p.add_argument("--iterations", type=int, default=30_000)
    p.add_argument("--data", default=os.path.join("build", "corpus", "data"),
                   help="where the scenes are generated, one directory each")
    p.add_argument("--runs", default=os.path.join("build", "corpus", "runs"),
                   help="where the trained models go, one directory each")
    p.add_argument("--results", default=os.path.join("build", "corpus", "results"),
                   help="where torch_<scene>_{results.json,train.log} go")
    p.add_argument("--reference", default="results",
                   help="where the JAX corpus's <scene>_{results.json,train.log} are")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args, train_args = _parser().parse_known_args(argv)
    if args.scene == "report":
        report(args.results, args.reference)
        return
    device = resolve_device(args.device)
    for name in SCENES if args.scene == "all" else (args.scene,):
        data = os.path.join(args.data, name)
        if not os.path.exists(os.path.join(data, "transforms_test.json")):
            t0 = time.perf_counter()
            generate(name, data, device=device)
            print(f"[corpus] generated {name} in {time.perf_counter() - t0:.3f} s")
        run_scene(name, data, os.path.join(args.runs, name), iterations=args.iterations,
                  device=device, results_dir=args.results, extra_args=train_args)
    report(args.results, args.reference)


if __name__ == "__main__":
    main()
