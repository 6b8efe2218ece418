"""The control and the faults that the comparison deciding ``correct`` has
to fail, at a cell's own size.  The benchmark's runs never run them.

    python benchmark/controls.py --workload <cell> --control <name> --seeds <n> [<n> ...]

``tf32``: the reference put in the program's place and computed one
precision below the configuration's (float32 with TF32 off): its matrix
products and convolutions in TF32, against the float32 reference on the
same inputs, as the cell's traffic kind gives it (``kinds/<kind>.py``,
``tf32_control``).
``half_batch`` (training): the program's loss taken over half of the
image's rows, the mean over those.  ``stale_step`` (training): the
program's step leaves its state as it was.  ``altered_view`` (views): each
image the program renders is altered in one 16x16 block where it is
produced.  The faults run the cell as a run does, with the fault planted
underneath.  Each seed prints one line of JSON with the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class planted:
    """A fault planted in the program for the length of a ``with``."""

    def __init__(self, name: str):
        self.name = name
        self.saved = []

    def _set(self, mod, attr, value):
        self.saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, value)

    def __enter__(self):
        from gaussian_splatting_torch import render as render_mod
        from gaussian_splatting_torch.train import step as step_mod

        if self.name == "half_batch":
            real = step_mod.photometric_loss

            def half(image, gt, lam):
                h = image.shape[-2] // 2
                return real(image[..., :h, :], gt[..., :h, :], lam)

            self._set(step_mod, "photometric_loss", half)
        elif self.name == "stale_step":
            self._set(step_mod, "apply_gradients", lambda *a, **k: None)
        elif self.name == "altered_view":
            real = render_mod.render_camera

            def altered(*a, **k):
                image, out, retries = real(*a, **k)
                image = image.clone()
                image[:, :16, :16] = 1.0 - image[:, :16, :16]
                return image, out, retries

            self._set(render_mod, "render_camera", altered)
        else:
            raise ValueError(f"unknown fault {self.name!r}")
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self.saved):
            setattr(mod, attr, real)


def fault_run(spec: dict, cell: str, fault: str, seed: int, seconds: float, device,
              overrides=None) -> dict:
    """One run of ``cell`` with ``fault`` planted: its result line and
    checks."""
    from benchmark import run

    with planted(fault):
        result, checks = run.run_cell(spec, cell, seed, seconds, False, device,
                                      time.perf_counter(), overrides)
    return {"correct": result["correct"], "numbers": {k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True,
                   choices=("tf32", "half_batch", "stale_step", "altered_view"))
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness as hn
    from benchmark.reference import compare

    if not torch.cuda.is_available():
        print("the controls run at the cell's size on a CUDA card", file=sys.stderr)
        return 2
    spec = hn.load_spec()
    cell = hn.find(spec["workloads"], args.workload, "cell")
    cfg, mix = hn.config_of(spec, cell), hn.mix_of(cell)
    for seed in args.seeds:
        if args.control == "tf32":
            numbers = hn.kind_module(mix["kind"]).tf32_control(cfg, mix, seed, "cuda")
            checks = compare.judge(numbers, mix["limits"])
            line = {"correct": all(c["ok"] for c in checks.values()), "numbers": numbers}
        else:
            line = fault_run(spec, args.workload, args.control, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          **line}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
