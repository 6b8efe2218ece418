"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its per-layer metrics are
found by name from ``BENCHMARK.json`` (see ``harness.py``).  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled stretch.  The run
needs as many CUDA cards as the cell asks for, and fails without them.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout; no
    library pulls in JAX or TensorFlow on its own."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, overrides: dict = None):
    """One run of cell ``name``: (result line without its checks, checks).
    ``overrides`` replaces keys of the configuration and the mix."""
    import torch

    from benchmark import harness as hn
    from benchmark.reference import compare

    cell = hn.find(spec["workloads"], name, "cell")
    cfg = hn.config_of(spec, cell)
    mix = hn.mix_of(cell)
    for key, value in (overrides or {}).items():
        target = cfg["assumed"] if key in cfg.get("assumed", {}) else (cfg if key in cfg else mix)
        target[key] = value
    kind = hn.kind_module(mix["kind"])
    ranges = hn.Ranges(hn.range_targets(spec, name, kind))
    torch.manual_seed(seed)
    out = kind.run(cfg, mix, seed, seconds, trace, device, t0, ranges)
    checks = compare.judge(out.numbers, mix["limits"])

    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    metrics = {}
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": out.attempted,
              "failed": out.failed}
    if trace:
        tr = out.trace
        for m in hn.metrics_for(spec, name, "per_layer"):
            value = hn.metric_module(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.gaps()}
    else:
        values = dict(out.e2e, setup_s=out.setup_s)
        for m in hn.metrics_for(spec, name, "end_to_end"):
            metrics[m["name"]] = {"value": values[hn.quantity(m["name"])], "unit": m["unit"]}
    for note in out.notes:
        print(note, file=sys.stderr)
    for key, value in out.numbers.items():
        print(f"reading {key}: {value!r}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = info
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from benchmark import harness as hn

    spec = hn.load_spec()
    cell = hn.find(spec["workloads"], args.workload, "cell")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"card: {hn.card_line()}", flush=True)
    result, checks = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0)
    hn.guard("at the end of the run")
    hn.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
