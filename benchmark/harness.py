"""What every cell shares: the spec and the files it names, the guard
against JAX in the process, the profiler's trace reduced to device
intervals and to the benchmark's own ranges, and the result line.

Everything is found by name.  A cell's configuration is
``configs/<config>.json``; its traffic mix is ``traffic/<traffic>.json``,
whose ``kind`` names the runner ``kinds/<kind>.py``; each per-layer metric
is ``metrics/<name>.py``, or, where no file has the whole name, the file of
the name with its last ``.<part>`` taken off (``k2_roofline.view`` is
read by ``k2_roofline.py``).  A metric file holds its reader and may
name the program's callable it reads the device time of (``RANGE``); the
runner wraps each such callable in a profiler range for the traced stretch.
An end-to-end metric's value is the runner's quantity of the name's part
before its first dot (``views_per_s.outdoor`` reports ``views_per_s``).
"""

from __future__ import annotations

import ast
import bisect
import gc
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
SPEC_PATH = os.path.join(ROOT, "BENCHMARK.json")
# top-level module names that no run may hold: the JAX stack and the JAX
# package, compared whole (the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussian_splatting_tpu")
PROGRAM = "gaussian_splatting_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load_spec(path: str = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def find(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def config_of(spec: dict, cell: dict) -> dict:
    entry = find(spec["configs"], cell["config"], "configuration")
    cfg = load_json(os.path.relpath(os.path.join(ROOT, entry["file"]), BENCH_DIR))
    cfg["name"] = entry["name"]
    return cfg


def mix_of(cell: dict) -> dict:
    return load_json("traffic", cell["traffic"] + ".json")


def kind_module(kind: str):
    """The runner of the traffic kind ``kind``: ``kinds/<kind>.py``."""
    if not NAME.match(kind) or "." in kind:
        raise KeyError(f"no traffic kind named {kind!r}")
    return importlib.import_module("benchmark.kinds." + kind)


def metric_path(name: str) -> str:
    """``metrics/<name>.py``, else the file of ``name`` less its last
    ``.<part>``, and so on."""
    stem = name
    while True:
        path = os.path.join(BENCH_DIR, "metrics", stem + ".py")
        if os.path.exists(path):
            return path
        if "." not in stem:
            raise KeyError(f"no reader for metric {name!r} under benchmark/metrics")
        stem = stem.rsplit(".", 1)[0]


def metric_module(name: str):
    path = metric_path(name)
    stem = os.path.basename(path)[:-3]
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + stem.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantity(metric: str) -> str:
    """The runner's quantity an end-to-end metric reports."""
    return metric.split(".", 1)[0]


def metrics_for(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` that ``cell`` reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name is forbidden."""
    return sorted({n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN})


def imported_names(path: str) -> set:
    """Top-level names of every module a Python file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def reference_imports() -> set:
    ref = os.path.join(BENCH_DIR, "reference")
    return set().union(*(imported_names(os.path.join(ref, f))
                         for f in sorted(os.listdir(ref)) if f.endswith(".py")))


def guard(stage: str) -> None:
    """Raise if JAX or the JAX package is loaded, or the reference imports
    the program (``stage`` names the point of the run)."""
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded {stage}: {', '.join(bad[:20])}")
    leak = reference_imports() & set(FORBIDDEN + (PROGRAM,))
    if leak:
        raise SystemExit(f"the reference imports {sorted(leak)}")


def range_targets(spec: dict, cell: str, kind) -> List[Tuple[str, str]]:
    """The program's callables to wrap in ranges in ``cell``'s traced
    stretch: the kind's own (``RANGES``, for naming the idle gaps) and each
    of the cell's per-layer metrics' ``RANGE``."""
    out = list(getattr(kind, "RANGES", ()))
    for m in metrics_for(spec, cell, "per_layer"):
        target = getattr(metric_module(m["name"]), "RANGE", None)
        if target is not None and tuple(target) not in out:
            out.append(tuple(target))
    return out


def range_name(target: Tuple[str, str]) -> str:
    """The profiler range of a wrapped callable: ``bench.<module's last
    part>.<attribute>``."""
    module, attr = target
    return f"bench.{module.rsplit('.', 1)[-1]}.{attr}"


def free_device(device) -> int:
    """Collect what the program left and return the run's peak of device
    memory, read before anything of the reference runs."""
    import torch

    gc.collect()
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    peak = int(torch.cuda.max_memory_allocated(device))
    torch.cuda.empty_cache()
    return peak


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ------------------------------------------------------------------ trace


@dataclass
class DeviceOp:
    name: str
    start: float  # seconds, the profiler's clock
    end: float
    corr: int


class EndWindow(Exception):
    """Raised from inside the program's loop to end a run once its window
    (or its traced stretch) has closed."""


@dataclass
class TraceData:
    """A traced stretch reduced for the per-layer readers: the device
    operations and the device time of the operations launched inside each
    of the benchmark's ranges, with what each traced unit (a training
    iteration or a view) ran.  Before the trace, the runner timed an
    untraced stretch of ``plain_units`` (``plain_s`` seconds, the device
    synchronised at both ends): the profiler's host cost slows the traced
    stretch, so a share of the real wall time takes its wall from there.
    ``count(unit)`` gives the work the reference's lists count for a unit
    (``work.blend_counts``)."""

    kind: str  # the traffic kind
    window_s: float
    ops: List[DeviceOp] = field(default_factory=list)
    ranges: Dict[str, List[float]] = field(default_factory=dict)  # name -> device s per call
    host: List[tuple] = field(default_factory=list)  # (name, start, end) of the ranges
    units: list = field(default_factory=list)
    plain_units: list = field(default_factory=list)
    plain_s: float = 0.0
    shapes: dict = field(default_factory=dict)
    count: Optional[Callable] = None
    _counted: dict = field(default_factory=dict)

    def work(self, units) -> List[dict]:
        """The reference's work counts of each of ``units``."""
        if self.count is None:
            return []
        for u in units:
            if u not in self._counted:
                self._counted[u] = self.count(u)
        return [self._counted[u] for u in units]

    def range_calls(self, target: Tuple[str, str]) -> List[float]:
        """Device seconds of each call of a wrapped callable."""
        return self.ranges.get(range_name(target), [])

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, -1e300
        for op in sorted(self.ops, key=lambda o: o.start):
            s = max(op.start, end)
            if op.end > s:
                total += op.end - s
            end = max(end, op.end)
        return total

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(o.end - o.start for o in self.ops if any(n in o.name for n in names))

    def gaps(self, top: int = 10) -> List[list]:
        """The longest idle stretches of the device, each named by the
        innermost benchmark range open on the host when it began."""
        ops = sorted(self.ops, key=lambda o: o.start)
        out = []
        end = ops[0].end if ops else 0.0
        for op in ops[1:]:
            if op.start > end:
                out.append((end, op.start - end))
            end = max(end, op.end)
        out.sort(key=lambda x: -x[1])
        named = []
        for t, dur in out[:top]:
            inner = [(s, n) for n, s, e in self.host if s <= t <= e]
            named.append([max(inner)[1] if inner else "host", dur])
        return named

    def top_ops(self, top: int = 10) -> List[list]:
        agg: Dict[str, float] = {}
        for o in self.ops:
            agg[o.name[:120]] = agg.get(o.name[:120], 0.0) + (o.end - o.start)
        return [[k, v] for k, v in sorted(agg.items(), key=lambda kv: -kv[1])[:top]]


@dataclass
class Outcome:
    """What a runner hands back: its end-to-end quantities, set-up, the
    work attempted and failed, the device's peak, the numbers compared and,
    traced, the reduced trace."""

    e2e: Dict[str, float]
    setup_s: float
    attempted: int
    failed: int
    memory_peak_bytes: int
    numbers: Dict[str, float]
    trace: Optional[TraceData] = None
    notes: List[str] = field(default_factory=list)


class Ranges:
    """``record_function`` ranges around the program's callables, for a
    traced stretch: each ``(module, attribute)`` runs inside the range
    ``range_name`` gives it."""

    def __init__(self, targets):
        self.targets = targets  # [(module's dotted name, attribute)]
        self.saved = []

    def __enter__(self):
        from torch.profiler import record_function

        for module, attr in self.targets:
            mod, name = importlib.import_module(module), range_name((module, attr))
            real = getattr(mod, attr)

            def wrapped(*a, _real=real, _name=name, **k):
                with record_function(_name):
                    return _real(*a, **k)

            self.saved.append((mod, attr, real))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, real in reversed(self.saved):
            setattr(mod, attr, real)
        self.saved = []


@contextmanager
def profiled(out: dict):
    """Profile the body (host and device); on exit put the profiler's raw
    events into ``out["events"]``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    out["events"] = prof.profiler.kineto_results.events()


RUNTIME_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def _event_class(e) -> Optional[str]:
    """What a raw profiler event is, from its device and its name: an
    operation on the device ("device"), a runtime call on the host that
    launches one ("launch"), one of the benchmark's ranges on the host
    ("range"), or nothing the readers use (None)."""
    name = e.name()
    bench = name.startswith("bench.")
    if str(e.device_type()).endswith("CUDA"):
        return None if bench else "device"
    if bench:
        return "range"
    return "launch" if name.startswith(RUNTIME_PREFIXES) else None


def reduce_trace(events, kind: str, window_s: float) -> TraceData:
    """Device operations and the benchmark's ranges ("bench." names) from
    the profiler's events.  A range's device time sums the operations whose
    launch (a runtime call on the host) lies inside it."""
    ops, launches, host = [], [], []
    for e in events:
        what = _event_class(e)
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        if what == "device":
            ops.append(DeviceOp(e.name(), s, s + d, e.correlation_id()))
        elif what == "launch":
            launches.append((s, e.correlation_id()))
        elif what == "range":
            host.append((e.name(), s, s + d))
    dur = {o.corr: o.end - o.start for o in ops}
    launches.sort()
    starts = [t for t, _ in launches]
    ranges: Dict[str, List[float]] = {}
    for name, s, e in host:
        lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
        ranges.setdefault(name, []).append(sum(dur.get(c, 0.0) for _, c in launches[lo:hi]))
    return TraceData(kind=kind, window_s=window_s, ops=ops, ranges=ranges, host=host)


# ------------------------------------------------------------------ result


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; then the result as the last line of standard output,
    with the checks as its last key."""
    for name, c in checks.items():
        verdict = "ok" if c["ok"] else "FAILED"
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    print(json.dumps(line), flush=True)
