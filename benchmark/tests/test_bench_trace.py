"""The profiler's events reduced to device intervals and to the benchmark's
ranges, on a few events made by hand; the readers on a trace made by hand;
and the lookup of metric files and of the program's callables they wrap."""

import importlib

import pytest

from benchmark import harness as hn

OPTIM = ("gaussian_splatting_torch.train.step", "apply_gradients")


class Event:
    """What ``reduce_trace`` reads of a raw profiler event."""

    def __init__(self, name, device, start_us, dur_us, corr=0):
        self._name, self._device = name, device
        self._start, self._dur, self._corr = int(start_us * 1000), int(dur_us * 1000), corr

    def name(self):
        return self._name

    def device_type(self):
        return "DeviceType." + self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr


def events():
    rng = hn.range_name(OPTIM)
    return [
        Event(rng, "CPU", 100, 50),  # the range on the host
        Event("aten::add", "CPU", 105, 10),  # an operator: not read
        Event("cudaLaunchKernel", "CPU", 110, 2, corr=1),  # inside the range
        Event("cudaMemcpyAsync", "CPU", 120, 2, corr=2),  # inside the range
        Event("cudaLaunchKernel", "CPU", 200, 2, corr=3),  # outside it
        Event(rng, "CUDA", 130, 40),  # the range as the device sees it: not an op
        Event("blend_forward_kernel(...)", "CUDA", 130, 20, corr=1),
        Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 140, 20, corr=2),  # overlaps
        Event("vectorized_elementwise_kernel", "CUDA", 210, 10, corr=3),
    ]


def test_reduce_trace_device_ops_and_ranges():
    tr = hn.reduce_trace(events(), "train_resume", window_s=200e-6)
    assert sorted(o.corr for o in tr.ops) == [1, 2, 3]
    # the range holds the two operations launched inside it, not the third
    assert tr.range_calls(OPTIM) == [pytest.approx(40e-6)]
    assert tr.host == [(hn.range_name(OPTIM), pytest.approx(100e-6), pytest.approx(150e-6))]
    # 130-160 merged with 210-220
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.kernel_s(("blend_forward_kernel",)) == pytest.approx(20e-6)
    # the one gap, 160-210, begins after the range closed on the host
    assert tr.gaps() == [["host", pytest.approx(50e-6)]]
    assert tr.top_ops()[0][1] == pytest.approx(20e-6)


def test_gap_named_by_the_open_range():
    evs = events() + [Event(hn.range_name(OPTIM), "CPU", 155, 100)]
    assert hn.reduce_trace(evs, "train_resume", 200e-6).gaps()[0][0] == hn.range_name(OPTIM)


def test_readers_on_a_trace():
    tr = hn.reduce_trace(events(), "train_resume", window_s=200e-6)
    tr.units, tr.plain_units, tr.plain_s = [7, 8], [5, 6], 100e-6
    counts = []
    tr.count = lambda u: counts.append(u) or dict(
        visited=1024, replayed=768, contributing=768, saturated=256, read_fwd=4, read_bwd=3,
        tiles=1, instances=10)
    tr.shapes = {"capacity": 100, "pixels": 256}
    idle = hn.metric_module("device_idle_pct.train").read(tr)
    assert idle == pytest.approx(100.0 * (1.0 - 20e-6 / 50e-6))
    assert hn.metric_module("device_ops_per_iter").read(tr) == 1.5
    assert hn.metric_module("optim_device_ms").read(tr) == pytest.approx(0.04)
    assert hn.metric_module("sort_device_ms.view").read(tr) is None  # no such range traced
    from benchmark import work

    w = tr.work([5])[0]
    assert hn.metric_module("train_mfu_pct").read(tr) == pytest.approx(
        100.0 * 2 * work.train_step_s(w, 100, 256) / 100e-6)
    k2 = hn.metric_module("k2_roofline.train").read(tr)
    assert k2 == pytest.approx(100.0 * 2 * work.roofline_s(*work.k2(w)) / 20e-6)
    assert hn.metric_module("k5_roofline").read(tr) is None  # K5 not in the trace
    assert hn.metric_module("view_mfu_pct").read(tr) is None  # not a view trace
    assert counts == [5, 6, 7, 8]  # each unit counted once


@pytest.mark.parametrize("name,file", [
    ("device_ops_per_iter", "device_ops_per_iter.py"),
    ("k2_roofline.view", "k2_roofline.py"),
    ("k2_roofline.view.outdoor", "k2_roofline.py"),
    ("sort_device_ms.view_outdoor", "sort_device_ms.py"),
])
def test_metric_file_by_name(name, file):
    assert hn.metric_path(name).endswith("/metrics/" + file)


def test_unknown_metric_and_kind():
    with pytest.raises(KeyError):
        hn.metric_path("no_such_metric.view")
    with pytest.raises(KeyError):
        hn.kind_module("../run")


def test_end_to_end_quantity():
    assert hn.quantity("views_per_s.outdoor") == "views_per_s"
    assert hn.quantity("setup_s") == "setup_s"


def test_ranges_name_callables_of_the_program():
    """Every range a cell's trace asks for wraps a callable the program has,
    and is put back after the stretch."""
    spec = hn.load_spec()
    for cell in spec["workloads"]:
        kind = hn.kind_module(hn.mix_of(cell)["kind"])
        targets = hn.range_targets(spec, cell["name"], kind)
        assert set(kind.RANGES) <= set(targets)
        for module, attr in targets:
            assert callable(getattr(importlib.import_module(module), attr)), (module, attr)
    mod = importlib.import_module(OPTIM[0])
    real = mod.apply_gradients
    with hn.Ranges([OPTIM]):
        assert mod.apply_gradients is not real
    assert mod.apply_gradients is real
