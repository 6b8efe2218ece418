"""BENCHMARK.json against the rules a benchmark spec keeps, and every file a cell
names found by name."""

import json
import os
import re

import pytest

from benchmark import harness as hn

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return hn.load_spec()


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(spec):
    assert set(spec) == KEYS["top"]
    assert os.path.getsize(hn.SPEC_PATH) <= 64 * 1024
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[section]:
            extra = set(entry) - KEYS[section]
            assert extra <= ({"workloads"} if section in ("end_to_end", "per_layer") else set())
            assert KEYS[section] <= set(entry), entry["name"]


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(spec, section):
    names = [e["name"] for e in spec[section]]
    assert len(names) == len(set(names))
    for e in spec[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert line_ok(e[key]), (e["name"], key)
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_cells(spec):
    metrics = {m["name"]: m for m in spec["end_to_end"]}
    for cell in spec["workloads"]:
        assert cell["chips"] in (1, 4)
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert line_ok(cell["why"])
        e2e = [m for m in hn.metrics_for(spec, cell["name"], "end_to_end")]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = hn.metrics_for(spec, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert cell["name"] in metrics[m["moves"]].get("workloads", [cell["name"]])
    pairs = [(c["config"], c["traffic"]) for c in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in spec["configs"]} == {c["config"] for c in spec["workloads"]}


def test_bounds(spec):
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_setup_in_every_cell(spec):
    """``setup_s`` names no cells: every cell, a later one too, reports it."""
    setup = hn.find(spec["end_to_end"], "setup_s", "metric")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_share_names(spec):
    """A kernel's share of its roofline is ``<kernel>_roofline``, a step's share
    of the peak carries ``mfu`` as a part of its name; both in percent."""
    for m in spec["per_layer"]:
        base = m["name"].split(".")[0]
        parts = base.split("_")
        if "roofline" in m["name"]:
            assert base.endswith("_roofline") and m["unit"] == "%", m["name"]
        if "mfu" in parts:
            assert m["unit"] == "%", m["name"]


def test_check_fits(spec):
    """A full check of 24 cells at ``run_seconds`` fits the driver's time, and
    at most a quarter of the cells (or one) ask for four chips."""
    cells = 24
    total = (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    four = sum(c["chips"] == 4 for c in spec["workloads"])
    assert four <= max(1, len(spec["workloads"]) // 4)


def test_files_found_by_name(spec):
    for cell in spec["workloads"]:
        cfg = hn.config_of(spec, cell)
        for key in ("num_gaussians", "sh_degree", "width", "height", "num_views", "assumed"):
            assert key in cfg
        assert cfg["reduced"] == hn.find(spec["configs"], cell["config"], "c")["reduced"]
        kind = hn.kind_module(hn.mix_of(cell)["kind"])
        assert callable(kind.run) and callable(kind.tf32_control)
        for m in hn.metrics_for(spec, cell["name"], "per_layer"):
            assert callable(hn.metric_module(m["name"]).read)
    for entry in spec["configs"]:
        assert entry["file"].startswith("benchmark/configs/")
        with open(os.path.join(hn.ROOT, entry["file"])) as f:
            json.load(f)
        assert len(entry["reduced"]) <= 16


def test_limits_cover_numbers(spec):
    """Every traffic mix gives each number it compares a limit."""
    for cell in spec["workloads"]:
        mix = hn.mix_of(cell)
        names = hn.kind_module(mix["kind"]).NUMBERS
        assert mix["limits"] and set(mix["limits"]) <= set(names)
        assert all(0 < v < 1 for v in mix["limits"].values())
