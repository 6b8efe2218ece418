"""The whole-name import check: JAX and the JAX package are flagged, the
port (whose name begins with the JAX package's) is not."""

import types

import pytest

from benchmark import harness as hn


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("gaussian_splatting_tpu", True), ("gaussian_splatting_tpu.ops.rasterize", True),
    ("gaussian_splatting_torch", False), ("gaussian_splatting_torch.ops.rasterize", False),
    ("jaxtyping", False), ("gaussian_splatting_tpu_tools", False),
])
def test_whole_top_level_names(monkeypatch, name, flagged):
    monkeypatch.setitem(__import__("sys").modules, name, types.ModuleType(name))
    assert (name in hn.forbidden_modules()) is flagged


def test_guard_raises_on_jax(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        hn.guard("in a test")


def test_reference_imports_neither_program_nor_jax():
    names = hn.reference_imports()
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "gaussian_splatting_tpu",
                        "gaussian_splatting_torch"}


def test_harness_modules_import_no_jax():
    import os

    for d, _, files in os.walk(hn.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                names = hn.imported_names(os.path.join(d, f))
                assert not names & set(hn.FORBIDDEN), f
