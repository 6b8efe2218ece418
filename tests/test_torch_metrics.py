"""The port's evaluation suite against the JAX package's: LPIPS on seeded
random weights of VGG16's real shapes (no pretrained weights can be fetched;
they are written as ``tests/test_lpips.py`` writes them), ``metrics.evaluate``
against the root ``metrics.py``, the LPIPS weights lookup, and the commands
``full_eval`` runs against the root ``full_eval.py``'s."""

import importlib.util
import json
import os
import shlex
import sys

import numpy as np
import pytest
import torch
from test_lpips import _random_weights

from gaussian_splatting_torch import full_eval, metrics
from gaussian_splatting_torch import render as render_cli
from gaussian_splatting_torch.ops.lpips import make_lpips
from gaussian_splatting_torch.train import cli as train_cli
from gaussian_splatting_torch.utils.image import write_image
from gaussian_splatting_torch.utils.testing import random_lpips_weights
from gaussian_splatting_tpu.ops.lpips import make_lpips as jax_make_lpips

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
# PSNR is held relatively: a float32 mean squared error summed in another
# order moves a 30 dB PSNR by about 1e-5 dB (1.24e-5 on these images)
TOL_PSNR_REL = 1e-5


def _close(key, ours, ref):
    return abs(ours - ref) <= (TOL_PSNR_REL * abs(ref) if key == "PSNR" else TOL)


def _root_module(name):
    """The repository's root script ``<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_rand.npz")
    raw = random_lpips_weights(np.random.default_rng(0))
    ref = _random_weights(np.random.default_rng(0))
    assert raw.keys() == ref.keys() and sum(v.size for v in raw.values()) == 14_716_160
    for k, v in ref.items():
        np.testing.assert_array_equal(raw[k], v)
    np.savez(path, **raw)
    return path


@pytest.mark.parametrize("shape", [(48, 64), (45, 67)])
def test_lpips_matches_jax(weights, shape):
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.08, a.shape), 0, 1).astype(np.float32)
    ours = make_lpips(weights, device="cpu")
    ref = jax_make_lpips(weights)(a, b)
    assert ref > 0
    assert abs(ours(a, b) - ref) <= TOL
    assert abs(ours(torch.from_numpy(a), torch.from_numpy(b)) - ref) <= TOL
    assert abs(ours(a, a.copy())) < 1e-8


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory with two methods of seeded 64x48 test renders."""
    root = str(tmp_path_factory.mktemp("model"))
    rng = np.random.default_rng(2)
    for method, noise in (("ours_1", 40), ("ours_7", 8)):
        for sub in ("renders", "gt"):
            os.makedirs(os.path.join(root, "test", method, sub))
        for i in range(2):
            gt = rng.integers(0, 256, (48, 64, 3))
            render = np.clip(gt + rng.normal(0, noise, gt.shape), 0, 255)
            name = f"{i:05d}.png"
            write_image(os.path.join(root, "test", method, "gt", name), gt.astype(np.uint8))
            write_image(os.path.join(root, "test", method, "renders", name),
                        render.astype(np.uint8))
    return root


def _outputs(model_dir):
    with open(os.path.join(model_dir, "results.json")) as f:
        results = json.load(f)
    with open(os.path.join(model_dir, "per_view.json")) as f:
        per_view = json.load(f)
    return results, per_view


def _labels(text):
    return [ln.split(":")[0] for ln in text.splitlines()]


@pytest.mark.parametrize("with_lpips", [False, True], ids=["no_lpips", "lpips"])
def test_evaluate_matches_root_metrics(model_dir, weights, with_lpips, capsys):
    jax_metrics = _root_module("metrics")
    jax_metrics.evaluate([model_dir], jax_make_lpips(weights) if with_lpips else None)
    ref, ref_views = _outputs(model_dir)
    ref_text = capsys.readouterr().out
    metrics.evaluate([model_dir], make_lpips(weights, device="cpu") if with_lpips else None,
                     device="cpu")
    ours, our_views = _outputs(model_dir)
    assert _labels(capsys.readouterr().out) == _labels(ref_text)
    with open(os.path.join(model_dir, "results.json")) as f:
        assert f.read().startswith('{\n "ours_1": {\n  "SSIM"')  # json indent=True
    assert ours.keys() == ref.keys() == {"ours_1", "ours_7"}
    for method in ref:
        assert ours[method].keys() == ref[method].keys()
        for key in ("SSIM", "PSNR"):
            assert _close(key, ours[method][key], ref[method][key]), (method, key)
        assert our_views[method].keys() == ref_views[method].keys()
        for key, views in ref_views[method].items():
            assert our_views[method][key].keys() == views.keys()
            for name, v in views.items():
                ov = our_views[method][key][name]
                assert (ov is None) == (v is None)
                if v is not None:
                    assert _close(key, ov, v), (method, key, name)
        if with_lpips:
            assert abs(ours[method]["LPIPS"] - ref[method]["LPIPS"]) <= TOL
        else:
            assert ours[method]["LPIPS"] is None and ref[method]["LPIPS"] is None
    assert ours["ours_7"]["PSNR"] > ours["ours_1"]["PSNR"] + 5


def test_lpips_weights_lookup_order(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.delenv("GS_LPIPS_WEIGHTS", raising=False)
    cached = str(home / ".cache" / "gs_lpips_vgg16.npz")
    assert metrics.lpips_weights_path("") == cached
    monkeypatch.setenv("GS_LPIPS_WEIGHTS", "/env/w.npz")
    assert metrics.lpips_weights_path("") == "/env/w.npz"
    assert metrics.lpips_weights_path("/flag/w.npz") == "/flag/w.npz"


def test_metrics_cli_weights(model_dir, weights, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("GS_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError):
        metrics.main(["-m", model_dir, "--lpips_weights", str(tmp_path / "missing.npz"),
                      "--device", "cpu"])
    report = metrics.main(["-m", model_dir, "--device", "cpu"])
    assert "LPIPS weights not found" in capsys.readouterr().out
    assert report[model_dir]["ours_1"]["LPIPS"] is None
    monkeypatch.setenv("GS_LPIPS_WEIGHTS", weights)
    report = metrics.main(["-m", model_dir, "--device", "cpu"])
    assert report[model_dir]["ours_1"]["LPIPS"] > 0


def test_entry_points_need_a_device_without_a_card(model_dir, weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: metrics.main(["-m", model_dir]),
                 lambda: metrics.evaluate([model_dir]),
                 lambda: make_lpips(weights),
                 lambda: full_eval.main(["-tat", "/data/tat"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


_MODULES = {"train.py": "train", "render.py": "render", "metrics.py": "metrics"}
_PARSERS = {"train": train_cli._parser(), "render": render_cli._parser(),
            "metrics": metrics._parser()}


@pytest.mark.parametrize("extra", [[], ["--use_depth"], ["--use_expcomp"], ["--aa"], ["--fast"]],
                         ids=["plain", "depth", "expcomp", "aa", "fast"])
def test_full_eval_commands_match_root(extra, tmp_path, monkeypatch):
    jax_eval = _root_module("full_eval")
    argv = ["-m360", "/data/m360", "-tat", "/data/tat", "-db", "/data/db",
            "--output_path", str(tmp_path / "eval")] + extra
    ref, ours = [], []
    monkeypatch.setattr(jax_eval, "run", ref.append)
    monkeypatch.setattr(full_eval, "run", ours.append)
    monkeypatch.setattr(sys, "argv", ["full_eval.py"] + argv)
    jax_eval.main()
    full_eval.main(argv + ["--device", "cpu"])

    expected = []
    for cmd in ref:
        python, script, *args = shlex.split(cmd)
        assert python == "python"
        expected.append([sys.executable, "-m", f"gaussian_splatting_torch.{_MODULES[script]}",
                         *args, "--device", "cpu"])
    assert ours == expected
    assert len(ours) == 13 * 3 + 1
    for cmd in ours:
        args = _PARSERS[cmd[2].rsplit(".", 1)[1]].parse_args(cmd[3:])
        assert args.device == "cpu"
    with open(tmp_path / "eval" / "timing.txt") as f:
        assert len(f.read().splitlines()) == 2 * 13  # both suites appended
