"""The port's analytic scenes against the JAX package's, for each of the
three scenes: the scene tables, the torch shader (float64, then float32)
against JAX's numpy raytracer on the rays of JAX's own shader test
(``test_components.py``, ``utils.testing.analytic_test_rays``), and ``generate_analytic_dataset`` with depth
maps and exposure jitter.

JAX's generator traces with a jitted float32 copy of its numpy shader, which
JAX's own test holds to the numpy one (``test_components.py``).  Compiling
that copy takes ~12 s for the 48-sphere scene on a CPU, so the
per-scene generator checks run JAX's generator with its numpy shader (the
float64 reference, swapped in on the JAX module for the test), where both
packages trace in float64; one check runs JAX's generator as it is, with
its float32 shader, on the "spheres" scene.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import gaussian_splatting_tpu.utils.synthetic_dataset as jsd
from gaussian_splatting_torch.utils import synthetic_dataset as tsd
from gaussian_splatting_torch.utils.testing import analytic_test_rays

SCENES = tsd.ANALYTIC_SCENES
SMALL = dict(num_train=2, num_test=1, width=64, height=48, depths=True, exposure_jitter=0.1)
# float64 against float64: rounding differs only in the last bits of a few
# operations (library sin / atan2 / pow, matrix-product order)
TOL_F64 = 1e-9


def _rays():
    eye, d = analytic_test_rays()
    return np.broadcast_to(eye, d.shape), d


@pytest.mark.parametrize("name", SCENES)
def test_scene_tables_match_jax(name):
    ours, our_plane = tsd._analytic_scene(0, name)
    ref, ref_plane = jsd._analytic_scene(0, name)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert our_plane.keys() == ref_plane.keys()
    for k in our_plane:
        np.testing.assert_array_equal(our_plane[k], ref_plane[k])


@pytest.mark.parametrize("name", SCENES)
def test_float64_shader_matches_jax_numpy(name):
    spheres, plane = tsd._analytic_scene(0, name)
    orig, d = _rays()
    rgb_j, a_j, t_j = jsd._shade_analytic(orig, d, spheres, plane)
    rgb, a, t = tsd.shade_analytic(torch.tensor(orig), torch.from_numpy(d), spheres, plane)
    assert rgb.dtype == a.dtype == t.dtype == torch.float64
    assert (a_j > 0).any() and (a_j == 0).any()
    np.testing.assert_array_equal(a.numpy(), a_j)
    hit = a_j > 0
    assert np.isinf(t.numpy()[~hit]).all()
    np.testing.assert_allclose(t.numpy()[hit], t_j[hit], rtol=0, atol=TOL_F64)
    np.testing.assert_allclose(rgb.numpy(), rgb_j, rtol=0, atol=TOL_F64)


@pytest.mark.parametrize("name", SCENES)
def test_float32_shader_within_jax_tolerance(name):
    """The float32 shader against JAX's numpy one, with the tolerance JAX
    holds its own float32 shader to."""
    spheres, plane = tsd._analytic_scene(0, name)
    orig, d = _rays()
    rgb_np, a_np, t_np = jsd._shade_analytic(orig, d, spheres, plane)
    rgb, a, t = tsd.shade_analytic(torch.tensor(orig), torch.from_numpy(d), spheres, plane,
                                   dtype=torch.float32)
    assert rgb.dtype == torch.float32
    rgb, a, t = (x.double().numpy() for x in (rgb, a, t))
    np.testing.assert_array_equal(a_np, a)
    hit = a_np > 0
    np.testing.assert_allclose(t[hit], t_np[hit], rtol=2e-3, atol=2e-3)
    err = np.abs(rgb - rgb_np).max(axis=1)
    assert np.quantile(err, 0.97) < 0.02, f"shading mismatch: q97={np.quantile(err, 0.97)}"


def _record_draws(monkeypatch):
    """Log every ``uniform`` draw of the generators numpy's default_rng
    makes from here on, in both packages."""
    draws = []
    real = np.random.default_rng

    class Recorder:
        def __init__(self, seed):
            self._rng = real(seed)

        def uniform(self, *args, **kw):
            v = self._rng.uniform(*args, **kw)
            draws.append(np.copy(v))
            return v

    monkeypatch.setattr(np.random, "default_rng", Recorder)
    return draws


def _files(root):
    out = {}
    for sub in ("train", "test", "depths"):
        for name in sorted(os.listdir(os.path.join(root, sub))):
            with Image.open(os.path.join(root, sub, name)) as im:
                out[f"{sub}/{name}"] = np.asarray(im).astype(np.int64)
    return out


def _compare_datasets(ours, ref):
    for split in ("train", "test"):
        with open(os.path.join(ours, f"transforms_{split}.json")) as f:
            a = json.load(f)
        with open(os.path.join(ref, f"transforms_{split}.json")) as f:
            b = json.load(f)
        assert a == b
    fa, fb = _files(ours), _files(ref)
    assert fa.keys() == fb.keys() and len(fa) == 3 + 3
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        diff = np.abs(fa[k] - fb[k])
        assert (diff <= 1).mean() >= 0.99, (k, (diff <= 1).mean())
        assert fa[k].any(), k
    return fa, fb


@pytest.mark.parametrize("name", SCENES)
def test_generate_matches_jax(name, tmp_path, monkeypatch):
    draws = _record_draws(monkeypatch)
    monkeypatch.setattr(jsd, "_shade_analytic_fast", jsd._shade_analytic)
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsd.generate_analytic_dataset(ref, scene_name=name, **SMALL)
    n_ref = len(draws)
    tsd.generate_analytic_dataset(ours, scene_name=name, device="cpu", **SMALL)
    assert len(draws) == 2 * n_ref
    for a, b in zip(draws[:n_ref], draws[n_ref:]):
        np.testing.assert_array_equal(a, b)
    fa, fb = _compare_datasets(ours, ref)
    # both trace in float64: all but last-bit rounding flips are equal
    for k in fa:
        assert (fa[k] == fb[k]).mean() >= 0.999, (k, (fa[k] == fb[k]).mean())


def test_generate_matches_jax_float32_shader(tmp_path):
    ref, ours = str(tmp_path / "jax"), str(tmp_path / "torch")
    jsd.generate_analytic_dataset(ref, scene_name="spheres", **SMALL)
    tsd.generate_analytic_dataset(ours, scene_name="spheres", device="cpu", **SMALL)
    _compare_datasets(ours, ref)


def test_generate_needs_a_device_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsd.generate_analytic_dataset(str(tmp_path / "x"), **SMALL)
