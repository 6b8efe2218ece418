"""Port parity for the host training loop (``train/loop.py``) and the
training CLI (``train/cli.py``).

- Overflow handling with JAX's ``_fake_overflow_step`` pattern
  (``tests/test_pipeline_e2e.py``): an overflowed step changes nothing, the
  slack doubles once per overflow burst, and four doublings abort.  JAX's
  fake overflows per compiled slack value; the port's per slack value.
- A fake-step run past iteration 1000 checks the SH ramp and the densify /
  opacity-reset schedule.
- Under one seed the port's loop visits the cameras in JAX's order.
- Three real iterations of the port's ``train()`` (the kernels' twins)
  against JAX's ``train()`` through its dense oracle: losses within 1e-5,
  Adam moments and (99% of the solid) parameters at
  ``tests/test_torch_train_step.py``'s one-step tolerances times the 3
  steps they accumulate over; the same with ``random_background`` (numpy's
  seeded draws stay aligned between the loops), and with antialiasing,
  sparse Adam and the exposure affine together (exposures and their moments
  too).
- The counterparts of JAX's ``tests/test_pipeline_e2e.py``: the training
  report through ``tb_writer``, a short run through a densification window
  (its loss, snapshot and kept slack), and a checkpoint's round trip.

The CLI's own test is ``tests/test_torch_train_cli.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.config import ModelConfig as JaxModelConfig
from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
from gaussian_splatting_tpu.config import PipelineConfig as JaxPipe
from gaussian_splatting_tpu.train import loop as jloop
from gaussian_splatting_tpu.train.step import group_lrs
from gaussian_splatting_torch.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                                             RasterizeConfig)
from gaussian_splatting_torch.data.ply import save_point_cloud_ply
from gaussian_splatting_torch.models.gaussians import load_model_ply
from gaussian_splatting_torch.train import loop
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset

PARAMS = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("loop_scene"))
    generate_blender_dataset(out, num_train=5, num_test=2, width=32, height=24,
                             num_gaussians=150, device="cpu")
    rng = np.random.default_rng(5)
    save_point_cloud_ply(os.path.join(out, "points3d.ply"),
                         rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32),
                         rng.integers(0, 256, (300, 3), dtype=np.uint8))
    return out


def _packed(ovf):
    return [0.5, 0.5, 0.0, float(ovf), 100.0, 10.0]  # loss, l1, depth, overflow, demand, alive


def _port_fake(slacks, overflow_doublings):
    """A ``train_step`` that overflows (changing nothing) until the slack has
    doubled ``overflow_doublings`` times, and otherwise moves every mean by 1
    and counts the step."""
    def fake(state, cam, batch, *, opt, raster, use_exposure=False, use_depth=False):
        slacks.append(raster.instance_slack)
        ovf = raster.instance_slack < slacks[0] * 2 ** overflow_doublings
        if not ovf:
            with torch.no_grad():
                state.model.means3d.add_(1.0)
            state.step.add_(1)
        packed = torch.tensor(_packed(ovf))
        return state, {"loss": packed[0], "packed": packed, "campos": cam.campos}
    return fake


def _jax_fake(traces, overflow_traces):
    """JAX's pattern: the first ``overflow_traces`` compiled steps overflow."""
    import dataclasses as dc

    def fake(state, cam, batch, *, opt, raster, use_exposure=False, use_depth=False):
        traces.append(raster.instance_slack)
        ovf = len(traces) <= overflow_traces
        if not ovf:
            p = state.model.params
            model = dc.replace(state.model, params=p._replace(means3d=p.means3d + 1.0))
            state = dc.replace(state, model=model, step=state.step + 1)
        packed = jnp.asarray(_packed(ovf), jnp.float32)
        return state, {"loss": packed[0], "packed": packed, "campos": cam.campos}
    return fake


def _cfgs(dataset, model_dir, iterations, **opt_kw):
    opt = dict(iterations=iterations, densify_from_iter=10_000, **opt_kw)
    return ((ModelConfig(source_path=dataset, model_path=model_dir, eval=True),
             OptimizationConfig(**opt), PipelineConfig()),
            (JaxModelConfig(source_path=dataset, model_path=model_dir + "_jax", eval=True),
             JaxOpt(**opt), JaxPipe()))


def test_overflow_steps_are_noops_and_growth_recovers(dataset, tmp_path, monkeypatch, capsys):
    port_cfg, jax_cfg = _cfgs(dataset, str(tmp_path / "m"), 6)
    slacks, traces = [], []
    monkeypatch.setattr(loop, "train_step", _port_fake(slacks, 2))
    monkeypatch.setattr(jloop, "train_step", _jax_fake(traces, 2))
    kw = dict(test_iterations=(), save_iterations=(), quiet=True, capacity=512)
    state = loop.train(*port_cfg, device="cpu", **kw)
    port_log = capsys.readouterr().out
    jstate = jloop.train(*jax_cfg, **kw)
    jax_log = capsys.readouterr().out
    s0 = slacks[0]
    # two bursts, each doubling once; the steps queued before a doubling
    # overflow too and are dropped as stale
    assert slacks == [s0, s0, 2 * s0, 2 * s0, 4 * s0, 4 * s0]
    assert sorted(set(slacks)) == sorted(traces)  # JAX compiled once per slack
    assert int(state.step) == int(jstate.step) == 2
    alive = state.model.alive.numpy()
    shift = state.model.means3d.detach().numpy() - np.asarray(jstate.model.params.means3d)
    assert np.abs(shift[alive]).max() < 1e-5  # only the 2 clean steps moved
    pick = lambda log: [ln for ln in log.splitlines() if "overflow" in ln]
    assert pick(port_log) == pick(jax_log) and len(pick(port_log)) == 2


def test_overflow_persistent_exhaustion_aborts(dataset, tmp_path, monkeypatch, capsys):
    port_cfg, _ = _cfgs(dataset, str(tmp_path / "m"), 30)
    slacks = []
    monkeypatch.setattr(loop, "train_step", _port_fake(slacks, 64))
    with pytest.raises(RuntimeError, match="overflow"):
        loop.train(*port_cfg, test_iterations=(), save_iterations=(), quiet=True,
                   capacity=512, device="cpu")
    assert max(slacks) == slacks[0] * 8  # three doublings applied, the 4th aborts
    assert capsys.readouterr().out.count("(4 consecutive)") == 1


def test_schedule_and_sh_ramp(dataset, tmp_path, monkeypatch):
    """1100 fake iterations: densify every 100 in (100, 600), opacity resets
    at 300 (an interval) and at 100 (densify_from_iter, white background),
    the screen-size limit only past the first reset interval, the SH degree
    up by one at 1000."""
    port_cfg, _ = _cfgs(dataset, str(tmp_path / "m"), 1100, densification_interval=100,
                        densify_until_iter=600, opacity_reset_interval=300)
    mcfg, opt, pipe = port_cfg
    opt.densify_from_iter = 100
    mcfg.white_background = True
    slacks, events, sh = [], [], {}
    monkeypatch.setattr(loop, "train_step", _port_fake(slacks, 0))

    def densify(state, generator, *, opt, max_screen_size):
        events.append(("densify", int(state.step), max_screen_size))
        return state, {"dropped": torch.tensor(0)}

    def reset(state):
        events.append(("reset", int(state.step)))
        return state

    monkeypatch.setattr(loop, "densify_step", densify)
    monkeypatch.setattr(loop, "opacity_reset_step", reset)
    loop.train(mcfg, opt, pipe, test_iterations=(), save_iterations=(), quiet=True,
               capacity=512, device="cpu",
               on_iteration=lambda it, state, m: sh.setdefault(state.model.sh_degree, it))
    assert events == [("reset", 100), ("densify", 200, 0), ("densify", 300, 0), ("reset", 300),
                      ("densify", 400, 20), ("densify", 500, 20)]
    assert sh == {0: 1, 1: 1000}


def test_camera_order_matches_jax(dataset, tmp_path, monkeypatch):
    port_cfg, jax_cfg = _cfgs(dataset, str(tmp_path / "m"), 12)
    monkeypatch.setattr(loop, "train_step", _port_fake([], 0))
    monkeypatch.setattr(jloop, "train_step", _jax_fake([], 0))
    seen = {"port": [], "jax": []}
    kw = dict(test_iterations=(), save_iterations=(), quiet=True, capacity=512, seed=3)
    loop.train(*port_cfg, device="cpu", **kw,
               on_iteration=lambda it, s, m: seen["port"].append(m["campos"].numpy()))
    jloop.train(*jax_cfg, **kw,
                on_iteration=lambda it, s, m: seen["jax"].append(np.asarray(m["campos"])))
    assert len(seen["port"]) == len(seen["jax"]) == 12
    np.testing.assert_allclose(np.stack(seen["port"]), np.stack(seen["jax"]), atol=1e-6)
    assert len({tuple(np.round(c, 4)) for c in seen["port"][:5]}) == 5  # one epoch, 5 views


def test_three_real_iterations_match_jax(dataset, tmp_path):
    _three_real_iterations(dataset, tmp_path)


@pytest.mark.parametrize("switches", ["random_background", "antialiasing+sparse_adam+exposure"])
def test_three_real_iterations_match_jax_with_switches(dataset, tmp_path, switches):
    """The same under the training switches that change the step: an
    uncached batch with a background drawn from numpy's seeded generator
    each iteration; and the antialiasing filter, sparse Adam and the
    exposure affine (``--train_test_exp``) together."""
    _three_real_iterations(dataset, tmp_path, switches=switches)


def _three_real_iterations(dataset, tmp_path, switches=""):
    opt_kw = {}
    if switches == "random_background":
        opt_kw["random_background"] = True
    elif switches:
        opt_kw["optimizer_type"] = "sparse_adam"
    port_cfg, jax_cfg = _cfgs(dataset, str(tmp_path / "m"), 3, **opt_kw)
    jax_cfg[2].rasterizer_impl = "dense"
    if switches.startswith("antialiasing"):
        for mcfg, _, pipe in (port_cfg, jax_cfg):
            mcfg.train_test_exp = True
            pipe.antialiasing = True
    losses = {"port": [], "jax": []}
    kw = dict(test_iterations=(), save_iterations=(), quiet=True, capacity=512, seed=1)
    state = loop.train(*port_cfg, device="cpu", **kw,
                       on_iteration=lambda it, s, m: losses["port"].append(float(m["loss"])))
    jstate = jloop.train(*jax_cfg, **kw,
                         on_iteration=lambda it, s, m: losses["jax"].append(float(m["loss"])))
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-5, rtol=0)
    assert int(state.step) == int(jstate.step) == 3
    np.testing.assert_array_equal(state.model.alive.numpy(), np.asarray(jstate.model.aux.alive))
    lrs = {k: float(v) for k, v in group_lrs(JaxOpt(), 1, jstate.model.spatial_lr_scale)
           ._asdict().items()}  # the largest of the 3 steps' rates
    for name in PARAMS:
        j_mu = np.asarray(getattr(jstate.adam.mu, name))
        scale = np.abs(j_mu).max() + 1e-30
        np.testing.assert_allclose(state.adam.mu[name].numpy() / scale, j_mu / scale,
                                   atol=3 * 3e-4, err_msg=name)
        solid = np.abs(j_mu) > 1e-3 * np.abs(j_mu).max()
        diff = np.abs(getattr(state.model, name).detach().numpy()
                      - np.asarray(getattr(jstate.model.params, name)))
        # Adam moves even a dust gradient by a whole step, so a dust gradient
        # whose sign differs in one of the 3 steps moves that entry by up to
        # 2 lr; every other solid entry stays within the one-step tolerance
        assert not solid.any() or (diff[solid] <= 3 * 3e-4 * lrs[name]).mean() >= 0.99, name
        assert diff.max() <= 3 * 2 * lrs[name], name
    if switches.startswith("antialiasing"):
        # the exposures moved, as JAX's did (test_torch_train_step.py's
        # one-step tolerance on them, times 3 steps)
        j_exp = np.asarray(jstate.exposures)
        assert np.abs(j_exp - np.eye(3, 4, dtype=np.float32)).max() > 0
        np.testing.assert_allclose(state.exposures.numpy(), j_exp, atol=3 * 3e-4 * 0.01, rtol=0)
        j_mu = np.asarray(jstate.exp_adam.mu)
        np.testing.assert_allclose(state.exp_adam.mu["exposures"].numpy() / np.abs(j_mu).max(),
                                   j_mu / np.abs(j_mu).max(), atol=3 * 3e-4)


class _Writer:
    """A stand-in for tensorboard's ``SummaryWriter``: each call's tag and
    step, and its value's checks."""

    def __init__(self):
        self.scalars, self.images, self.hists = {}, {}, {}

    def add_scalar(self, tag, value, step):
        assert np.isfinite(value), tag
        self.scalars.setdefault(tag, {})[step] = float(value)

    def add_images(self, tag, img, global_step=None):
        assert img.ndim == 4 and img.min() >= 0 and img.max() <= 1, tag
        self.images.setdefault(tag, []).append((global_step, img.shape))

    def add_histogram(self, tag, values, step):
        assert len(values) > 0, tag
        self.hists.setdefault(tag, {})[step] = np.asarray(values)


def test_training_report_writes_the_jax_events(dataset, tmp_path):
    """The training report through ``tb_writer``, as JAX's
    ``test_pipeline_e2e.py::test_observability_events`` holds JAX's: the
    loss, point count and iteration time of every step, and at a test
    iteration each split's L1 and PSNR, its views' renders (ground truth on
    the first report) and the opacity histogram of the live Gaussians."""
    port_cfg, _ = _cfgs(dataset, str(tmp_path / "m"), 8)
    writer = _Writer()
    state = loop.train(*port_cfg, test_iterations=(5,), save_iterations=(), quiet=True,
                       capacity=512, seed=1, tb_writer=writer, device="cpu")
    steps = set(range(1, 9))
    for tag in ("train_loss_patches/l1_loss", "train_loss_patches/total_loss", "iter_time"):
        assert set(writer.scalars[tag]) == steps, tag
    assert all(v > 0 for v in writer.scalars["iter_time"].values())
    assert set(writer.scalars["total_points"]) == steps  # the steps' and the report's
    for split in ("test", "train"):
        for what in ("l1_loss", "psnr"):
            assert set(writer.scalars[f"{split}/loss_viewpoint - {what}"]) == {5}
    hist = writer.hists["scene/opacity_histogram"][5]
    assert ((hist > 0) & (hist < 1)).all()
    assert len(hist) == writer.scalars["total_points"][5] == int(state.model.alive.sum())
    shape = (1, 3, 24, 32)
    views = {t for t in writer.images if t.endswith("/render")}
    assert len([t for t in views if t.startswith("test_view_")]) == 2
    assert len([t for t in views if t.startswith("train_view_")]) == 5
    for tag, calls in writer.images.items():
        assert calls == [(5, shape)], tag
    assert {t.replace("/ground_truth", "/render") for t in writer.images
            if t.endswith("/ground_truth")} == views


def test_short_training_improves_and_keeps_its_slack(dataset, tmp_path):
    """JAX's ``test_pipeline_e2e.py::test_short_training_improves`` on the
    port, on a shorter schedule: 30 iterations through a densification
    window lower the loss by a tenth, the snapshot at 30 loads, and the
    trained ``instance_slack`` kept in ``raster_state.json`` seeds a later
    render's."""
    model_dir = str(tmp_path / "m")
    (mcfg, opt, pipe), _ = _cfgs(dataset, model_dir, 30, densification_interval=10,
                                  densify_until_iter=25, opacity_reset_interval=10_000)
    opt.densify_from_iter = 10
    losses, alive = [], []

    def track(it, state, m):
        losses.append(float(m["loss"]))
        alive.append(int(state.model.num_alive()))

    loop.train(mcfg, opt, pipe, test_iterations=(), save_iterations=(30,), quiet=True,
               capacity=512, seed=1, device="cpu", on_iteration=track)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.9
    assert alive[-1] != alive[0]  # the window densified
    ply = os.path.join(model_dir, "point_cloud", "iteration_30", "point_cloud.ply")
    assert int(load_model_ply(ply, max_sh_degree=3, device="cpu").num_alive()) > 0
    with open(os.path.join(model_dir, "raster_state.json")) as f:
        kept = json.load(f)
    seeded = loop.load_raster_state(model_dir, RasterizeConfig())
    assert seeded.instance_slack == max(kept["instance_slack"], RasterizeConfig().instance_slack)


def test_checkpoint_round_trip(dataset, tmp_path):
    """JAX's ``test_pipeline_e2e.py::test_checkpoint_roundtrip`` on the
    port: every tensor of a trained state, its model's static fields and
    the iteration come back from ``chkpnt<it>.pth`` unchanged."""
    port_cfg, _ = _cfgs(dataset, str(tmp_path / "m"), 5)
    state = loop.train(*port_cfg, test_iterations=(), save_iterations=(), quiet=True,
                       capacity=512, device="cpu")
    path = str(tmp_path / "chkpnt5.pth")
    loop.save_checkpoint(path, state, 5)
    back, iteration = loop.load_checkpoint(path, device="cpu")
    assert iteration == 5 and int(back.adam.count) == int(state.adam.count) == 5
    ours, theirs = state.tensors(), back.tensors()
    assert set(ours) == set(theirs)
    for name, t in ours.items():
        assert torch.equal(theirs[name], t.detach()), name
    for field in ("max_sh_degree", "sh_degree", "spatial_lr_scale"):
        assert getattr(back.model, field) == getattr(state.model, field), field
