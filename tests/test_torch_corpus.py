"""The port's quality-corpus harness (``gaussian_splatting_torch.corpus``)
against the JAX package's: its switches against ``tools/run_quality_corpus.sh``,
its report against ``tools/corpus_report.py`` (run as a program), its log
parser on the JAX corpus's own logs, and the harness end to end on each
scene at 64x48 on the CPU with a compressed schedule."""

import json
import os
import re
import shlex
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gaussian_splatting_torch import corpus
from gaussian_splatting_torch.data.ply import save_point_cloud_ply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
SCRIPT = os.path.join(REPO, "tools", "run_quality_corpus.sh")
# about 30 iterations: the white-background opacity reset at 10, densify at
# 20 and 30, evaluations at 15 and 30; a capacity of 1024 slots for the
# 200-point cloud, not the corpus's 262144 (each slot costs a step time)
SMALL_SCHEDULE = ("--densify_from_iter", "10", "--densification_interval", "10",
                  "--densify_until_iter", "31", "--opacity_reset_interval", "1000",
                  "--capacity", "1024")


def _script_lines(first, last):
    with open(SCRIPT) as f:
        return "".join(f.readlines()[first - 1:last])


def test_switches_are_the_jax_scripts():
    train = shlex.split(_script_lines(27, 30).replace("\\\n", " "))
    common = train[train.index("-w"):train.index("$EXTRA")]
    ours = list(corpus.COMMON_SWITCHES)
    ours += ["--test_iterations", *map(str, corpus.TEST_ITERATIONS)]
    ours += ["--save_iterations", *map(str, corpus.SAVE_ITERATIONS)]
    assert common == ours
    cases = _script_lines(46, 51).replace("\\\n", " ")
    switches = {m[1]: tuple(shlex.split(m[2]))
                for m in re.finditer(r"(\w+)\)\s+run_scene \w+([^;]*);;", cases)}
    assert switches == {name: s.switches for name, s in corpus.SCENES.items()}
    argv = corpus.train_argv("glossy", "D", "O")
    assert argv[:4] == ["-s", "D", "-m", "O"]
    assert argv[4:-2] == ours + list(corpus.SCENES["glossy"].switches)
    assert argv[-2:] == ["--iterations", "30000"]


def test_trajectory_reads_the_jax_logs():
    with open(os.path.join(RESULTS, "spheres_train.log")) as f:
        spheres = corpus.trajectory(f.read())
    assert spheres.gaussians(1000) == 42608
    assert spheres.test_psnr[1000] == 18.53
    assert spheres.gaussians(7000) == 71846 and spheres.gaussians(30000) == 55420
    assert spheres.overflows == [] and spheres.growths == []
    assert spheres.events[0] == (0, "instance_slack 2.0 -> 12.8")
    with open(os.path.join(RESULTS, "thicket_train.log")) as f:
        thicket = corpus.trajectory(f.read())
    assert thicket.growths == [(2600, 262144, 393216), (4200, 393216, 589824),
                               (6000, 589824, 884736)]
    assert (2100, "densify re-probe: instance_slack -> 5.6") in thicket.events
    assert thicket.test_psnr == {1000: 14.91, 7000: 24.13, 15000: 27.47, 30000: 28.12}
    overflow = ("[it 812] instance buffer overflow — step was a device-side no-op; "
                "instance_slack -> 4.0 (1 consecutive)")
    assert corpus.trajectory(overflow).overflows == [812]


def _tool_report(results_dir):
    return subprocess.run([sys.executable, os.path.join(REPO, "tools", "corpus_report.py"),
                           results_dir], capture_output=True, text=True, check=True).stdout


def test_report_matches_the_jax_tool(tmp_path, capsys):
    jax_only = tmp_path / "jax_only"
    jax_only.mkdir()
    for name in ("spheres", "glossy"):  # thicket missing
        shutil.copy(os.path.join(RESULTS, f"{name}_results.json"), jax_only)
    corpus.report(str(jax_only))
    assert capsys.readouterr().out == _tool_report(str(jax_only))

    both = tmp_path / "both"
    shutil.copytree(RESULTS, both)
    with open(both / "torch_spheres_results.json", "w") as f:
        json.dump({"ours_7000": {"SSIM": 0.9, "PSNR": 21.5, "LPIPS": None}}, f)
    corpus.report(str(both))
    out = capsys.readouterr().out
    tool = _tool_report(str(both))
    assert out.startswith(tool) and len(out) > len(tool)
    assert "| spheres (port) | defaults (round-3 anchor scene) | 7000 | 21.500 | 0.900 | null |" in out
    assert "| spheres | 7000 | 22.372 | 21.500 | -0.872 | −1.0 | yes |" in out


@pytest.mark.parametrize("name", corpus.SCENES)
def test_harness_runs_each_scene(name, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = corpus.generate(name, str(tmp_path / "data"), device="cpu", num_train=2, num_test=1,
                           width=64, height=48)
    with open(os.path.join(data, corpus.GENERATION_FILE)) as f:
        generation = json.load(f)
    assert generation["scene_name"] == name and generation["width"] == 64
    assert os.path.isdir(os.path.join(data, "depths")) == (name == "thicket")
    rng = np.random.default_rng(3)
    save_point_cloud_ply(os.path.join(data, "points3d.ply"),
                         rng.uniform(-1.0, 1.0, (200, 3)).astype(np.float32),
                         rng.integers(0, 256, (200, 3), dtype=np.uint8))
    results_dir = str(tmp_path / "results")
    run = corpus.run_scene(name, data, str(tmp_path / "model"), iterations=30,
                           test_iterations=(15, 30), save_iterations=(15, 30), device="cpu",
                           results_dir=results_dir, extra_args=SMALL_SCHEDULE)
    with open(os.path.join(results_dir, f"torch_{name}_results.json")) as f:
        results = json.load(f)
    assert results == run["results"]
    assert set(results) == {"ours_15", "ours_30"}
    for scores in results.values():
        assert set(scores) == {"SSIM", "PSNR", "LPIPS"}
        assert np.isfinite(scores["PSNR"]) and np.isfinite(scores["SSIM"])
        assert scores["LPIPS"] is None  # no weights given, as in the JAX corpus
    with open(run["log"]) as f:
        log = f.read()
    traj = corpus.trajectory(log)
    assert set(traj.test_psnr) == {15, 30}
    assert traj.wall_s == pytest.approx(run["train_s"], abs=1e-3) and traj.device == "cpu"
    assert f"[corpus] overflow no-ops: {len(traj.overflows)}" in log
    assert "generated with" in log and '"scene_name": "' + name + '"' in log
    switches = " ".join(corpus.SCENES[name].switches)
    assert switches in log.splitlines()[1]


def test_harness_ends_early_and_resumes(tmp_path, monkeypatch):
    """A run on a 20-iteration schedule ended by ``EndRun`` after iteration
    10 (the hook ``chip_smoke.py`` uses) scores its snapshot at 10; a second
    run given ``--start_checkpoint`` through ``extra_args`` resumes from the
    checkpoint at 10 to 20 and appends to the log."""
    from gaussian_splatting_torch.train import loop

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    data = corpus.generate("spheres", str(tmp_path / "data"), device="cpu", num_train=2,
                           num_test=1, width=32, height=24)
    rng = np.random.default_rng(3)
    save_point_cloud_ply(os.path.join(data, "points3d.ply"),
                         rng.uniform(-1.0, 1.0, (100, 3)).astype(np.float32),
                         rng.integers(0, 256, (100, 3), dtype=np.uint8))
    real_step, steps = loop.train_step, []

    def ending_step(state, *args, **kw):
        if len(steps) == 10:
            raise corpus.EndRun(int(state.step))
        steps.append(int(state.step))
        return real_step(state, *args, **kw)

    model, results_dir = str(tmp_path / "model"), str(tmp_path / "results")
    kw = dict(iterations=20, test_iterations=(10, 20), save_iterations=(10,), device="cpu",
              results_dir=results_dir)
    schedule = SMALL_SCHEDULE[:-1] + ("512",)
    monkeypatch.setattr(loop, "train_step", ending_step)
    first = corpus.run_scene("spheres", data, model, **kw,
                             extra_args=schedule + ("--checkpoint_iterations", "10"))
    monkeypatch.setattr(loop, "train_step", real_step)
    assert steps == list(range(10)) and set(first["results"]) == {"ours_10"}
    assert set(first["trajectory"].test_psnr) == {10}
    ckpt = os.path.join(model, "chkpnt10.pth")
    second = corpus.run_scene("spheres", data, model, **kw,
                              extra_args=schedule + ("--start_checkpoint", ckpt))
    assert set(second["results"]) == {"ours_10", "ours_20"}
    with open(second["log"]) as f:
        log = f.read()
    assert "[corpus] ended after iteration 10 of the 20-iteration schedule" in log
    assert log.count("[corpus] scene spheres on cpu") == 2
    assert f"Resumed from {ckpt} at iteration 10" in log
    assert set(second["trajectory"].test_psnr) == {10, 20}
    assert "[corpus] training: 10 iterations in" in log.split("Resumed from")[0]


def test_thicket_schedule_matches_jax_with_its_noise(tmp_path, monkeypatch):
    """Thicket's switches (antialiasing, the depth loss from ``-d depths``)
    and the corpus's schedule compressed to 25 iterations at 32x24 through
    both packages' ``train()``: the white-background opacity reset at 5,
    densify at 10 and 20 with JAX's split noise fed to the port, a reset at
    20 and capacity growth.  JAX renders through its dense oracle.  Every
    iteration's loss within 1e-5 (the three-iteration test's tolerance) and
    every Gaussian count equal."""
    import jax

    from gaussian_splatting_tpu.config import ModelConfig as JaxModelConfig
    from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
    from gaussian_splatting_tpu.config import PipelineConfig as JaxPipe
    from gaussian_splatting_tpu.train import loop as jloop
    from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussian_splatting_torch.train import loop

    data = corpus.generate("thicket", str(tmp_path / "data"), device="cpu", num_train=4,
                           num_test=1, width=32, height=24)
    rng = np.random.default_rng(0)
    save_point_cloud_ply(os.path.join(data, "points3d.ply"),
                         (rng.random((300, 3)) * 2.6 - 1.3).astype(np.float32),
                         (rng.random((300, 3)) * 255).astype(np.uint8))
    schedule = dict(iterations=25, densify_from_iter=5, densification_interval=10,
                    densify_until_iter=21, opacity_reset_interval=20)
    scene = dict(source_path=data, eval=True, white_background=True, depths="depths")
    key = [jax.random.PRNGKey(0)]  # split per densify, as JAX's loop does
    real_densify = loop.densify_step

    def densify_with_jax_noise(state, generator, *, opt, max_screen_size):
        key[0], sub = jax.random.split(key[0])
        noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (state.model.capacity, 3))))
                      for k in jax.random.split(sub))
        return real_densify(state, generator, opt=opt, max_screen_size=max_screen_size,
                            noise=noise)

    monkeypatch.setattr(loop, "densify_step", densify_with_jax_noise)
    seen = {"port": [], "jax": []}

    def record(name):
        return lambda it, s, m: seen[name].append((float(m["loss"]), int(m["num_alive"])))

    kw = dict(test_iterations=(), save_iterations=(), quiet=True, capacity=512, seed=0)
    loop.train(ModelConfig(**scene), OptimizationConfig(**schedule),
               PipelineConfig(antialiasing=True), device="cpu", on_iteration=record("port"), **kw)
    jloop.train(JaxModelConfig(**scene), JaxOpt(**schedule),
                JaxPipe(antialiasing=True, rasterizer_impl="dense"), on_iteration=record("jax"),
                **kw)
    port, ref = (np.array(seen[k]) for k in ("port", "jax"))
    assert len(port) == len(ref) == 25
    np.testing.assert_array_equal(port[:, 1], ref[:, 1])
    assert port[0, 1] == 300 and port[-1, 1] > 512  # densified past the first capacity
    np.testing.assert_allclose(port[:, 0], ref[:, 0], atol=1e-5, rtol=0)


def test_plain_schedule_matches_jax_through_its_boundaries(tmp_path, monkeypatch):
    """Spheres' switches (none beyond the corpus's ``-w --eval``) through both
    packages' ``train()`` across the boundaries a 25-iteration run never
    reaches: four densifications with the 20 px screen-size prune active
    (Gaussians pruned by their radius alone: the prune without the radius
    condition, on the same state and noise, prunes fewer), three opacity
    resets (every 25, and the white-background one at ``densify_from_iter``),
    the SH ramp at 1000, the end of densification at 1000
    and the position LR on the last tenth of its decay, with JAX's split
    noise fed to the port and JAX rendering through its dense oracle.  The
    ramp is fixed at multiples of 1000 in both loops and the port's CPU path
    costs ~0.3 s an iteration here, so both resume from one checkpoint at
    iteration 930 (JAX's initial state of the 120-point cloud, carried
    across by ``interop``) and train to 1005 at 48x36.  Every iteration's
    loss within 1e-5, Gaussian count and active SH degree equal; the same
    iterations densify and reset; each densify clones, splits, prunes and
    prunes by radius the same counts."""
    import dataclasses
    import random

    import jax
    import jax.numpy as jnp

    from gaussian_splatting_tpu.config import ModelConfig as JaxModelConfig
    from gaussian_splatting_tpu.config import OptimizationConfig as JaxOpt
    from gaussian_splatting_tpu.config import PipelineConfig as JaxPipe
    from gaussian_splatting_tpu.models import densify as jdensify
    from gaussian_splatting_tpu.scene import Scene as JaxScene
    from gaussian_splatting_tpu.train import loop as jloop
    from gaussian_splatting_tpu.train.step import init_train_state as jax_init_train_state
    from gaussian_splatting_torch import interop
    from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussian_splatting_torch.models import densify
    from gaussian_splatting_torch.train import loop

    data = corpus.generate("spheres", str(tmp_path / "data"), device="cpu", num_train=4,
                           num_test=1, width=48, height=36)
    rng = np.random.default_rng(0)
    save_point_cloud_ply(os.path.join(data, "points3d.ply"),
                         (rng.random((120, 3)) * 2.6 - 1.3).astype(np.float32),
                         (rng.random((120, 3)) * 255).astype(np.uint8))
    start, end = 930, 1005
    schedule = dict(iterations=end, densify_from_iter=935, densification_interval=15,
                    densify_until_iter=1000, opacity_reset_interval=25,
                    position_lr_max_steps=end)
    scene = dict(source_path=data, eval=True, white_background=True)
    random.seed(0)
    jstate = jax_init_train_state(JaxScene(JaxModelConfig(**scene), capacity=512).gaussians, 4)
    jstate = dataclasses.replace(jstate, step=jnp.int32(start))
    ckpt = {"jax": str(tmp_path / f"chkpnt{start}.pkl"), "port": str(tmp_path / f"chkpnt{start}.pth")}
    jloop.save_checkpoint(ckpt["jax"], jstate, start)
    loop.save_checkpoint(ckpt["port"], interop.train_state_from_jax(
        **interop.jax_state_leaves(jstate), device="cpu"), start)

    events = {"port": [], "jax": []}  # (iteration, "reset") or (iteration, counts...)
    key = [jax.random.PRNGKey(0)]  # split per densify, as JAX's loop does
    real_densify, real_reset = loop.densify_step, loop.opacity_reset_step

    def port_densify(state, generator, *, opt, max_screen_size):
        key[0], sub = jax.random.split(key[0])
        noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (state.model.capacity, 3))))
                      for k in jax.random.split(sub))
        model = state.model
        stats = {k: getattr(model, k).clone() for k in ("alive", "max_radii2d", "xyz_grad_accum",
                                                        "denom")}
        stats["max_radii2d"].zero_()  # the prune without the radius condition
        blind = densify.densify_and_prune(
            {k: v.detach() for k, v in model.params().items()}, stats,
            grad_threshold=opt.densify_grad_threshold, min_opacity=0.005,
            extent=model.spatial_lr_scale, max_screen_size=max_screen_size,
            percent_dense=opt.percent_dense, noise=noise)
        it = int(state.step)
        state, out = real_densify(state, generator, opt=opt, max_screen_size=max_screen_size,
                                  noise=noise)
        events["port"].append((it, max_screen_size, int(out["cloned"]), int(out["split"]),
                               int(out["pruned"]), int(out["pruned"]) - int(blind.num_pruned)))
        return state, out

    def port_reset(state):
        events["port"].append((int(state.step), "reset"))
        return real_reset(state)

    real_jax_densify, real_jax_reset = jloop.densify_step, jloop.opacity_reset_step

    def jax_densify(state, k, *, opt, max_screen_size):
        m = state.model
        blind = jdensify.densify_and_prune(
            m.params, m.aux._replace(max_radii2d=jnp.zeros_like(m.aux.max_radii2d)), k,
            grad_threshold=opt.densify_grad_threshold, min_opacity=0.005,
            extent=m.spatial_lr_scale, max_screen_size=max_screen_size,
            percent_dense=opt.percent_dense)
        state, out = real_jax_densify(state, k, opt=opt, max_screen_size=max_screen_size)
        jax.debug.callback(lambda *v: events["jax"].append(
            (int(v[0]), max_screen_size, *(int(x) for x in v[1:4]), int(v[3]) - int(v[4]))),
            state.step, out["cloned"], out["split"], out["pruned"], blind.num_pruned)
        return state, out

    def jax_reset(state):
        jax.debug.callback(lambda it: events["jax"].append((int(it), "reset")), state.step)
        return real_jax_reset(state)

    monkeypatch.setattr(loop, "densify_step", port_densify)
    monkeypatch.setattr(loop, "opacity_reset_step", port_reset)
    monkeypatch.setattr(jloop, "densify_step", jax_densify)
    monkeypatch.setattr(jloop, "opacity_reset_step", jax_reset)
    seen = {"port": [], "jax": []}

    def record(name):
        return lambda it, s, m: seen[name].append(
            (it, float(m["loss"]), int(m["num_alive"]), int(s.model.sh_degree)))

    kw = dict(test_iterations=(), save_iterations=(), quiet=True, capacity=512, seed=0)
    loop.train(ModelConfig(**scene), OptimizationConfig(**schedule), PipelineConfig(),
               device="cpu", on_iteration=record("port"), start_checkpoint=ckpt["port"], **kw)
    key[0] = jax.random.PRNGKey(0)
    jloop.train(JaxModelConfig(**scene), JaxOpt(**schedule), JaxPipe(rasterizer_impl="dense"),
                on_iteration=record("jax"), start_checkpoint=ckpt["jax"], **kw)
    port, ref = (np.array(seen[k]) for k in ("port", "jax"))
    assert port[:, 0].tolist() == ref[:, 0].tolist() == list(range(start + 1, end + 1))
    np.testing.assert_array_equal(port[:, 2:], ref[:, 2:])  # Gaussians, SH degree
    np.testing.assert_allclose(port[:, 1], ref[:, 1], atol=1e-5, rtol=0)
    assert port[port[:, 0] < 1000, 3].max() == 0 and port[port[:, 0] >= 1000, 3].min() == 1
    assert events["port"] == events["jax"]
    resets = [it for it, *rest in events["port"] if rest == ["reset"]]
    densifies = [e for e in events["port"] if e[1] != "reset"]
    assert resets == [935, 950, 975]
    assert [e[0] for e in densifies] == [945, 960, 975, 990]
    assert all(e[1] == 20 for e in densifies) and sum(e[-1] for e in densifies) >= 1
    assert port[-1, 2] > port[0, 2]  # densification grew the model
    print(f"largest loss gap {np.abs(port[:, 1] - ref[:, 1]).max():.3e}; boundaries {events['port']}")


def test_start_of_a_corpus_run_matches_jax_at_full_size(tmp_path, monkeypatch):
    """The state a corpus run starts from, at full size: the default
    generation's 100 train views at 800x600 (shaded flat: only the cameras
    matter here), the 100k-point random cloud at ``--capacity 262144``, and
    the initial slack each loop estimates from it, equal in both packages.
    (The JAX corpus's TPU logs print ``instance_slack 2.0 -> 12.8`` here.)"""
    import random

    from gaussian_splatting_tpu.config import ModelConfig as JaxModelConfig
    from gaussian_splatting_tpu.config import RasterizeConfig as JaxRasterizeConfig
    from gaussian_splatting_tpu.scene import Scene as JaxScene
    from gaussian_splatting_tpu.train import loop as jloop
    from gaussian_splatting_tpu.train.step import init_train_state as jax_init_train_state
    from gaussian_splatting_torch.config import ModelConfig, RasterizeConfig
    from gaussian_splatting_torch.scene import Scene
    from gaussian_splatting_torch.train import loop
    from gaussian_splatting_torch.train.step import init_train_state
    from gaussian_splatting_torch.utils import synthetic_dataset

    def flat(orig, d, spheres, plane, dtype=None):
        n = d.shape[0]
        return torch.zeros((n, 3)), torch.ones(n), torch.full((n,), 4.0)

    monkeypatch.setattr(synthetic_dataset, "shade_analytic", flat)
    data = corpus.generate("spheres", str(tmp_path / "spheres"), device="cpu", supersample=1)
    scene = dict(source_path=data, eval=True, white_background=True)
    random.seed(0)
    ours = Scene(ModelConfig(**scene), capacity=262144, device="cpu")
    random.seed(0)
    ref = JaxScene(JaxModelConfig(**scene), capacity=262144)
    assert [c.image_name for c in ours.get_train_cameras()] == \
        [c.image_name for c in ref.get_train_cameras()]
    assert ours.cameras_extent == ref.cameras_extent
    assert int(ours.gaussians.alive.sum()) == 100_000
    est = loop.estimate_instance_slack(init_train_state(ours.gaussians, 100),
                                       ours.get_train_cameras(), RasterizeConfig())
    jax_est = jloop.estimate_instance_slack(jax_init_train_state(ref.gaussians, 100),
                                            ref.get_train_cameras(), JaxRasterizeConfig())
    assert est == jax_est
    assert abs(est - 12.6186) < 1e-4
