"""The port's training CLI in-process on the CPU (``--device cpu``):
five iterations write every file the JAX trainer writes, a second run
resumes from ``chkpnt5.pth`` at iteration 6, and the render CLI renders the
result.  Tensorboard is hidden, so the CLI takes its no-logging path."""

import json
import os
import sys

import numpy as np
import pytest

from gaussian_splatting_torch import render as render_cli
from gaussian_splatting_torch.data.ply import save_point_cloud_ply
from gaussian_splatting_torch.train import cli
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset


@pytest.fixture
def dataset(tmp_path):
    out = str(tmp_path / "scene")
    generate_blender_dataset(out, num_train=5, num_test=2, width=32, height=24,
                             num_gaussians=150, device="cpu")
    rng = np.random.default_rng(5)
    save_point_cloud_ply(os.path.join(out, "points3d.ply"),
                         rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32),
                         rng.integers(0, 256, (300, 3), dtype=np.uint8))
    return out


def test_cli_trains_saves_resumes_and_renders(dataset, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the no-TB path
    out = str(tmp_path / "out")
    argv = ["-s", dataset, "-m", out, "--eval", "--capacity", "512", "--test_iterations", "5",
            "--checkpoint_iterations", "5", "--disable_viewer", "--device", "cpu"]
    state = cli.main(argv + ["--iterations", "5"])
    assert int(state.step) == 5
    for name in ("cfg_args.json", "opt_args.json", "pipe_args.json", "cameras.json",
                 "input.ply", "raster_state.json", "exposure.json", "chkpnt5.pth",
                 os.path.join("point_cloud", "iteration_5", "point_cloud.ply")):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "cfg_args.json")) as f:
        assert json.load(f)["eval"] is True
    with open(os.path.join(out, "opt_args.json")) as f:
        assert json.load(f)["iterations"] == 5

    resumed = cli.main(argv + ["--iterations", "7", "--start_checkpoint",
                               os.path.join(out, "chkpnt5.pth")])
    assert int(resumed.step) == 7 and int(resumed.adam.count) == 7
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_7", "point_cloud.ply"))

    records = render_cli.main(["-m", out, "--device", "cpu"])
    assert [r["split"] for r in records] == ["train"] * 5 + ["test"] * 2
    assert all(r["retries"] == 0 for r in records)
    assert os.path.isdir(os.path.join(out, "test", "ours_7", "renders"))
