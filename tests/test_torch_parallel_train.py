"""The training loop with ``parallel="dp"`` and ``"gshard"`` on a gloo world
of 2 CPU ranks (spawned once), through a densify boundary, against the
single-device loop on the same scene (JAX ``tests/test_parallel.py::
test_train_loop_parallel_gshard_matches_single``'s run).

- Only rank 0 writes under the model directory (an audit hook on each rank
  records every path it opens for writing or creates).
- The DP ranks end with the same state, bit for bit, and the loss falls.
- gshard's gathered state and its losses track the single-device run's:
  losses within 5e-3 (JAX's bound), the same alive slots after the densify
  (which grows the capacity: every slot is alive at the start), means
  within 5e-4.
"""

import os

import numpy as np
import pytest
import torch

from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
from gaussian_splatting_torch.train.loop import dp_cameras, train
from gaussian_splatting_torch.utils.synthetic_dataset import generate_blender_dataset
from gaussian_splatting_torch.utils.testing import World, parallel_train_worker

OPT = dict(iterations=10, densify_from_iter=3, densification_interval=4,
           densify_until_iter=9, opacity_reset_interval=10_000)
TRAIN_KW = dict(opt=OPT, test_iterations=(), save_iterations=(10,), quiet=True,
                capacity=256, seed=3, viewer_ip="")
FILES = ["cfg_args.json", "cameras.json", "input.ply", "raster_state.json",
         os.path.join("point_cloud", "iteration_10", "point_cloud.ply")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_train")
    data = str(root / "scene")
    generate_blender_dataset(data, num_train=4, num_test=1, width=48, height=48,
                             num_gaussians=120, device="cpu")
    out = str(root / "models")
    world = World(2, (parallel_train_worker, data, out, ["dp", "gshard"], TRAIN_KW),
                  timeout_s=120.0)
    losses = []
    single = train(ModelConfig(source_path=data, model_path=str(root / "single")),
                   OptimizationConfig(**OPT), PipelineConfig(), device="cpu",
                   on_iteration=lambda it, s, m: losses.append(float(m["packed"][0])),
                   **{k: v for k, v in TRAIN_KW.items() if k != "opt"})
    return [r[0] for r in world.results()], (losses, single), out


def test_only_rank_0_writes(runs):
    results, _, out = runs
    assert results[1]["writes"] == []
    for mode in ("dp", "gshard"):
        for f in FILES:
            assert os.path.exists(os.path.join(out, mode, f)), (mode, f)
        assert any(w.startswith(mode) for w in results[0]["writes"])


def test_dp_ranks_end_identical(runs):
    results, _, _ = runs
    a, b = results[0]["dp"], results[1]["dp"]
    assert len(a["losses"]) == OPT["iterations"] and np.isfinite(a["losses"]).all()
    assert a["losses"] == b["losses"]
    for name, value in a["state"].items():
        np.testing.assert_array_equal(b["state"][name], value, err_msg=name)
    assert int(a["state"]["step"]) == OPT["iterations"]


def test_dp_loss_falls(runs):
    """JAX ``tests/test_parallel.py::test_train_loop_parallel_dp_runs``'s
    check: under ``--parallel dp`` the loss ends below where it started."""
    results, _, _ = runs
    losses = results[0]["dp"]["losses"]
    assert losses[-1] < losses[0]


def test_gshard_tracks_the_single_device_run(runs):
    results, (losses, single), _ = runs
    got = results[0]["gshard"]
    assert got["losses"] == results[1]["gshard"]["losses"]
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=5e-3)
    ref = {k: v.detach().numpy() for k, v in single.tensors().items()}
    # gathered, whole, and grown past its 256 slots by the densify's clones
    assert got["state"]["means3d"].shape == ref["means3d"].shape
    assert ref["means3d"].shape[0] > TRAIN_KW["capacity"]
    np.testing.assert_array_equal(got["state"]["alive"], ref["alive"])
    assert int(got["state"]["step"]) == OPT["iterations"]
    np.testing.assert_allclose(got["state"]["means3d"], ref["means3d"], atol=5e-4, rtol=0)


class _Cam:
    def __init__(self, h, w):
        self.height, self.width = h, w


def test_dp_camera_batches_follow_jax():
    """JAX ``train/loop.py:453-466``: the batch takes same-size cameras from
    the top of the stack, then draws with replacement at an epoch's tail."""
    import random

    cams = [_Cam(32, 48), _Cam(64, 48), _Cam(32, 48), _Cam(32, 48), _Cam(64, 48)]
    stack = [1, 2, 4, 3]
    assert dp_cameras(0, stack, cams, 3) == [0, 3, 2] and stack == [1, 4]
    random.seed(0)
    expect = [1, 4, random.Random(0).choice([1, 4])]
    stack = [4]
    assert dp_cameras(1, stack, cams, 3) == expect and stack == []
    with pytest.raises(ValueError):
        train(ModelConfig(), OptimizationConfig(), PipelineConfig(), parallel="bogus",
              device="cpu")
    assert torch.distributed.is_initialized() is False
