"""The control on the card: the reference computed with TF32 matrix
products and convolutions, put in the program's place, reads as not
correct.  Needs a CUDA card (``-m gpu``); the decision to skip is made
inside the test."""

import copy

import pytest
import torch

from benchmark import harness as hn
from benchmark.kinds import train_resume, view_orbit
from benchmark.reference import compare


def cell(name, **small):
    spec = hn.load_spec()
    c = hn.find(spec["workloads"], name, "c")
    cfg, mix = copy.deepcopy(hn.config_of(spec, c)), hn.mix_of(c)
    for k, v in small.items():
        (cfg["assumed"] if k in cfg["assumed"] else cfg if k in cfg else mix)[k] = v
    return cfg, mix


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [11, 2147483693, 3000000019])
def test_tf32_control_fails(seed):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    cfg, mix = cell("m360_outdoor_train", num_gaussians=200000, capacity=250000, num_views=16)
    numbers = train_resume.tf32_control(cfg, mix, seed, "cuda")
    assert not all(c["ok"] for c in compare.judge(numbers, mix["limits"]).values()), numbers
    cfg, mix = cell("m360_indoor_view1080", num_gaussians=200000, ring_views=8)
    numbers = view_orbit.tf32_control(cfg, mix, seed, "cuda")
    assert not all(c["ok"] for c in compare.judge(numbers, mix["limits"]).values()), numbers
