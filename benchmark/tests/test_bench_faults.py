"""A whole run of each cell at a small size on the CPU (the look for a card
skipped), with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have, and true with nothing broken."""

import time

import pytest

from benchmark import controls, run
from benchmark import harness as hn

SMALL_TRAIN = dict(num_gaussians=1000, capacity=1250, width=64, height=48, num_views=10,
                   points3D=200, focal_px=52.0)
SMALL_VIEW = dict(num_gaussians=3000, width=160, height=96, ring_views=6, sample_span=4,
                  checked_views=2, focal_px=104.0)


def one(cell, small, fault=None, seed=2147483659):
    spec = hn.load_spec()
    if fault is None:
        result, checks = run.run_cell(spec, cell, seed, 1.0, False, "cpu", time.perf_counter(),
                                      dict(small))
        return result["correct"], {k: c["value"] for k, c in checks.items()}
    line = controls.fault_run(spec, cell, fault, seed, 1.0, "cpu", dict(small))
    return line["correct"], line["numbers"]


def test_train_sound():
    correct, numbers = one("m360_outdoor_train", SMALL_TRAIN)
    assert correct, numbers


@pytest.mark.parametrize("fault,number", [("stale_step", "update_gap"),
                                          ("half_batch", "loss_gap")])
def test_train_faults(fault, number):
    correct, numbers = one("m360_outdoor_train", SMALL_TRAIN, fault)
    assert not correct
    limits = hn.mix_of(hn.find(hn.load_spec()["workloads"], "m360_outdoor_train", "c"))["limits"]
    assert numbers[number] > limits[number]
    if fault == "stale_step":
        assert numbers["update_gap"] == pytest.approx(1.0)


def test_view_altered():
    correct, numbers = one("m360_indoor_view1080", SMALL_VIEW, "altered_view")
    assert not correct and numbers["image_gap"] > 1e-3
