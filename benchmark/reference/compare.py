"""The numbers that decide ``correct``: the program's outputs against the
reference's, each a relative gap.

Norm gaps are taken leaf by leaf (one leaf per stored parameter group):
the gap between the program's norm and the reference's, measured against
the reference's norm of that leaf or of the median leaf, whichever is
larger, so a leaf whose values are all but zero reads no noise.  The worst
leaf is the number.  Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out of the
changes.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

LEAF_FLOOR = 1e-3
TRAIN_NUMBERS = ("loss_gap", "image_gap", "invdepth_gap", "demand_gap", "grad_gap",
                 "update_gap", "moments_gap", "stats_gap")
VIEW_NUMBERS = ("image_gap", "invdepth_gap")


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def rel_diff(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r||."""
    return norm(p.to(r.device).double() - r.double()) / max(norm(r), 1e-30)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's | ||p|| - ||r|| | / max(||r||, median leaf ||r||)."""
    names = list(ref if leaves is None else leaves)
    ref_n = {k: norm(ref[k]) for k in names}
    med = sorted(ref_n.values())[len(names) // 2] if names else 0.0
    return max((abs(norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-30) for k in names),
               default=0.0)


def moving_leaves(grads: Dict[str, torch.Tensor]) -> list:
    """Leaves whose reference gradient norm is at least a thousandth of the
    median leaf's."""
    n = {k: norm(g) for k, g in grads.items()}
    med = sorted(n.values())[len(n) // 2]
    return [k for k, v in n.items() if v >= LEAF_FLOOR * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold the same keys: ``losses`` of the checked
    steps, ``image`` and ``invdepth`` of the first, ``demand`` of the
    first, ``grad`` (the first step's gradient per leaf; the program's
    worked out from its first moments), ``delta`` (each leaf's change over
    the checked steps), ``delta_mu`` and ``delta_nu`` (the moments'), and
    ``delta_stats``."""
    moving = moving_leaves(ref["grad"])
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "image_gap": rel_diff(prog["image"], ref["image"]),
        "invdepth_gap": rel_diff(prog["invdepth"], ref["invdepth"]),
        "demand_gap": abs(prog["demand"] - ref["demand"]) / ref["demand"],
        "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
        "update_gap": leaf_gap(prog["delta"], ref["delta"], moving),
        "moments_gap": max(leaf_gap(prog["delta_mu"], ref["delta_mu"], moving),
                           leaf_gap(prog["delta_nu"], ref["delta_nu"], moving)),
        "stats_gap": leaf_gap(prog["delta_stats"], ref["delta_stats"]),
    }


def view_numbers(prog: list, ref: list) -> Dict[str, float]:
    """Each of ``prog`` and ``ref`` a list of (image, inverse depth) of the
    same views."""
    return {
        "image_gap": max(rel_diff(p[0], r[0]) for p, r in zip(prog, ref)),
        "invdepth_gap": max(rel_diff(p[1], r[1]) for p, r in zip(prog, ref)),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number that has a limit beside it; a number above its limit,
    or one that is not finite, fails.  Numbers without a limit are
    readings only."""
    out = {}
    for name, lim in limits.items():
        value = numbers[name]
        ok = value == value and value <= lim
        out[name] = {"value": value, "limit": lim, "ok": bool(ok)}
    return out
