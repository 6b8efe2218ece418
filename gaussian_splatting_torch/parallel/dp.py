"""Camera data-parallel training step.

Counterpart of ``gaussian_splatting_tpu/parallel/dp.py``.  The Gaussians are
replicated: each rank renders its own camera of the batch with the
single-device step's loss (``train.step.step_gradients``), the gradients are
summed over the ranks in one all-reduce, and every rank takes the same Adam
step (``train.step.apply_gradients``), so the parameters stay identical on
every rank.  As in JAX: parameter and tap gradients are means over the
ranks; exposure gradients are sums (each rank's camera touches its own row
of the table); loss, L1 and the depth term are means; radii, the overflow
flag and the slot demand are maxima, so an overflow on any rank makes the
step a no-op on every rank.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.parallel import collectives as coll
from gaussian_splatting_torch.parallel.mesh import world_size
from gaussian_splatting_torch.train.step import (
    StepBatch,
    TrainState,
    apply_gradients,
    step_gradients,
    step_metrics,
)


def dp_train_step(
    state: TrainState,
    cam: CameraParams,
    batch: StepBatch,
    *,
    opt: OptimizationConfig,
    raster: RasterizeConfig,
    use_exposure: bool = False,
    use_depth: bool = False,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One data-parallel iteration; ``cam`` and ``batch`` are this rank's.
    Updates ``state`` in place on every rank."""
    n = world_size()
    g = step_gradients(state, cam, batch, opt=opt, raster=raster,
                       use_exposure=use_exposure, use_depth=use_depth)
    with torch.no_grad():
        # one all-reduce of every float: the parameter and tap gradients and
        # the three loss terms are divided by n after it, the exposures not
        means = list(g.params.values()) + [g.tap, g.loss, g.l1, g.depth_loss]
        sums = [g.exposures] if use_exposure else []
        flat = coll.all_reduce_sum(torch.cat([t.reshape(-1) for t in means + sums]))
        cut = sum(t.numel() for t in means)
        reduced = _split(flat[:cut] / n, means) + _split(flat[cut:], sums)
        names = list(g.params)
        g_params = dict(zip(names, reduced[: len(names)]))
        g_tap, loss, l1, depth_loss = reduced[len(names): len(names) + 4]
        g_exp = reduced[-1] if use_exposure else None

        peaks = coll.all_reduce_max(torch.cat([
            g.radii.to(torch.int32), g.overflow.to(torch.int32)[None],
            g.num_instances.to(torch.int32)[None]]))
        radii, overflow, num_instances = peaks[:-2], peaks[-2] > 0, peaks[-1]

        apply_gradients(state, g_params, g_tap, g_exp, radii, overflow, opt=opt,
                        use_exposure=use_exposure)
        return state, step_metrics(loss, l1, depth_loss, overflow, num_instances,
                                   state.model.num_alive())


def _split(flat: torch.Tensor, like):
    out, at = [], 0
    for t in like:
        out.append(flat[at: at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out

