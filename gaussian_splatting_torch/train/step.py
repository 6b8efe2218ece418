"""The training step and the densification steps.

Counterpart of ``gaussian_splatting_tpu/train/step.py``:

- ``train_step``: render -> photometric (+ depth) loss -> backward (K5 ->
  K6 -> K4 under autograd) -> Adam on the Gaussians and the exposures ->
  densification statistics.  Its halves, ``step_gradients`` and
  ``apply_gradients``, are what ``parallel.dp`` reduces between.
- ``densify_step``: clone / split / prune + moment zeroing.
- ``opacity_reset_step``: opacity clamp + opacity moment zeroing.

The state is a mutable ``TrainState`` that the steps update in place.  An
overflowed render (a truncated instance stream, hence truncated gradients)
must leave the state exactly as it was, step counter included, as in JAX.
The choice here is JAX's: a device-side select, ``where(overflow, old,
new)``, copied into every state tensor, so a step on the card never waits
for the host to read the overflow flag.  The host reads ``metrics`` when it
likes (``metrics["packed"]`` is one tensor to fetch) and grows the capacity
when it sees an overflow.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
from gaussian_splatting_torch.models.densify import (
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
)
from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, STAT_NAMES, GaussianModel
from gaussian_splatting_torch.ops.camera_math import CameraParams
from gaussian_splatting_torch.ops.losses import depth_l1_loss, l1_loss, photometric_loss
from gaussian_splatting_torch.ops.rasterize import render
from gaussian_splatting_torch.train.optim import (
    AdamState,
    adam_init,
    adam_update,
    exposure_lr,
    group_lrs,
    zero_moment_rows,
    zero_opacity_moments,
)
from gaussian_splatting_torch.utils.schedules import expon_lr


@dataclass
class TrainState:
    model: GaussianModel
    adam: AdamState
    exposures: torch.Tensor  # (N_images, 3, 4)
    exp_adam: AdamState  # moments keyed "exposures"
    step: torch.Tensor  # () int32, 1-based iteration like the reference

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor of the state by a flat name (what an overflowed step
        leaves unchanged)."""
        out = {name: getattr(self.model, name) for name in PARAM_NAMES + ("alive",) + STAT_NAMES}
        for tag, adam in (("adam", self.adam), ("exp_adam", self.exp_adam)):
            out[f"{tag}.count"] = adam.count
            for k in adam.mu:
                out[f"{tag}.mu.{k}"] = adam.mu[k]
                out[f"{tag}.nu.{k}"] = adam.nu[k]
        out["exposures"] = self.exposures
        out["step"] = self.step
        return out


def init_train_state(model: GaussianModel, num_images: int) -> TrainState:
    dev = model.means3d.device
    eye = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], dim=1)
    exposures = eye[None].repeat(max(num_images, 1), 1, 1)
    return TrainState(
        model=model,
        adam=adam_init({k: v.detach() for k, v in model.params().items()}),
        exposures=exposures,
        exp_adam=adam_init({"exposures": exposures}),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


class StepBatch(NamedTuple):
    """Per-iteration device inputs for one camera."""

    gt_image: torch.Tensor  # (3, H, W)
    alpha_mask: torch.Tensor  # (1, H, W) (ones if absent)
    invdepth_gt: torch.Tensor  # (H, W) (zeros if absent)
    depth_mask: torch.Tensor  # (H, W) (zeros if absent)
    exposure_idx: torch.Tensor  # () int64 (or int32)
    bg_color: torch.Tensor  # (3,)


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """Per-image affine with pixels as rows: rgb' = rgb @ M + t, in full
    float32 (TF32 is off)."""
    M = exposure[:3, :3]
    t = exposure[:3, 3]
    return torch.einsum("chw,ck->khw", image, M) + t[:, None, None]


def train_step(
    state: TrainState,
    cam: CameraParams,
    batch: StepBatch,
    *,
    opt: OptimizationConfig,
    raster: RasterizeConfig,
    use_exposure: bool = False,
    use_depth: bool = False,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimisation iteration; updates ``state`` in place and returns it
    with device-side metrics."""
    g = step_gradients(state, cam, batch, opt=opt, raster=raster,
                       use_exposure=use_exposure, use_depth=use_depth)
    with torch.no_grad():
        apply_gradients(state, g.params, g.tap, g.exposures, g.radii, g.overflow, opt=opt,
                        use_exposure=use_exposure)
        return state, step_metrics(g.loss, g.l1, g.depth_loss, g.overflow, g.num_instances,
                                   state.model.num_alive())


class StepGradients(NamedTuple):
    """One camera's loss terms and gradients, before any reduction."""

    loss: torch.Tensor
    l1: torch.Tensor
    depth_loss: torch.Tensor
    params: Dict[str, torch.Tensor]  # by parameter name
    tap: torch.Tensor  # (C, 2) the densification tap's gradient
    exposures: Optional[torch.Tensor]  # (N_images, 3, 4) with use_exposure
    radii: torch.Tensor
    overflow: torch.Tensor
    num_instances: torch.Tensor


def step_gradients(
    state: TrainState, cam: CameraParams, batch: StepBatch, *, opt: OptimizationConfig,
    raster: RasterizeConfig, use_exposure: bool = False, use_depth: bool = False,
) -> StepGradients:
    """Render one camera, its photometric (+ depth) loss and the gradients
    of the Gaussians, the tap and the exposures."""
    model = state.model
    leaves = model.params()
    exposures = state.exposures.detach().requires_grad_(use_exposure)
    tap = torch.zeros((model.capacity, 2), dtype=torch.float32,
                      device=model.means3d.device, requires_grad=True)

    with torch.enable_grad():
        # active-SH masking and dead slots at opacity 0: activated_params
        out = render(
            *model.activated_params(), cam, batch.bg_color,
            sh_degree=model.max_sh_degree, cfg=raster, means2d_tap=tap,
        )
        image = out.image
        if use_exposure:
            image = apply_exposure(image, exposures[batch.exposure_idx])
        image = image * batch.alpha_mask
        gt = batch.gt_image * batch.alpha_mask
        loss = photometric_loss(image, gt, opt.lambda_dssim)
        depth_loss = torch.zeros((), dtype=torch.float32, device=image.device)
        if use_depth:
            w = expon_lr(state.step + 1, lr_init=opt.depth_l1_weight_init,
                         lr_final=opt.depth_l1_weight_final, max_steps=opt.iterations)
            depth_loss = w * depth_l1_loss(out.invdepth, batch.invdepth_gt, batch.depth_mask)
            loss = loss + depth_loss
        wrt = list(leaves.values()) + [tap] + ([exposures] if use_exposure else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]

    with torch.no_grad():
        return StepGradients(
            loss=loss.detach(), l1=l1_loss(image, gt), depth_loss=depth_loss.detach(),
            params=dict(zip(leaves, grads[: len(leaves)])), tap=grads[len(leaves)],
            exposures=grads[-1] if use_exposure else None, radii=out.radii,
            overflow=out.overflow, num_instances=out.num_instances,
        )


def apply_gradients(
    state: TrainState,
    g_params: Dict[str, torch.Tensor],
    g_tap: torch.Tensor,
    g_exposures: Optional[torch.Tensor],
    radii: torch.Tensor,
    overflow: torch.Tensor,
    *,
    opt: OptimizationConfig,
    use_exposure: bool = False,
) -> None:
    """Adam on the Gaussians (and the exposures), the densification
    statistics and the step count, in place; every state tensor keeps its
    value where ``overflow`` is set.  Call under ``torch.no_grad``."""
    model = state.model
    step = state.step + 1
    leaves = model.params()
    # dead capacity slots do not exist in the reference's exactly-sized
    # arrays: mask their gradients so no numerical dust ever moves them
    alive = model.alive
    g_params = {k: g * alive.reshape((-1,) + (1,) * (g.dim() - 1)) for k, g in g_params.items()}

    lrs = group_lrs(opt, step, model.spatial_lr_scale)
    visible = radii > 0 if opt.optimizer_type == "sparse_adam" else None
    new_params, new_adam = adam_update(
        g_params, state.adam, {k: v.detach() for k, v in leaves.items()}, lrs,
        visible=visible,
    )
    new = {**new_params}
    if use_exposure:
        e_new, e_adam = adam_update(
            {"exposures": g_exposures}, state.exp_adam,
            {"exposures": state.exposures}, exposure_lr(opt, step),
        )
        new["exposures"] = e_new["exposures"]
        _put_adam(new, "exp_adam", e_adam)
    new.update(add_densification_stats(
        {k: getattr(model, k) for k in STAT_NAMES}, g_tap, radii))
    _put_adam(new, "adam", new_adam)
    new["step"] = step

    # overflow guard on the device: every state tensor keeps its old
    # value when the instance buffer overflowed (in-place copies)
    current = state.tensors()
    for name, value in new.items():
        old = current[name]
        old.copy_(torch.where(overflow, old, value))


def step_metrics(loss, l1, depth_loss, overflow, num_instances, num_alive
                 ) -> Dict[str, torch.Tensor]:
    """The step's metrics, and all six in ``packed`` (one tensor to fetch)."""
    metrics = {"loss": loss, "l1": l1, "depth_loss": depth_loss, "overflow": overflow,
               "num_instances": num_instances, "num_alive": num_alive}
    metrics["packed"] = torch.stack([
        loss, l1, depth_loss, overflow.to(torch.float32),
        num_instances.to(torch.float32), num_alive.to(torch.float32),
    ])
    return metrics


def _put_adam(new: Dict[str, torch.Tensor], tag: str, adam: AdamState) -> None:
    new[f"{tag}.count"] = adam.count
    for k in adam.mu:
        new[f"{tag}.mu.{k}"] = adam.mu[k]
        new[f"{tag}.nu.{k}"] = adam.nu[k]


def densify_step(
    state: TrainState,
    generator: Optional[torch.Generator] = None,
    *,
    opt: OptimizationConfig,
    max_screen_size: int,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """Densify + prune + moment zeroing, in place.  The split children's
    noise comes from ``generator`` unless given as ``noise``."""
    model = state.model
    with torch.no_grad():
        res = densify_and_prune(
            {k: v.detach() for k, v in model.params().items()},
            {k: getattr(model, k) for k in ("alive",) + STAT_NAMES},
            grad_threshold=opt.densify_grad_threshold,
            min_opacity=0.005,
            extent=model.spatial_lr_scale,
            max_screen_size=max_screen_size,
            percent_dense=opt.percent_dense,
            generator=generator,
            noise=noise,
        )
        for name, value in {**res.params, **res.stats}.items():
            getattr(model, name).copy_(value)
        zero_moment_rows(state.adam, res.new_slot_mask)
    stats = {
        "cloned": res.num_cloned,
        "split": res.num_split,
        "pruned": res.num_pruned,
        "dropped": res.dropped,
        "num_alive": model.num_alive(),
    }
    return state, stats


def opacity_reset_step(state: TrainState) -> TrainState:
    """Clamp every opacity to at most 0.01 and zero its moments, in place."""
    with torch.no_grad():
        state.model.opacities.copy_(reset_opacity(state.model.opacities))
        zero_opacity_moments(state.adam)
    return state
