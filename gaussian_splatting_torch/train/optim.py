"""Adam with per-group learning rates, visibility masking and slot surgery.

Counterpart of ``gaussian_splatting_tpu/train/optim.py``, written out in its
float32 operation order (betas 0.9 / 0.999, eps 1e-15, bias corrections c1
and c2 from the step count) rather than ``torch.optim.Adam``, whose fused
and foreach forms round differently and keep moments the densifier cannot
reach.  Moments are dicts of tensors keyed like the parameters they follow.
``adam_update`` is out of place, so the training step can keep the old
state when a step overflows; the moment surgery below is in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import torch

from gaussian_splatting_torch.config import OptimizationConfig
from gaussian_splatting_torch.utils.schedules import expon_lr

B1 = 0.9
B2 = 0.999
EPS = 1e-15

Tensors = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    count: torch.Tensor  # () int32
    mu: Tensors  # first moments
    nu: Tensors  # second moments


def adam_init(params: Tensors) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=some.device),
        mu={k: torch.zeros_like(v, memory_format=torch.contiguous_format) for k, v in params.items()},
        nu={k: torch.zeros_like(v, memory_format=torch.contiguous_format) for k, v in params.items()},
    )


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def adam_update(
    grads: Tensors,
    state: AdamState,
    params: Tensors,
    lrs: Union[Tensors, torch.Tensor],
    *,
    visible: Optional[torch.Tensor] = None,
):
    """One Adam step; returns (new params, new state), both new tensors.
    ``lrs`` is a dict of scalar learning rates keyed like ``params``, or one
    for all.  ``visible`` (C,) bool restricts the parameter and moment
    updates to visible rows (SparseGaussianAdam)."""
    count = state.count + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - B1**cf
    c2 = 1.0 - B2**cf

    def mask(new, old):
        return new if visible is None else torch.where(_rows(visible, new), new, old)

    new_mu, new_nu, new_params = {}, {}, {}
    for k, g in grads.items():
        mu, nu = state.mu[k], state.nu[k]
        new_mu[k] = mask(B1 * mu + (1.0 - B1) * g, mu)
        new_nu[k] = mask(B2 * nu + (1.0 - B2) * g * g, nu)
        lr = lrs[k] if isinstance(lrs, dict) else lrs
        step = lr * (new_mu[k] / c1) / (torch.sqrt(new_nu[k] / c2) + EPS)
        if visible is not None:
            step = torch.where(_rows(visible, step), step, 0.0)
        new_params[k] = params[k] - step
    return new_params, AdamState(count=count, mu=new_mu, nu=new_nu)


def zero_moment_rows(state: AdamState, row_mask: torch.Tensor) -> None:
    """In place: zero the moments of the slots in ``row_mask`` (new or
    reused densify slots; the reference's optimizer surgery)."""
    for moments in (state.mu, state.nu):
        for m in moments.values():
            m.masked_fill_(_rows(row_mask, m), 0.0)


def zero_opacity_moments(state: AdamState) -> None:
    """In place: zero the opacity group's moments (after ``reset_opacity``)."""
    state.mu["opacities"].zero_()
    state.nu["opacities"].zero_()


def group_lrs(cfg: OptimizationConfig, step: torch.Tensor, spatial_lr_scale: float) -> Tensors:
    """Per-group learning rates at ``step``, float32 tensors on its device."""

    def const(v):
        return torch.full((), v, dtype=torch.float32, device=step.device)

    xyz_lr = expon_lr(
        step,
        lr_init=cfg.position_lr_init,
        lr_final=cfg.position_lr_final,
        lr_delay_mult=cfg.position_lr_delay_mult,
        max_steps=cfg.position_lr_max_steps,
    ) * const(spatial_lr_scale)
    return {
        "means3d": xyz_lr,
        "features_dc": const(cfg.feature_lr),
        "features_rest": const(cfg.feature_lr / 20.0),
        "opacities": const(cfg.opacity_lr),
        "scales": const(cfg.scaling_lr),
        "quats": const(cfg.rotation_lr),
    }


def exposure_lr(cfg: OptimizationConfig, step: torch.Tensor) -> torch.Tensor:
    return expon_lr(
        step,
        lr_init=cfg.exposure_lr_init,
        lr_final=cfg.exposure_lr_final,
        lr_delay_steps=cfg.exposure_lr_delay_steps,
        lr_delay_mult=cfg.exposure_lr_delay_mult,
        max_steps=cfg.iterations,
    )
