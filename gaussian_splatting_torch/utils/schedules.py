"""Learning-rate schedules: the reference's ``get_expon_lr_func``, a log-lerp
decay with an optional delayed sine ramp (counterpart of
``gaussian_splatting_tpu/utils/schedules.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch


def expon_lr(
    step,
    *,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor, which may live on the card,
    or a number) as a float32 tensor, computed in JAX's float32 order.
    Constants are filled on the step's device, never copied from the host,
    so a step on the card does not wait for the host."""
    step = torch.as_tensor(step).to(torch.float32)

    def f32(v):
        return torch.full((), v, dtype=torch.float32, device=step.device)

    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        ramp = torch.clamp(step / lr_delay_steps, 0.0, 1.0)
        delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
            f32(0.5 * math.pi) * ramp
        )
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = f32(float(np.log(np.float32(lr_init))))  # jnp.log of a float32
    log_final = f32(float(np.log(np.float32(lr_final))))
    log_lerp = torch.exp(log_init * (1.0 - t) + log_final * t)
    return delay_rate * log_lerp
