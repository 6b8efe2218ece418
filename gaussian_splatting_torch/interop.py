"""Hand JAX-side state to the port: numpy arrays in, port objects out.

``params`` holds the fields of the JAX package's ``GaussianParams`` (means3d,
features_dc, features_rest, opacities, scales, quats) as numpy arrays and
``alive`` its ``GaussianAux.alive``, so both packages render the same model;
``train_state_from_jax`` carries a whole ``TrainState`` across, so both
packages can train from one state.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, STAT_NAMES, GaussianModel
from gaussian_splatting_torch.train.optim import AdamState
from gaussian_splatting_torch.train.step import TrainState


def _tensor(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)


def model_from_jax_params(
    params: Dict[str, np.ndarray],
    alive: np.ndarray,
    *,
    max_sh_degree: int,
    sh_degree: int,
    spatial_lr_scale: float = 1.0,
    stats: Optional[Mapping[str, np.ndarray]] = None,
    device=None,
) -> GaussianModel:
    dev = resolve_device(device)
    return GaussianModel(
        **{name: _tensor(params[name], dev) for name in PARAM_NAMES},
        alive=_tensor(alive, dev, torch.bool),
        max_sh_degree=max_sh_degree,
        sh_degree=int(sh_degree),
        spatial_lr_scale=float(spatial_lr_scale),
        stats=None if stats is None else {k: _tensor(stats[k], dev) for k in STAT_NAMES},
    )


def train_state_from_jax(
    *,
    params: Mapping[str, np.ndarray],
    aux: Mapping[str, np.ndarray],
    adam: Tuple[np.ndarray, Mapping[str, np.ndarray], Mapping[str, np.ndarray]],
    exposures: np.ndarray,
    exp_adam: Tuple[np.ndarray, np.ndarray, np.ndarray],
    step,
    spatial_lr_scale: float,
    sh_degree: int,
    max_sh_degree: int,
    device=None,
) -> TrainState:
    """The port's ``TrainState`` from the leaves of a JAX ``TrainState``:
    ``params`` and ``aux`` (alive, max_radii2d, xyz_grad_accum, denom) by
    field name, ``adam`` = (count, mu, nu) with mu / nu by parameter name,
    ``exp_adam`` = (count, mu, nu) of the exposures, and the step."""
    dev = resolve_device(device)
    model = model_from_jax_params(
        params, aux["alive"], max_sh_degree=max_sh_degree, sh_degree=sh_degree,
        spatial_lr_scale=spatial_lr_scale, stats=aux, device=dev,
    )

    def adam_state(count, mu, nu):
        return AdamState(
            count=_tensor(count, dev, torch.int32),
            mu={k: _tensor(v, dev) for k, v in mu.items()},
            nu={k: _tensor(v, dev) for k, v in nu.items()},
        )

    count, mu, nu = exp_adam
    return TrainState(
        model=model,
        adam=adam_state(*adam),
        exposures=_tensor(exposures, dev),
        exp_adam=adam_state(count, {"exposures": mu}, {"exposures": nu}),
        step=_tensor(step, dev, torch.int32),
    )


def jax_state_leaves(state) -> Dict:
    """A JAX ``TrainState``'s leaves as numpy arrays, in the keyword
    arguments of ``train_state_from_jax`` (read by attribute; nothing of JAX
    is imported).  They pickle, so spawned ranks can start from them."""
    m = state.model

    def tree(t):
        return {k: np.asarray(v) for k, v in t._asdict().items()}

    return dict(
        params=tree(m.params), aux=tree(m.aux),
        adam=(np.asarray(state.adam.count), tree(state.adam.mu), tree(state.adam.nu)),
        exposures=np.asarray(state.exposures),
        exp_adam=(np.asarray(state.exp_adam.count), np.asarray(state.exp_adam.mu),
                  np.asarray(state.exp_adam.nu)),
        step=np.asarray(state.step), spatial_lr_scale=float(m.spatial_lr_scale),
        sh_degree=int(m.sh_degree), max_sh_degree=m.max_sh_degree,
    )
