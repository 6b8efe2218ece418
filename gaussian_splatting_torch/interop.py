"""Hand a JAX-side model to the port: numpy arrays in, ``GaussianModel`` out.

``params`` holds the fields of the JAX package's ``GaussianParams`` (means3d,
features_dc, features_rest, opacities, scales, quats) as numpy arrays and
``alive`` its ``GaussianAux.alive``, so both packages render the same model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.models.gaussians import GaussianModel

PARAM_NAMES = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")


def model_from_jax_params(
    params: Dict[str, np.ndarray],
    alive: np.ndarray,
    *,
    max_sh_degree: int,
    sh_degree: int,
    device=None,
) -> GaussianModel:
    dev = resolve_device(device)

    def tensor(a, dtype=torch.float32):
        return torch.from_numpy(np.array(a)).to(device=dev, dtype=dtype)

    return GaussianModel(
        **{name: tensor(params[name]) for name in PARAM_NAMES},
        alive=tensor(alive, torch.bool),
        max_sh_degree=max_sh_degree,
        sh_degree=int(sh_degree),
    )
