"""Configuration dataclasses, field for field the JAX package's.

Same names and defaults as ``gaussian_splatting_tpu/config.py``, so the port
reads and writes the ``cfg_args.json``, ``opt_args.json`` and
``pipe_args.json`` that the JAX trainer writes.  ``impl`` values:
``"auto"``, ``"pallas"`` and ``"jax"`` select the tiled path through the
hand-written kernels, and ``"dense"`` the per-pixel oracle.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass


@dataclass
class ModelConfig:
    """Scene/model options (reference ``ModelParams``)."""

    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    data_device: str = "cpu"
    eval: bool = False


@dataclass
class PipelineConfig:
    """Render-pipeline switches (reference ``PipelineParams``)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    antialiasing: bool = False
    rasterizer_impl: str = "auto"


@dataclass
class OptimizationConfig:
    """Training schedule (reference ``OptimizationParams``)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.025
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3_000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"  # "default" | "sparse_adam"


@dataclass
class RasterizeConfig:
    """Rasterizer parameters (16x16 tiles as in the reference)."""

    tile_w: int = 16
    tile_h: int = 16
    # Instance capacities are rounded up to a multiple of this (the JAX
    # forward-blend lane chunk), so both packages overflow at the same
    # capacity.
    chunk: int = 512
    # Instance-buffer capacity as a multiple of the Gaussian count; an
    # overflowing render reports it and callers retry with more slack.
    instance_slack: float = 2.0
    antialiasing: bool = False
    impl: str = "auto"  # "auto" | "pallas" | "jax" | "dense"
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False


def save_config(cfg, path: str) -> None:
    """Write a config dataclass as the JSON the JAX trainer writes."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def load_config(cls, path: str):
    with open(path) as f:
        data = json.load(f)
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in known})
