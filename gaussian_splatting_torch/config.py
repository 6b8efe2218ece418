"""Configuration dataclasses, field for field the JAX package's.

Same names and defaults as ``gaussian_splatting_tpu/config.py``, so the port
reads the ``cfg_args.json``, ``pipe_args.json`` and ``raster_state.json``
that the JAX trainer writes.  ``impl`` values: ``"auto"``, ``"pallas"`` and
``"jax"`` select the tiled path through the hand-written kernels, and
``"dense"`` the per-pixel oracle.
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


def load_config(cls, path: str):
    with open(path) as f:
        data = json.load(f)
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in known})
