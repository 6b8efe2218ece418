"""Render train/test views of a trained model (the port's ``render.py``).

    python -m gaussian_splatting_torch.render -m <model> [-s <scene>] [-r 1] [--device cpu]

Same flags and outputs as the repository's root ``render.py``: writes
``<model>/<split>/ours_<iter>/renders/*.png`` and ``gt/*.png``.  Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.config import (
    ModelConfig,
    PipelineConfig,
    RasterizeConfig,
    load_config,
)
from gaussian_splatting_torch.models.gaussians import GaussianModel
from gaussian_splatting_torch.ops.rasterize import RenderResult, render_stored
from gaussian_splatting_torch.train.loop import load_raster_state
from gaussian_splatting_torch.train.step import apply_exposure
from gaussian_splatting_torch.utils.image import to_uint8, write_image

MAX_EVAL_SLACK = 512.0


def render_camera(
    model: GaussianModel,
    camera,
    raster: RasterizeConfig,
    bg: torch.Tensor,
    exposure: Optional[torch.Tensor] = None,
):
    """Eval render of one camera with the overflow retry: while the instance
    buffer overflows, double ``instance_slack`` and render again.

    Returns (image (3, H, W), RenderResult, retries)."""
    gaussians = model.stored()
    cfg = raster
    retries = 0
    while True:
        out: RenderResult = render_stored(
            gaussians, camera.cam, bg, sh_degree=model.max_sh_degree, cfg=cfg,
        )
        if not bool(out.overflow):
            break
        if cfg.instance_slack > MAX_EVAL_SLACK:
            raise RuntimeError(
                f"eval render still overflowing at instance_slack > {MAX_EVAL_SLACK}"
            )
        cfg = dataclasses.replace(cfg, instance_slack=cfg.instance_slack * 2.0)
        retries += 1
    image = out.image
    if exposure is not None:
        image = torch.clamp(apply_exposure(image, exposure), 0.0, 1.0)
    return image, out, retries


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Render trained model views")
    parser.add_argument("--model_path", "-m", type=str, required=True)
    parser.add_argument("--source_path", "-s", type=str, default="")
    parser.add_argument("--images", "-i", type=str, default="images")
    parser.add_argument("--resolution", "-r", type=int, default=-1)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--train_test_exp", action="store_true")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--antialiasing", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu' for the plain PyTorch path")
    return parser


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Render; returns one record per written view (path, timing, counts)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)

    from gaussian_splatting_torch.scene import Scene

    cfg_path = os.path.join(args.model_path, "cfg_args.json")
    if os.path.exists(cfg_path):
        model_cfg = load_config(ModelConfig, cfg_path)
        for k in ("source_path", "images", "resolution"):
            v = getattr(args, k)
            if v not in ("", -1):
                setattr(model_cfg, k, v)
    else:
        model_cfg = ModelConfig(
            sh_degree=args.sh_degree,
            source_path=args.source_path,
            model_path=args.model_path,
            images=args.images,
            resolution=args.resolution,
            white_background=args.white_background,
            train_test_exp=args.train_test_exp,
            eval=args.eval,
        )
    model_cfg.model_path = args.model_path

    pipe_path = os.path.join(args.model_path, "pipe_args.json")
    pipe = (
        load_config(PipelineConfig, pipe_path)
        if os.path.exists(pipe_path)
        else PipelineConfig()
    )
    raster_cfg = load_raster_state(
        args.model_path,
        RasterizeConfig(
            antialiasing=pipe.antialiasing or args.antialiasing,
            impl=pipe.rasterizer_impl,
            convert_SHs_python=pipe.convert_SHs_python,
            compute_cov3D_python=pipe.compute_cov3D_python,
        ),
    )

    scene = Scene(model_cfg, load_iteration=args.iteration, shuffle=False, device=device)
    model = scene.gaussians

    pretrained_exposures = None
    if model_cfg.train_test_exp:
        exp_path = os.path.join(args.model_path, "exposure.json")
        if os.path.exists(exp_path):
            with open(exp_path) as f:
                pretrained_exposures = json.load(f)
        else:
            print(f"No exposure to be loaded at {exp_path}")
    bg = torch.tensor(
        [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0],
        dtype=torch.float32, device=device,
    )

    splits = []
    if not args.skip_train:
        splits.append(("train", scene.get_train_cameras()))
    if not args.skip_test:
        splits.append(("test", scene.get_test_cameras()))

    records = []
    for name, cams in splits:
        if not cams:
            continue
        base = os.path.join(args.model_path, name, f"ours_{scene.loaded_iter}")
        os.makedirs(os.path.join(base, "renders"), exist_ok=True)
        os.makedirs(os.path.join(base, "gt"), exist_ok=True)
        for idx, cam in enumerate(cams):
            exposure = None
            if pretrained_exposures is not None:
                exp = pretrained_exposures.get(cam.image_name)
                if exp is None:
                    print(f"No exposure found for {cam.image_name}; using identity")
                else:
                    exposure = torch.tensor(exp, dtype=torch.float32, device=device)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            img, out, retries = render_camera(model, cam, raster_cfg, bg, exposure)
            img = img.cpu().numpy()
            seconds = time.perf_counter() - t0  # .cpu() synchronised
            img = img.transpose(1, 2, 0)
            gt = cam.image.transpose(1, 2, 0)
            if model_cfg.train_test_exp:  # keep the right half
                img = img[:, img.shape[1] // 2 :]
                gt = gt[:, gt.shape[1] // 2 :]
            path = os.path.join(base, "renders", f"{idx:05d}.png")
            write_image(path, to_uint8(img))
            write_image(os.path.join(base, "gt", f"{idx:05d}.png"), to_uint8(gt))
            records.append(dict(
                split=name, index=idx, path=path, seconds=seconds,
                num_instances=int(out.num_instances), retries=retries,
                peak_bytes=(torch.cuda.max_memory_allocated(device)
                            if device.type == "cuda" else None),
            ))
        print(f"rendered {len(cams)} {name} views -> {base}")
    return records


if __name__ == "__main__":
    main()
