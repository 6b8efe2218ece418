"""Score rendered test views against their ground truth (the port's
``metrics.py``).

    python -m gaussian_splatting_torch.metrics -m <model> [<model> ...] [--lpips_weights F]
        [--device cpu]

Same outputs as the repository's root ``metrics.py``: for every
``<model>/test/<method>/{renders,gt}`` it prints the mean SSIM, PSNR and
LPIPS, and writes ``<model>/results.json`` (means per method) and
``<model>/per_view.json`` (per file name).  LPIPS is null without a weights
file (``ops/lpips.py``).  The images are read with PIL and scored on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.ops.losses import ssim
from gaussian_splatting_torch.utils.image import psnr

DEFAULT_LPIPS_WEIGHTS = os.path.join("~", ".cache", "gs_lpips_vgg16.npz")


def _read_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im, np.float32)[..., :3] / 255.0


def read_dir_pairs(renders_dir: str, gt_dir: str):
    """(renders, gts, names): (H, W, 3) float32 images in [0, 1], paired by
    file name in sorted order."""
    names = sorted(os.listdir(renders_dir))
    renders = [_read_rgb(os.path.join(renders_dir, n)) for n in names]
    gts = [_read_rgb(os.path.join(gt_dir, n)) for n in names]
    return renders, gts, names


def evaluate(model_paths, lpips_fn=None, device=None):
    """Score every method under each model's ``test/``; writes
    ``results.json`` and ``per_view.json`` beside it and returns
    {model_path: {method: {"SSIM", "PSNR", "LPIPS"}}}."""
    dev = resolve_device(device)
    full_report = {}
    for model_path in model_paths:
        print(f"Scene: {model_path}")
        full_dict, per_view = {}, {}
        test_dir = os.path.join(model_path, "test")
        if not os.path.isdir(test_dir):
            print("  no test renders found")
            continue
        for method in sorted(os.listdir(test_dir)):
            print(f"  Method: {method}")
            renders, gts, names = read_dir_pairs(
                os.path.join(test_dir, method, "renders"),
                os.path.join(test_dir, method, "gt"),
            )
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(np.ascontiguousarray(r.transpose(2, 0, 1))).to(dev)
                gt = torch.from_numpy(np.ascontiguousarray(g.transpose(2, 0, 1))).to(dev)
                ssims.append(float(ssim(rt, gt)))
                psnrs.append(float(psnr(rt, gt)))
                lpipss.append(float(lpips_fn(r, g)) if lpips_fn else None)
            print(f"    SSIM : {np.mean(ssims):.7f}")
            print(f"    PSNR : {np.mean(psnrs):.7f}")
            if lpips_fn:
                print(f"    LPIPS: {np.mean(lpipss):.7f}")
            full_dict[method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)) if lpips_fn else None,
            }
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)),
            }
        with open(os.path.join(model_path, "results.json"), "w") as f:
            json.dump(full_dict, f, indent=True)
        with open(os.path.join(model_path, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=True)
        full_report[model_path] = full_dict
    return full_report


def lpips_weights_path(flag: str) -> str:
    """The weights file to use, in the JAX CLI's order: the flag, then
    ``$GS_LPIPS_WEIGHTS``, then ``~/.cache/gs_lpips_vgg16.npz``."""
    return (flag or os.environ.get("GS_LPIPS_WEIGHTS", "")
            or os.path.expanduser(DEFAULT_LPIPS_WEIGHTS))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Score rendered test views")
    parser.add_argument("--model_paths", "-m", nargs="+", type=str, required=True)
    parser.add_argument("--lpips_weights", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu'")
    return parser


def main(argv: Optional[List[str]] = None):
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    lpips_fn = None
    weights = lpips_weights_path(args.lpips_weights)
    if os.path.exists(weights):
        from gaussian_splatting_torch.ops.lpips import make_lpips

        lpips_fn = make_lpips(weights, device=device)
    elif args.lpips_weights:
        raise FileNotFoundError(args.lpips_weights)
    else:
        print("LPIPS weights not found; reporting LPIPS as null "
              "(see ops/lpips.py for the weights recipe)")
    return evaluate(args.model_paths, lpips_fn, device=device)


if __name__ == "__main__":
    main()
