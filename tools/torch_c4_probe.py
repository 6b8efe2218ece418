#!/usr/bin/env python3
"""Fault C4's probe on one NVIDIA card: the quality corpus's "spheres" scene
trained through ``gaussian_splatting_torch.corpus`` on its 30,000-iteration
schedule, with K1-K6 held bitwise to their plain twins on the arguments of
iterations 7000, 15000 and 30000 (``chip_smoke.py::LoopProbe``), and a
snapshot at 15000 beside the corpus's; then the late-state fixture cut from
that snapshot.

    python3 tools/torch_c4_probe.py [--seed 0] [--out build/c4]
    python3 tools/torch_c4_probe.py --cut SNAPSHOT_PLY SCENE_DIR OUT_NPZ [--device cpu]

The run writes ``torch_spheres_{train.log,results.json}`` (the corpus's
files), the 15000 snapshot and the fixture into ``--out``.  The fixture
(``--cut``) is the central window of the first frame of the scene's
``transforms_test.json``, at that view's own focal lengths, with the
snapshot's Gaussians whose radius is positive in the window and the
window's ground-truth pixels: the largest window of WINDOWS that keeps at
most MAX_GAUSSIANS Gaussians and fits in MAX_BYTES.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SCENE = "spheres"
KEEP_AT = (7000, 15000, 30000)
SNAPSHOT = 15000
WINDOWS = ((128, 96), (112, 84), (96, 72), (80, 60), (64, 48), (48, 36), (32, 24), (16, 12))
MAX_GAUSSIANS = 2000
MAX_BYTES = 512 * 1024
SH_DEGREE = 3  # the corpus's; active from iteration 3000 on


def cut(ply: str, scene_dir: str, out: str, device="cuda", iteration: int = SNAPSHOT) -> dict:
    """Write the late-state fixture ``out`` from snapshot ``ply`` of the
    scene in ``scene_dir``; returns its description."""
    import numpy as np
    import torch

    from gaussian_splatting_torch.data.cameras import load_camera
    from gaussian_splatting_torch.data.dataset import read_blender_scene
    from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, load_model_ply
    from gaussian_splatting_torch.ops.camera_math import make_camera
    from gaussian_splatting_torch.ops.rasterize import project
    from gaussian_splatting_torch.utils.testing import crop_fovs

    model = load_model_ply(ply, max_sh_degree=SH_DEGREE, device=device)
    info = read_blender_scene(scene_dir, white_background=True)
    view = info.test_cameras[0]
    image = load_camera(view, white_background=True, is_synthetic=True, device=device).image
    alive = model.alive.cpu().numpy()
    for w, h in WINDOWS:
        fovx, fovy, x0, y0 = crop_fovs(view.width, view.height, view.fovx, view.fovy, w, h)
        cam = make_camera(view.R, view.T, fovx, fovy, w, h, device=device)
        with torch.no_grad():
            radii = project(*model.activated_params(), cam, sh_degree=SH_DEGREE).radii
        keep = alive & (radii.cpu().numpy() > 0)
        print(f"[c4] a {w}x{h} window keeps {keep.sum()} Gaussians")
        if keep.sum() > MAX_GAUSSIANS:
            continue
        arrays = {name: getattr(model, name).detach().cpu().numpy()[keep] for name in PARAM_NAMES}
        np.savez_compressed(
            out, **arrays, R=view.R, T=view.T, fovx=fovx, fovy=fovy, width=w, height=h,
            gt=image[:, y0:y0 + h, x0:x0 + w], extent=float(info.nerf_normalization["radius"]),
            iteration=iteration, sh_degree=SH_DEGREE)
        size = os.path.getsize(out)
        if size <= MAX_BYTES:
            desc = dict(view=view.image_name, window=[w, h], offset=[x0, y0],
                        gaussians=int(keep.sum()), of=int(alive.sum()), bytes=size,
                        max_radius=int(radii.max()))
            print(f"[c4] fixture {out}: {json.dumps(desc)}")
            return desc
    raise RuntimeError(f"no window of {WINDOWS} keeps at most {MAX_GAUSSIANS} Gaussians "
                       f"in {MAX_BYTES} bytes")


def probe_run(seed: int, out: str) -> None:
    import torch

    from gaussian_splatting_torch import corpus

    print(f"[c4] {chip_smoke.card()}; torch {torch.__version__} cuda {torch.version.cuda}")
    data = os.path.join(ROOT, "build", "corpus", "data", SCENE)
    if not os.path.exists(os.path.join(data, "transforms_test.json")):
        t0 = time.perf_counter()
        corpus.generate(SCENE, data, device="cuda")
        print(f"[c4] generated {SCENE} in {time.perf_counter() - t0:.3f} s")
    checked = {}

    def bitwise(probe, iteration):
        sizes = chip_smoke.kept_kernels_bitwise(probe.inputs, f"iteration {iteration}")
        probe.inputs.clear()
        checked[iteration] = sizes
        print(f"[c4] K1-K6 bitwise equal to their twins on iteration {iteration}'s inputs: "
              + ", ".join(f"{k} {v} values" for k, v in sizes.items()), flush=True)

    model_dir = os.path.join(ROOT, "build", "corpus", "runs", SCENE)
    saves = tuple(sorted(set(corpus.SAVE_ITERATIONS) | {SNAPSHOT}))
    with chip_smoke.LoopProbe(keep_at=KEEP_AT, on_kept=bitwise) as probe:
        run = corpus.run_scene(SCENE, data, model_dir, save_iterations=saves, device="cuda",
                               results_dir=out, extra_args=("--seed", str(seed)))
    missing = [it for it in KEEP_AT if it not in checked]
    if missing or len(probe.starts) != 30_000:
        raise RuntimeError(f"kernels not checked at {missing}; {len(probe.starts)} steps")
    traj = run["trajectory"]
    print(f"[c4] test PSNR {json.dumps(traj.test_psnr)}; scores {json.dumps(run['results'])}; "
          f"training {run['train_s']:.3f} s, render and metrics {run['score_s']:.3f} s")
    ply = os.path.join(model_dir, "point_cloud", f"iteration_{SNAPSHOT}", "point_cloud.ply")
    shutil.copyfile(ply, os.path.join(out, f"{SCENE}_{SNAPSHOT}.ply"))
    cut(ply, data, os.path.join(out, f"{SCENE}_{SNAPSHOT}_crop.npz"))
    print(f"[c4] {chip_smoke.card()}")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join("build", "c4"))
    p.add_argument("--cut", nargs=3, metavar=("SNAPSHOT_PLY", "SCENE_DIR", "OUT_NPZ"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.cut:
        cut(*args.cut, device=args.device)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_c4_probe: no CUDA device; the run needs the card")
    os.makedirs(args.out, exist_ok=True)
    probe_run(args.seed, args.out)


if __name__ == "__main__":
    main()
