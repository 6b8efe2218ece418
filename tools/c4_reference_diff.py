#!/usr/bin/env python3
"""Fault C4's CPU experiment: one version of the JAX package, run in a
process of its own, on the states of the quality corpus's "spheres" run;
then two such runs compared.  An older version is unpacked outside the
package's own directory first, for example

    mkdir -p "$TMPDIR/jax_77c07c3"
    git archive 77c07c3 gaussian_splatting_tpu | tar -x -C "$TMPDIR/jax_77c07c3"

    python tools/c4_reference_diff.py prepare SCENE_DIR START.npz
    python tools/c4_reference_diff.py run JAX_ROOT START.npz OUT.npz \\
        [--late tests/data/spheres_15000_crop.npz] [--snapshot PLY SCENE_DIR]
    python tools/c4_reference_diff.py compare A.npz B.npz

``prepare`` (the repo's package) writes the start of a corpus run: the
100k-point ``default_rng(0)`` cloud of the scene at ``--capacity 262144``,
the first view of ``transforms_test.json`` at full size and its pixels.
``run`` renders, with the package at JAX_ROOT, (1) that view through Pallas
in interpret mode; (2) its central 128x96 window at the view's focal
lengths, with the Gaussians the repo's package sees in the central 192x144
window, through Pallas and the dense oracle, then one ``train_step`` of
each; (3) with ``--late``, the late-state fixture's window through both,
with the loss gradients of each; (4) with ``--snapshot``, the radii and tile
counts of a snapshot's Gaussians in every train view.  ``compare`` prints,
for every output both files hold, how far they part: floats by their
largest difference (also scaled by the second file's largest magnitude)
and the count past 2e-4 and past 3e-4 scaled; integers by the count that
differ."""

from __future__ import annotations

import os
import random
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("means3d", "features_dc", "features_rest", "opacities", "scales", "quats")
WINDOW = (128, 96)
KEEP_WINDOW = (192, 144)


def _jax():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    return jax


def _window(st, w, h):
    """fovx, fovy, x0, y0 of the central w x h window of the state's view
    (the port's ``crop_fovs``, which the fixture was cut with)."""
    from gaussian_splatting_torch.utils.testing import crop_fovs

    return crop_fovs(int(st["width"]), int(st["height"]), float(st["fovx"]),
                     float(st["fovy"]), w, h)


def prepare(scene_dir: str, out: str) -> None:
    sys.path.insert(0, ROOT)
    _jax()
    from gaussian_splatting_tpu.config import ModelConfig
    from gaussian_splatting_tpu.data.cameras import load_camera
    from gaussian_splatting_tpu.data.dataset import detect_and_load_scene
    from gaussian_splatting_tpu.ops.camera_math import make_camera
    from gaussian_splatting_tpu.ops.preprocess import preprocess
    from gaussian_splatting_tpu.scene import Scene

    random.seed(0)
    scene = Scene(ModelConfig(source_path=scene_dir, eval=True, white_background=True),
                  capacity=262144)
    alive = np.asarray(scene.gaussians.aux.alive)
    params = {k: np.asarray(v)[alive] for k, v in scene.gaussians.params._asdict().items()}
    view = detect_and_load_scene(scene_dir, white_background=True).test_cameras[0]
    st = dict(R=view.R, T=view.T, fovx=view.fovx, fovy=view.fovy, width=view.width,
              height=view.height)
    fovx, fovy, _, _ = _window(st, *KEEP_WINDOW)
    act = _activated(params, 0)
    radii = preprocess(*act, make_camera(view.R, view.T, fovx, fovy, *KEEP_WINDOW),
                       sh_degree=3).radii
    np.savez(out, **params, **st, image=load_camera(view, white_background=True,
                                                    is_synthetic=True).image,
             keep=np.asarray(radii) > 0, extent=float(scene.cameras_extent), sh_degree=0)
    print(f"prepared {out}: {alive.sum()} Gaussians, view {view.image_name}, "
          f"{int((np.asarray(radii) > 0).sum())} kept for the window")


def _activated(p, degree):
    import jax
    import jax.numpy as jnp

    sh = np.concatenate([p["features_dc"], p["features_rest"]], axis=1)
    degs = np.floor(np.sqrt(np.arange(sh.shape[1], dtype=np.float32))).astype(np.int32)
    sh = np.where((degs <= degree)[None, :, None], sh, 0.0).astype(np.float32)
    q = jnp.asarray(p["quats"])
    return (jnp.asarray(p["means3d"]), jnp.exp(jnp.asarray(p["scales"])),
            q / jnp.linalg.norm(q, axis=-1, keepdims=True),
            jax.nn.sigmoid(jnp.asarray(p["opacities"])), jnp.asarray(sh))


def run(jax_root: str, start: str, out: str, late: str = "", snapshot=None) -> None:
    sys.path[:0] = [os.path.abspath(jax_root), ROOT]  # JAX_ROOT's package shadows the repo's
    jax = _jax()
    import jax.numpy as jnp

    import gaussian_splatting_tpu
    from gaussian_splatting_tpu.config import OptimizationConfig, RasterizeConfig
    from gaussian_splatting_tpu.models.gaussians import (GaussianAux, GaussianModel,
                                                         GaussianParams, empty_params)
    from gaussian_splatting_tpu.ops.camera_math import make_camera
    from gaussian_splatting_tpu.ops.losses import photometric_loss
    from gaussian_splatting_tpu.ops.preprocess import preprocess
    from gaussian_splatting_tpu.ops.rasterize import render
    from gaussian_splatting_tpu.train.step import StepBatch, init_train_state, train_step
    from gaussian_splatting_torch.utils.testing import slot_capacity

    print(f"JAX package: {os.path.dirname(gaussian_splatting_tpu.__file__)}")
    res = {}
    bg = jnp.ones(3, jnp.float32)

    def slots(proj):
        return slot_capacity(int(np.asarray(proj.tiles_touched).sum())) + 4096

    def forward(tag, p, degree, cam, impls, gt=None):
        act = _activated(p, degree)
        proj = preprocess(*act, cam, sh_degree=3)
        res[f"{tag}_radii"] = np.asarray(proj.radii)
        res[f"{tag}_tiles"] = np.asarray(proj.tiles_touched)
        for impl in impls:
            t0 = time.perf_counter()
            if gt is None:
                r = render(*act, cam, bg, sh_degree=3, impl=impl, capacity=slots(proj),
                           inference=True)
            else:
                def loss(*a):
                    r = render(*a[:5], cam, bg, sh_degree=3, impl=impl, capacity=slots(proj),
                               means2d_tap=a[5])
                    return photometric_loss(r.image, jnp.asarray(gt), 0.2), r

                n = p["means3d"].shape[0]
                (_, r), grads = jax.jit(jax.value_and_grad(
                    loss, argnums=tuple(range(6)), has_aux=True))(
                        *act, jnp.zeros((n, 2), jnp.float32))
                for i, g in enumerate(grads):
                    res[f"{tag}_{impl}_grad_{i}"] = np.asarray(g)
            for name in ("image", "final_T", "invdepth"):
                res[f"{tag}_{impl}_{name}"] = np.asarray(getattr(r, name))
            print(f"{tag} {impl}: {time.perf_counter() - t0:.1f} s, overflow "
                  f"{bool(r.overflow)}", flush=True)

    st = dict(np.load(start))
    W, H = int(st["width"]), int(st["height"])
    forward("view", st, 0, make_camera(st["R"], st["T"], float(st["fovx"]), float(st["fovy"]),
                                       W, H), ("pallas",))
    fovx, fovy, x0, y0 = _window(st, *WINDOW)
    w, h = WINDOW
    cam = make_camera(st["R"], st["T"], fovx, fovy, w, h)
    sub = {k: st[k][st["keep"]] for k in NAMES}
    forward("window", sub, 0, cam, ("pallas", "dense"))
    n = sub["means3d"].shape[0]
    C = slot_capacity(n)
    empty = empty_params(C, 3)
    params = {}
    for k in NAMES:
        a = np.array(getattr(empty, k))
        a[:n] = sub[k]
        params[k] = jnp.asarray(a)
    alive = np.zeros(C, bool)
    alive[:n] = True
    z = jnp.zeros(C, jnp.float32)
    model = GaussianModel(params=GaussianParams(**params),
                          aux=GaussianAux(alive=jnp.asarray(alive), max_radii2d=z,
                                          xyz_grad_accum=z, denom=z),
                          spatial_lr_scale=jnp.float32(st["extent"]), sh_degree=jnp.int32(0),
                          max_sh_degree=3)
    state = init_train_state(model, 1)
    gt = st["image"][:, y0:y0 + h, x0:x0 + w]
    batch = StepBatch(gt_image=jnp.asarray(gt), alpha_mask=jnp.ones((1, h, w)),
                      invdepth_gt=jnp.zeros((h, w)), depth_mask=jnp.zeros((h, w)),
                      exposure_idx=jnp.int32(0), bg_color=bg)
    demand = int(res["window_tiles"].sum())
    for impl in ("dense", "pallas"):
        raster = RasterizeConfig(impl=impl, instance_slack=max(4.0, 1.5 * demand / C))
        new, m = jax.jit(lambda s, b: train_step(s, cam, b, opt=OptimizationConfig(),
                                                 raster=raster))(state, batch)
        res[f"step_{impl}_loss"] = np.asarray(m["loss"])
        for k in NAMES:
            res[f"step_{impl}_mu_{k}"] = np.asarray(getattr(new.adam.mu, k))[:n]
        for k in ("xyz_grad_accum", "denom", "max_radii2d"):
            res[f"step_{impl}_{k}"] = np.asarray(getattr(new.model.aux, k))[:n]
        print(f"step {impl}: loss {float(m['loss']):.9f}", flush=True)

    if late:
        crop = dict(np.load(late))
        forward("late", crop, int(crop["sh_degree"]),
                make_camera(crop["R"], crop["T"], float(crop["fovx"]), float(crop["fovy"]),
                            int(crop["width"]), int(crop["height"])),
                ("pallas", "dense"), gt=crop["gt"])
    if snapshot:
        from gaussian_splatting_tpu.data.dataset import detect_and_load_scene
        from gaussian_splatting_tpu.data.ply import load_gaussian_ply

        snap = {k: np.asarray(v) for k, v in load_gaussian_ply(snapshot[0]).items()}
        act = _activated(snap, 3)
        radii, tiles = [], []
        for view in detect_and_load_scene(snapshot[1], white_background=True).train_cameras:
            proj = preprocess(*act, make_camera(view.R, view.T, view.fovx, view.fovy,
                                                view.width, view.height), sh_degree=3)
            radii.append(np.asarray(proj.radii))
            tiles.append(np.asarray(proj.tiles_touched))
        res["snapshot_radii"] = np.stack(radii)
        res["snapshot_tiles"] = np.stack(tiles)
    np.savez(out, **res)
    print(f"wrote {out}")


def compare(a_path: str, b_path: str) -> None:
    a, b = dict(np.load(a_path)), dict(np.load(b_path))
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        if x.shape != y.shape:
            print(f"{k}: shapes {x.shape} and {y.shape}")
        elif x.dtype.kind in "biu":
            extra = f"; sums {int(x.sum())} and {int(y.sum())}" if "tiles" in k else ""
            print(f"{k}: {int((x != y).sum())} of {x.size} differ{extra}")
        else:
            d = np.abs(x.astype(np.float64) - y)
            scale = max(float(np.abs(y).max()), 1e-30)
            print(f"{k}: max |diff| {d.max():.3e} ({d.max() / scale:.3e} scaled); "
                  f"{int((d > 2e-4).sum())} past 2e-4, {int((d / scale > 3e-4).sum())} past "
                  f"3e-4 scaled, of {x.size}")
    for label, r in (("first", a), ("second", b)):
        if "late_pallas_grad_0" in r:
            gaps = []
            for i in range(6):
                p_, d_ = r[f"late_pallas_grad_{i}"], r[f"late_dense_grad_{i}"]
                gap = np.abs(p_ - d_) / np.abs(d_).max()
                gaps.append(f"{gap.max():.3e}/{int((gap > 3e-4).sum())}")
            image = np.abs(r["late_pallas_image"] - r["late_dense_image"]).max()
            print(f"late window, Pallas against dense in the {label}: image {image:.3e}; "
                  f"gradients (largest scaled gap / count past 3e-4) {', '.join(gaps)}")
    if "snapshot_radii" in a and "snapshot_radii" in b:
        ra, rb = a["snapshot_radii"], b["snapshot_radii"]
        seen_a, seen_b = ra > 0, rb > 0
        wide_a, wide_b = ra.max(axis=0) > 20, rb.max(axis=0) > 20
        print(f"snapshot: (Gaussian, view) pairs seen only in the first {int((seen_a & ~seen_b).sum())}"
              f" (radius median/p90/p99 {np.percentile(ra[seen_a & ~seen_b], [50, 90, 99])}), "
              f"only in the second {int((seen_b & ~seen_a).sum())} (radius median/p90/p99 "
              f"{np.percentile(rb[seen_b & ~seen_a], [50, 90, 99])}); Gaussians past 20 px in "
              f"some view: {int(wide_a.sum())} and {int(wide_b.sum())}, only in the first "
              f"{int((wide_a & ~wide_b).sum())}, only in the second {int((wide_b & ~wide_a).sum())};"
              f" slots over the views {int(a['snapshot_tiles'].sum())} and "
              f"{int(b['snapshot_tiles'].sum())}")


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else ""
    args = sys.argv[2:]
    if cmd == "prepare" and len(args) == 2:
        prepare(*args)
    elif cmd == "run" and len(args) >= 3:
        late = args[args.index("--late") + 1] if "--late" in args else ""
        snap = (args[args.index("--snapshot") + 1:args.index("--snapshot") + 3]
                if "--snapshot" in args else None)
        run(*args[:3], late=late, snapshot=snap)
    elif cmd == "compare" and len(args) == 2:
        compare(*args)
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
