#!/usr/bin/env python3
"""A/B of versions of the port's blend kernels (K2 blend forward, K5 blend
backward) on one NVIDIA card, on the inputs of chip_smoke.py's train parity:
the bench scene's fixture model with seeded noise, view 0, 1920x1080.

    python3 tools/torch_blend_ab.py --variant old=<csrc dir> --variant new=<csrc dir>

Each ``<csrc dir>`` holds a ``blend_forward.cu`` and a ``blend_backward.cu``
with the C interface of ``gaussian_splatting_torch/csrc`` (for example the
parent commit's, unpacked with ``git archive <commit> gaussian_splatting_torch/csrc``
into a directory under ``build/``).  Every variant is built with the
package's nvcc flags, held against the plain twins (K2: RGB/T/inverse depth
within 1e-5 and NB; K5: into a NaN-poisoned buffer, scaled error and the
count of bitwise-equal values), and timed with CUDA events in turns (the
variants in order, then in reverse).  Prints one JSON line per variant and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

KERNELS = ("blend_forward", "blend_backward")


def build(name, csrc):
    """nvcc both kernels of one variant at once; their libraries and the
    ptxas register / shared-memory / spill lines."""
    from gaussian_splatting_torch import _kernels

    out_dir = os.path.join(ROOT, "build", "blend_ab", name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k in KERNELS:
        lib = os.path.join(out_dir, f"lib{k}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, os.path.join(csrc, f"{k}.cu")]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), lib)
    libs = {}
    for k, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{k}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} {k}: {line.strip()}")
        libs[k] = ctypes.CDLL(lib)
    return libs


def launchers(libs, args, packed, ct, gx, dev):
    import torch

    vp, ci = ctypes.c_void_p, ctypes.c_int
    fwd = libs["blend_forward"].gs_blend_forward
    fwd.argtypes = [vp] * 4 + [ci] * 2 + [vp] * 2
    bwd = libs["blend_backward"].gs_blend_backward
    bwd.argtypes = [vp] * 6 + [ci] * 2 + [vp] * 2
    fwd.restype = bwd.restype = ci
    ptrs = [a.data_ptr() for a in args]
    num_tiles = args[1].shape[0]

    def forward(out):
        err = fwd(*ptrs, num_tiles, gx, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"blend_forward launch failed: {err}")

    def backward(out):
        err = bwd(*ptrs, packed.data_ptr(), ct.data_ptr(), num_tiles, gx, out.data_ptr(),
                  torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"blend_backward launch failed: {err}")

    return forward, backward


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", required=True,
                        help="name=directory holding blend_forward.cu and blend_backward.cu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()

    import torch

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.ops.rasterize import blend_fields

    chip_smoke.device_phase()
    variants = dict(v.split("=", 1) for v in args.variant)
    t0 = time.perf_counter()
    libs = {name: build(name, os.path.abspath(d)) for name, d in variants.items()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    root = os.path.join(ROOT, "build", "blend_ab", "fixture")
    _, model_dir = chip_smoke.make_fixture(root, args.seed)
    setup = chip_smoke.train_setup(model_dir, args.seed)
    model, cam = setup["state"].model, setup["cams"][0].cam
    dev = torch.device("cuda")
    with torch.no_grad():
        proj = preprocess(*model.activated_params(), cam, sh_degree=chip_smoke.SH_DEGREE)
        fields = blend_fields(proj)
    capacity = inst.required_capacity(model.capacity, setup["raster"].instance_slack)
    layout, bargs, packed, d_img, ukw = chip_smoke.backward_inputs(setup, proj, fields, capacity)
    gx = ukw["grid_x"]
    n = int(layout.n_valid)
    with torch.no_grad():
        ct = ut.retile(d_img, **ukw)
        packed_p = bl.blend_forward_plain(*bargs, grid_x=gx)
        grad_p = bl.blend_backward_plain(*bargs, packed, ct, grid_x=gx)[:n]
        col = grad_p.abs().amax(dim=0) + 1e-30
        contrib, contrib_warps = chip_smoke.contributing_pairs(layout, fields, packed, gx)
        print(f"contributing pairs {contrib}")
        work = chip_smoke.blend_work(layout, packed, contrib_warps)

        results = {}
        runs = {}
        for name in variants:
            forward, backward = launchers(libs[name], bargs, packed, ct, gx, dev)
            out = torch.empty_like(packed_p)
            forward(out)
            grad = torch.full((layout.sorted_owner.shape[0], bl.NUM_FIELDS), float("nan"),
                              device=dev)
            backward(grad)
            torch.cuda.synchronize()
            diff = (grad[:n] - grad_p).abs()
            results[name] = {
                "fwd_err": float((out[..., :5] - packed_p[..., :5]).abs().max()),
                "fwd_nb_diff": int((out[..., bl.O_NB] != packed_p[..., bl.O_NB]).sum()),
                "bwd_unwritten": int(grad[:n].isnan().any(dim=1).sum()),
                "bwd_scaled_err": float((diff / col).max()),
                "bwd_bitwise_equal": int((diff == 0).sum()),
                "bwd_values": diff.numel(),
                "fwd_ms": [], "bwd_ms": [],
            }
            runs[name] = (forward, backward, out, grad)
        order = list(variants) + list(reversed(variants))
        for name in order:
            forward, backward, out, grad = runs[name]
            results[name]["fwd_ms"].append(chip_smoke.cuda_ms(lambda: forward(out), iters=args.iters))
            results[name]["bwd_ms"].append(chip_smoke.cuda_ms(lambda: backward(grad),
                                                              iters=args.iters))
    card = chip_smoke.card()
    for name, r in results.items():
        print(json.dumps({"variant": name, "card": card, **work, **r}))
    print(card)


if __name__ == "__main__":
    sys.exit(main())
