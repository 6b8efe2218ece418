#!/usr/bin/env python3
"""A/B of versions of the port's layout, reduce and scan kernels (K1 expand,
K3 untile, K4 retile, K6 segment reduce, K7 segmented cumsum) on one NVIDIA
card, on the inputs of chip_smoke.py's train parity: the bench scene's
fixture model with seeded noise, view 0, 1920x1080.

    python3 tools/torch_layout_ab.py --variant old=<dir> --variant new=<dir> [...]

Each ``<dir>`` holds any of ``expand.cu``, ``untile.cu``, ``retile.cu``,
``segment_reduce.cu`` and ``segscan.cu``, with the C interface of
``gaussian_splatting_torch/csrc`` (for example the parent commit's, unpacked
with ``git archive <commit> gaussian_splatting_torch/csrc`` into a directory
under ``build/``, or ``tools/kernel_variants/retile_staged``).  Every source
is built with the package's nvcc flags, held bitwise against its plain twin
(K1: keys and owners; K3: the 5 planes of the 8-column records; K4: the
records of the loss's image gradient; K6: the sums of the step's
expansion-order gradient rows; K7: the scan of those rows, field-major,
flagged at each Gaussian's first slot, as chip_smoke.py's segscan phase runs
it), and timed with CUDA events in turns: the variants in order, then in
reverse, ``--rounds`` times; then each under torch.profiler.  A ``--probe``
is a build that leaves work out on purpose (for example
``tools/kernel_variants/expand_probe_no_rows``): it is timed with the
variants and reported, but not held to the twin.  Prints the build reports,
one JSON line per variant and the card's name and power limit.
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

KERNELS = ("expand", "untile", "retile", "segment_reduce", "segscan")


def build(name, src_dir):
    """nvcc every kernel source of one variant at once; their libraries."""
    from gaussian_splatting_torch import _kernels

    out_dir = os.path.join(ROOT, "build", "layout_ab", name)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for k in KERNELS:
        src = os.path.join(src_dir, f"{k}.cu")
        if not os.path.exists(src):
            continue
        lib = os.path.join(out_dir, f"lib{k}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", lib, src]
        procs[k] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), lib)
    libs = {}
    for k, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}/{k}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name} {k}: {line.strip()}")
        libs[k] = ctypes.CDLL(lib)
    return libs


def launchers(libs, table, ekw, packed, ukw, d_img, d_exp, offsets, scan, dev):
    """Each built kernel as a call that fills a preallocated output."""
    import torch

    vp, ci = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    calls = {}
    if "expand" in libs:
        lib = libs["expand"]
        P, cap = table.depth_key.shape[0], ekw["capacity"]
        # the block design takes a scratch array of block ends before the stream
        scratch = []
        if hasattr(lib, "gs_expand_block_items"):
            n = -(-(cap + P + 1) // lib.gs_expand_block_items()) + 1
            scratch.append(torch.empty(n, dtype=torch.int32, device=dev))
        fn_e = lib.gs_expand
        fn_e.argtypes = [vp] * 8 + [ci] * 4 + [vp] * (3 + len(scratch))
        fn_e.restype = ci
        ptrs = [t.data_ptr() for t in table]

        def expand(out):
            keys, owner = out
            err = fn_e(*ptrs, P, cap, ekw["grid_x"], ekw["num_tiles"], keys.data_ptr(),
                       owner.data_ptr(), *(t.data_ptr() for t in scratch), stream)
            if err:
                raise RuntimeError(f"expand launch failed: {err}")

        calls["expand"] = (expand, (torch.empty(cap, dtype=torch.int64, device=dev),
                                    torch.empty(cap, dtype=torch.int32, device=dev)))
    if "untile" in libs:
        fn_u = libs["untile"].gs_untile
        fn_u.argtypes = [vp] + [ci] * 7 + [vp] * 2
        fn_u.restype = ci
        cols, h, w = ukw["cols"], ukw["height"], ukw["width"]

        def untile(out):
            err = fn_u(packed.data_ptr(), packed.stride(1), cols, ukw["grid_x"], ukw["tile_w"],
                     ukw["tile_h"], h, w, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"untile launch failed: {err}")

        calls["untile"] = (untile, torch.full((cols, h, w), float("nan"), device=dev))
    if "retile" in libs:
        fn_r = libs["retile"].gs_retile
        fn_r.argtypes = [vp] + [ci] * 7 + [vp] * 2
        fn_r.restype = ci
        cols, h, w = d_img.shape
        gx, gy = ukw["grid_x"], ukw["grid_y"]

        def retile(out):
            err = fn_r(d_img.data_ptr(), cols, gx, gy, ukw["tile_w"], ukw["tile_h"], h, w,
                       out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"retile launch failed: {err}")

        calls["retile"] = (retile, torch.full((gx * gy, ukw["tile_w"] * ukw["tile_h"], cols),
                                              float("nan"), device=dev))
    if "segment_reduce" in libs:
        lib = libs["segment_reduce"]
        n, P = d_exp.shape[0], offsets.shape[0] - 1
        # three interfaces: the block design takes n and a scratch array of
        # block ends, the warp design n, the first design neither
        blocked = hasattr(lib, "gs_segment_reduce_block_items")
        warped = hasattr(lib, "gs_segment_reduce_window_rows")
        ends = torch.empty(-(-(n + P + 1) // lib.gs_segment_reduce_block_items()) + 1
                           if blocked else 0, dtype=torch.int32, device=dev)
        fn_s = lib.gs_segment_reduce
        fn_s.argtypes = ([vp, vp, ci, ci, vp, vp, vp] if blocked else
                         [vp, vp, ci, ci, vp, vp] if warped else [vp, vp, ci, vp, vp])
        fn_s.restype = ci

        def segment_reduce(out):
            if blocked:
                err = fn_s(d_exp.data_ptr(), offsets.data_ptr(), n, P, out.data_ptr(),
                           ends.data_ptr(), stream)
            elif warped:
                err = fn_s(d_exp.data_ptr(), offsets.data_ptr(), n, P, out.data_ptr(), stream)
            else:
                err = fn_s(d_exp.data_ptr(), offsets.data_ptr(), P, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"segment_reduce launch failed: {err}")

        calls["segment_reduce"] = (segment_reduce,
                                   torch.full((P, 10), float("nan"), device=dev))
    if "segscan" in libs:
        vals, flags = scan
        fn_c = libs["segscan"].gs_segscan
        fn_c.argtypes = [vp, vp, ci, ci, vp, vp]
        fn_c.restype = ci

        def segscan(out):
            err = fn_c(vals.data_ptr(), flags.data_ptr(), vals.shape[1], vals.shape[0],
                       out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"segscan launch failed: {err}")

        calls["segscan"] = (segscan, torch.full_like(vals, float("nan")))
    return calls


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", action="append", required=True,
                        help="name=directory holding expand.cu and/or untile.cu")
    parser.add_argument("--probe", action="append", default=[],
                        help="name=directory of a probe build: timed, not held to the twin")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gaussian_splatting_torch.ops import blend as bl
    from gaussian_splatting_torch.ops import expand as ex
    from gaussian_splatting_torch.ops import instances as inst
    from gaussian_splatting_torch.ops import segreduce as sr
    from gaussian_splatting_torch.ops import segscan as ss
    from gaussian_splatting_torch.ops import untile as ut
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.ops.rasterize import blend_fields, expansion_order

    chip_smoke.device_phase()
    variants = dict(v.split("=", 1) for v in args.variant + args.probe)
    probes = {v.split("=", 1)[0] for v in args.probe}
    t0 = time.perf_counter()
    libs = {name: build(name, os.path.abspath(d)) for name, d in variants.items()}
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    root = os.path.join(ROOT, "build", "layout_ab", "fixture")
    _, model_dir = chip_smoke.make_fixture(root, args.seed)
    setup = chip_smoke.train_setup(model_dir, args.seed)
    model, cam = setup["state"].model, setup["cams"][0].cam
    dev = torch.device("cuda")
    with torch.no_grad():
        proj = preprocess(*model.activated_params(), cam, sh_degree=chip_smoke.SH_DEGREE)
        fields = blend_fields(proj)
    capacity = inst.required_capacity(model.capacity, setup["raster"].instance_slack)
    layout, bargs, packed, d_img, grid = chip_smoke.backward_inputs(setup, proj, fields,
                                                                   capacity)
    with torch.no_grad():
        # K6's rows: K5 on the step's cotangent, in expansion order
        ct = ut.retile_plain(d_img, **grid)
        d_exp = expansion_order(bl.blend_backward(*bargs, packed, ct, grid_x=grid["grid_x"]),
                                layout)
        offsets = layout.seg_offsets
        table, _ = inst.build_table(proj)
        gx, gy = -(-chip_smoke.WIDTH // 16), -(-chip_smoke.HEIGHT // 16)
        ekw = dict(capacity=inst.internal_capacity(capacity), grid_x=gx, num_tiles=gx * gy)
        ukw = dict(grid, width=chip_smoke.WIDTH, height=chip_smoke.HEIGHT, cols=bl.CT_COLS)
        scan = chip_smoke.segscan_inputs(d_exp, offsets)
        want = {"expand": ex.expand_instances_plain(table, **ekw),
                "untile": ut.untile_plain(packed, **ukw),
                "retile": ut.retile_plain(d_img, **grid),
                "segment_reduce": sr.segment_reduce_rows_plain(d_exp, offsets),
                "segscan": ss.segmented_cumsum_plain(*scan)}
        print(f"inputs: {table.depth_key.shape[0]} Gaussians, {ekw['capacity']} slots; "
              f"packed {tuple(packed.shape)} record stride {packed.stride(1)}, "
              f"{ukw['cols']} columns")
        chip_smoke.expand_work(table, ekw)
        chip_smoke.untile_work(packed, ukw)
        print(f"retile: image gradient {tuple(d_img.shape)}; segment_reduce: "
              f"{tuple(d_exp.shape)} rows, {offsets.shape[0] - 1} segments")
        chip_smoke.segreduce_work(offsets, d_exp.shape[0])

        results, runs = {}, {}
        for name in variants:
            runs[name] = launchers(libs[name], table, ekw, packed, ukw, d_img, d_exp, offsets,
                                   scan, dev)
            results[name] = {}
            for k, (call, out) in runs[name].items():
                call(out)
                torch.cuda.synchronize()
                same = (all(torch.equal(a, b) for a, b in zip(out, want[k])) if k == "expand"
                        else torch.equal(out.view(torch.int32), want[k].view(torch.int32))
                        if k == "segscan" else torch.equal(out, want[k]))
                if not same and name not in probes:
                    raise RuntimeError(f"{name}/{k} disagrees with its plain twin")
                results[name][f"{k}_equal"] = same
                results[name][f"{k}_ms"] = []
        order = (list(variants) + list(reversed(variants))) * args.rounds
        for name in order:
            for k, (call, out) in runs[name].items():
                results[name][f"{k}_ms"].append(
                    chip_smoke.cuda_ms(lambda: call(out), iters=args.iters))
        # the profiler's device time per call: each grid's mean over the
        # launches it recorded of 40 (it misses the first few), summed over
        # the grids a call launches
        for name in variants:
            for k, (call, out) in runs[name].items():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(40):
                        call(out)
                    torch.cuda.synchronize()
                grids = {e.key.split("(")[-2].split("::")[-1]: (e.count, e.self_device_time_total)
                         for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
                results[name][f"{k}_profiler_ms"] = sum(t / c for c, t in grids.values()) / 1e3
                results[name][f"{k}_grid_ms"] = {g: t / c / 1e3 for g, (c, t) in grids.items()}
    card = chip_smoke.card()
    for name, r in results.items():
        print(json.dumps({"variant": name, "card": card, **r}))
    print(card)


if __name__ == "__main__":
    sys.exit(main())
