"""Synthetic scenes for tests and chip runs.

``random_scene`` makes the same numpy draws, in the same order, as
``gaussian_splatting_tpu/utils/testing.py::random_scene``, so one seed gives
both packages the same Gaussians and camera.  ``viewer_message`` and
``ViewerClient`` play the SIBR viewer's side of ``viewer.network_gui``;
``random_lpips_weights`` and ``analytic_test_rays`` make the evaluation
suite's inputs.  ``World`` runs functions on every rank of a gloo world of
spawned CPU processes; the ``*_worker`` functions are the multi-GPU tests'
ranks, and ``emulated_exchange`` emulates gshard's n ranks in one process.
"""

from __future__ import annotations

import json
import math
import socket
import struct
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussian_splatting_torch import resolve_device
from gaussian_splatting_torch.ops.camera_math import CameraParams, look_at, make_camera
from gaussian_splatting_torch.ops.sh import num_sh_coeffs, rgb_to_sh


class SyntheticScene(NamedTuple):
    means3d: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    sh: torch.Tensor
    cam: CameraParams
    bg: torch.Tensor


def random_arrays(
    num_gaussians: int,
    *,
    sh_degree: int = 0,
    seed: int = 0,
    spread: float = 1.0,
    scale_range=(0.01, 0.08),
):
    """Activated Gaussian parameters as float32 numpy arrays: (means,
    scales, unit quats, opacities, sh (P, K, 3))."""
    rng = np.random.default_rng(seed)
    P = num_gaussians
    means = rng.normal(0.0, spread / 2.0, (P, 3)).astype(np.float32)
    scales = np.exp(
        rng.uniform(np.log(scale_range[0]), np.log(scale_range[1]), (P, 3))
    ).astype(np.float32)
    quats = rng.normal(0.0, 1.0, (P, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, (P,)).astype(np.float32)
    K = num_sh_coeffs(sh_degree)
    sh = np.zeros((P, K, 3), np.float32)
    sh[:, 0, :] = rgb_to_sh(rng.uniform(0.0, 1.0, (P, 3))).astype(np.float32)
    if K > 1:
        sh[:, 1:, :] = rng.normal(0.0, 0.05, (P, K - 1, 3)).astype(np.float32)
    return means, scales, quats, opac, sh


def random_scene(
    num_gaussians: int = 1000,
    *,
    sh_degree: int = 0,
    width: int = 256,
    height: int = 256,
    seed: int = 0,
    spread: float = 1.0,
    scale_range=(0.01, 0.08),
    cam_distance: float = 4.0,
    bg=(0.0, 0.0, 0.0),
    device=None,
) -> SyntheticScene:
    """Random Gaussians in a ball around the origin, camera looking at it."""
    dev = resolve_device(device)
    arrays = random_arrays(
        num_gaussians, sh_degree=sh_degree, seed=seed, spread=spread,
        scale_range=scale_range,
    )
    R, t = look_at([0.3, -0.2, -cam_distance], [0.0, 0.0, 0.0])
    cam = make_camera(
        R, t, fovx=0.9, fovy=0.9 * height / width, width=width, height=height,
        device=dev,
    )
    means, scales, quats, opac, sh = (torch.from_numpy(a).to(dev) for a in arrays)
    return SyntheticScene(
        means3d=means, scales=scales, quats=quats, opacities=opac, sh=sh,
        cam=cam, bg=torch.tensor(bg, dtype=torch.float32, device=dev),
    )


# Edge cases of K1's block decomposition (csrc/expand.cu: blocks of 512
# merged slots and offsets entries, 4 span rows staged per Gaussian), as
# hand-built expansion tables on a 64 x 40 tile grid.
EXPAND_EDGE_CASES = ("straddles_blocks", "sentinel_run", "zero_counts", "no_gaussians",
                     "one_gaussian", "demand_equals_capacity", "ragged_capacity",
                     "spans_past_staged_rows")
_EDGE_GRID = (64, 40)


def expand_edge_table(name: str, device=None):
    """(ExpandTable, capacity, grid_x, num_tiles) of one edge case of
    ``EXPAND_EDGE_CASES``, from a seed of its own.  Every Gaussian is a
    full rect, a span (one contiguous run of tiles in each of its rows,
    ``span_cum`` the running cell count), a sentinel (one slot, depth
    ``BIG``) or, in "zero_counts", a Gaussian that owns no slot."""
    from gaussian_splatting_torch.ops import expand as ex

    gx, gy = _EDGE_GRID
    rng = np.random.default_rng(sum(map(ord, name)))
    rows = []  # (count, x0, y0, w, flag, span_x0 row, span_cum row, depth)

    def rect(w, h):
        x0, y0 = int(rng.integers(0, gx - w + 1)), int(rng.integers(0, gy - h + 1))
        rows.append((w * h, x0, y0, w, 0, [0] * 16, [0] * 16, float(rng.uniform(0.2, 50))))

    def span(lengths):
        y0 = int(rng.integers(0, gy - len(lengths) + 1))
        xs = [int(rng.integers(0, gx - n + 1)) for n in lengths]
        cum = np.cumsum(lengths).tolist()
        cum += [cum[-1]] * (16 - len(cum))
        rows.append((cum[-1], min(xs), y0, max(lengths), 1, xs + [0] * (16 - len(xs)), cum,
                     float(rng.uniform(0.2, 50))))

    def sentinel():
        rows.append((1, 0, 0, 1, 0, [0] * 16, [0] * 16, ex.BIG))

    def mixed(n, max_rows=6):
        for _ in range(n):
            u = rng.uniform()
            if u < 0.5:
                span([int(k) for k in rng.integers(1, 5, int(rng.integers(1, max_rows + 1)))])
            elif u < 0.85:
                rect(int(rng.integers(1, 6)), int(rng.integers(1, 5)))
            else:
                sentinel()

    slack = 700
    if name == "straddles_blocks":
        mixed(40)
        rect(40, 30)  # 1200 slots: more than one block's 512 items
        mixed(20)
        span([60] * 16)  # 960 slots in 16 rows
        mixed(40)
    elif name == "sentinel_run":
        mixed(30)
        for _ in range(1300):
            sentinel()
        mixed(30)
    elif name == "zero_counts":
        mixed(60)
        for i in range(1100):  # a run longer than a block, with 3 live ones inside
            if i in (17, 600, 1099):
                mixed(1)
            else:
                rows.append((0, 0, 0, 1, 0, [0] * 16, [0] * 16, 1.0))
        mixed(60)
        rows.insert(0, (0, 0, 0, 1, 0, [0] * 16, [0] * 16, 2.0))  # g = 0 owns nothing
        rows.append((0, 0, 0, 1, 0, [0] * 16, [0] * 16, 3.0))  # nor does the last
    elif name == "no_gaussians":
        pass
    elif name == "one_gaussian":
        span([3, 4])
        slack = 1000
    elif name == "demand_equals_capacity":
        mixed(300)
        slack = 0
    elif name == "ragged_capacity":
        mixed(300)
        slack = 333
    elif name == "spans_past_staged_rows":
        for _ in range(200):
            span([int(k) for k in rng.integers(1, 4, int(rng.integers(4, 17)))])
    else:
        raise ValueError(name)

    dev = resolve_device(device)

    def col(k, dtype):
        return torch.tensor([r[k] for r in rows], dtype=dtype, device=dev).reshape(
            (len(rows),) + ((16,) if k in (5, 6) else ()))

    counts = torch.tensor([r[0] for r in rows], dtype=torch.int64)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)]).to(torch.int32)
    table = ex.ExpandTable(
        offsets=offsets.to(dev), rect_x0=col(1, torch.int32), rect_y0=col(2, torch.int32),
        rect_w=col(3, torch.int32), span_flag=col(4, torch.int32), span_x0=col(5, torch.int32),
        span_cum=col(6, torch.int32), depth_key=col(7, torch.float32))
    return table, int(counts.sum()) + slack, gx, gx * gy


SEGREDUCE_EDGE_CASES = ("all_empty", "one_long_segment", "clamped_to_n", "no_gaussians",
                        "zero_runs", "ragged_tail") + tuple(
    f"window_offset_{s}" for s in range(4))


def segreduce_edge_table(name: str, device=None, long_rows: int = 100_000):
    """(rows (N, 10) float32, offsets (P + 1,) int32) of one edge case of
    ``SEGREDUCE_EDGE_CASES``, from a seed of its own: every segment empty;
    one segment of ``long_rows`` rows among short ones; offsets clamped to
    N (an overflowed frame); P of 0; runs of empty segments longer than a
    warp's 32 among short segments, with -0.0 values; N odd, so the rows'
    last float4 runs past their end; and, for s in 0..3, segments shifted by
    a first one of s rows so that a 700-row segment crosses the kernel's
    staging windows at each offset modulo the 4-float staging width, with s
    rows past the last offset."""
    rng = np.random.default_rng(sum(map(ord, name)))
    extra = 0  # rows past the last offset
    clamp = None
    if name == "all_empty":
        lengths, extra = [0] * 1300, 40
    elif name == "one_long_segment":
        lengths = [int(k) for k in rng.integers(0, 5, 300)] + [long_rows] + [
            int(k) for k in rng.integers(0, 5, 300)]
    elif name == "clamped_to_n":
        lengths = [int(k) for k in rng.integers(0, 9, 3000)]
        clamp = sum(lengths) - 137
    elif name == "no_gaussians":
        lengths, extra = [], 50
    elif name == "zero_runs":
        lengths = [int(k) for k in rng.integers(0, 9, 800)] + [0] * 1200 + [
            int(k) for k in rng.integers(0, 9, 800)] + [0] * 600
    elif name == "ragged_tail":
        lengths = [int(k) for k in rng.integers(1, 7, 1500)]
        lengths[-1] += 1 - sum(lengths) % 2  # N odd
    elif name.startswith("window_offset_"):
        s = int(name[-1])
        lengths = [s] + [3] * 100 + [700] + [2, 0, 5] * 50 + [1]
        extra = s
    else:
        raise ValueError(name)
    dev = resolve_device(device)
    cum = np.concatenate([[0], np.cumsum(lengths, dtype=np.int64)])
    n = int(cum[-1]) + extra if clamp is None else clamp
    offsets = np.minimum(cum, n).astype(np.int32)
    rows = rng.standard_normal((n, 10)).astype(np.float32)
    if name == "zero_runs":
        rows[rng.uniform(size=n) < 0.1] = -0.0
    return torch.from_numpy(rows).to(dev), torch.from_numpy(offsets).to(dev)


SEGSCAN_EDGE_CASES = ("empty", "single", "odd", "all_starts", "one_segment", "zero_segments") + \
    tuple(f"crossing_{s}" for s in range(4))
# the indices whose segment starts one block of K7 owns (csrc/segscan.cu)
SEGSCAN_WINDOW = 512


def segscan_edge_table(name: str, rows: int = 10, device=None):
    """(vals (rows, n) float32, flags (n,) float32) of one edge case of
    ``SEGSCAN_EDGE_CASES``, from a seed of its own: n of 0 and 1; n odd with
    a leading run before the first flag; every index a start; one segment
    over all of n; segments of exact zeros with -0.0 values; and, for s in
    0..3, everything shifted by s indices (so that rows start at each offset
    modulo the 4-float staging width) with a segment that crosses the first
    window boundary and ends in the staged tail, and one that crosses the
    second and runs past the tail."""
    rng = np.random.default_rng(sum(map(ord, name)) + rows)
    W = SEGSCAN_WINDOW
    if name == "empty":
        flags = np.zeros(0, np.float32)
    elif name == "single":
        flags = np.zeros(1, np.float32)
    elif name == "odd":
        flags = (rng.uniform(size=2 * W + 1001) < 0.3).astype(np.float32)
        flags[:50] = 0.0
    elif name == "all_starts":
        flags = np.ones(3 * W + 1, np.float32)
    elif name == "one_segment":
        flags = np.zeros(3 * W + 77, np.float32)
    elif name == "zero_segments":
        flags = (rng.uniform(size=2 * W + 300) < 0.2).astype(np.float32)
    elif name.startswith("crossing_"):
        s = int(name[-1])
        n = 3 * W + 200 + s
        flags = np.zeros(n, np.float32)
        flags[s::3] = 1.0
        for a, b in ((W - 5 + s, W + 35 + s), (2 * W - 2 + s, 2 * W + 198 + s)):
            flags[a:b] = 0.0
            flags[a] = flags[b] = 1.0
    else:
        raise ValueError(name)
    vals = rng.standard_normal((rows, flags.shape[0])).astype(np.float32)
    if name == "zero_segments":
        starts = np.flatnonzero(flags)
        for a, b in zip(starts[::4], starts[1::4]):
            vals[:, a:b] = 0.0
            vals[:, a] = -0.0
    dev = resolve_device(device)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(flags).to(dev)


def write_images_binary_with_tracks(path: str, images: Dict) -> None:
    """``images.bin`` with each image's 2D observations (``xys`` and
    ``point3d_ids`` of ``data.colmap.ColmapImage``), which COLMAP writes and
    ``data.colmap.write_images_binary``, like the JAX package's writer,
    leaves empty.  The depth-scale fit needs them."""
    from gaussian_splatting_torch.data.colmap import OBSERVATION

    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i4d3di", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode() + b"\x00")
            n = 0 if im.xys is None else len(im.xys)
            rec = np.empty(n, OBSERVATION)
            if n:
                rec["x"], rec["y"], rec["id"] = im.xys[:, 0], im.xys[:, 1], im.point3d_ids
            f.write(struct.pack("<Q", n) + rec.tobytes())


def viewer_message(cam: CameraParams, *, train: bool, scaling_modifier: float = 1.0,
                   keep_alive: bool = False) -> dict:
    """The SIBR viewer's request for ``cam``: its matrices in the row-vector
    convention with the client's sign flips, which the server's
    ``_decode_camera`` undoes exactly."""
    view = cam.viewmatrix.cpu().numpy().T.copy()
    view[:, 1:3] *= -1
    proj = cam.projmatrix.cpu().numpy().T.copy()
    proj[:, 1] *= -1
    return {
        "resolution_x": cam.width, "resolution_y": cam.height, "train": train,
        "fov_x": 2.0 * math.atan(cam.tan_fovx), "fov_y": 2.0 * math.atan(cam.tan_fovy),
        "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
        "view_matrix": view.ravel().tolist(),
        "view_projection_matrix": proj.ravel().tolist(),
    }


class ViewerClient:
    """A loopback viewer client: connects (retrying until ``timeout``
    while the server is not yet listening) and sends requests, each
    answered by a frame and the verify string."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.sock = socket.create_connection((host, port), timeout=timeout)
                return
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            part = self.sock.recv(n - len(buf))
            if not part:
                raise ConnectionError("viewer server closed the connection")
            buf += part
        return buf

    def request(self, message: dict) -> Tuple[Optional[bytes], str]:
        """(frame: H x W x 3 uint8 bytes or None, verify string)."""
        data = json.dumps(message).encode("utf-8")
        self.sock.sendall(len(data).to_bytes(4, "little") + data)
        n = message["resolution_x"] * message["resolution_y"] * 3
        frame = self._recv_exact(n) if n else None
        verify = self._recv_exact(int.from_bytes(self._recv_exact(4), "little"))
        return frame, verify.decode("ascii")

    def close(self) -> None:
        self.sock.close()


# torchvision's VGG16 convolutions (features.N: in, out channels) and the
# LPIPS heads' widths
VGG16_CHANNELS = {
    0: (3, 64), 2: (64, 64),
    5: (64, 128), 7: (128, 128),
    10: (128, 256), 12: (256, 256), 14: (256, 256),
    17: (256, 512), 19: (512, 512), 21: (512, 512),
    24: (512, 512), 26: (512, 512), 28: (512, 512),
}
LPIPS_HEAD_CHANNELS = (64, 128, 256, 512, 512)


def random_lpips_weights(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """LPIPS weights of the real shapes (14.7M parameters) drawn as the
    JAX package's LPIPS test draws them; only the math can be checked with
    them, they measure no quality."""
    raw = {}
    for lid, (cin, cout) in VGG16_CHANNELS.items():
        raw[f"features.{lid}.weight"] = rng.normal(0, 0.08, (cout, cin, 3, 3)).astype(np.float32)
        raw[f"features.{lid}.bias"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
    for si, c in enumerate(LPIPS_HEAD_CHANNELS):
        raw[f"lin{si}.model.1.weight"] = np.abs(rng.normal(0, 0.3, (1, c, 1, 1))).astype(np.float32)
    return raw


def analytic_test_rays(n: int = 4096, seed: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """(eye (3,), unit directions (n, 3)), float64: the rays the JAX
    package's shader-parity test traces, from an orbit-like eye through a
    spread of directions that mixes hits and misses."""
    rng = np.random.default_rng(seed)
    eye = np.array([2.6, 1.7, -2.9])
    d = np.stack([rng.uniform(-0.45, 0.45, n), rng.uniform(-0.45, 0.2, n), np.ones(n)], axis=1)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    upv = np.cross(fwd, right)
    d = d[:, 0:1] * right + d[:, 1:2] * upv + d[:, 2:3] * fwd
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return eye, d


# ---- multi-rank worlds ------------------------------------------------------
# ``World`` spawns ranks that import the worker function by name, so the
# workers live here, in a module that imports nothing of JAX.


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_numpy(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_numpy(v) for v in value)
    return value


def _world_rank(calls, rank, world, port, results, timeout_s):
    import os
    import traceback

    from gaussian_splatting_torch.parallel import mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        mesh.init_distributed("cpu", timeout_s=timeout_s)
        results.put((rank, None, _to_numpy([fn(rank, world, *args) for fn, *args in calls])))
    except Exception:
        results.put((rank, traceback.format_exc(), None))
    finally:
        mesh.shutdown()


class World:
    """Each call ``(fn, *args)`` in turn, as ``fn(rank, world, *args)``, on
    every rank of a gloo world of ``world`` spawned processes on the CPU, as
    ``torchrun`` would start them.  The ranks start at once; ``results``
    waits for them.  Each ``fn`` must be importable from a module that
    imports no JAX: the ranks import it afresh."""

    def __init__(self, world: int, *calls, timeout_s: float = 120.0):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout_s = world, timeout_s
        self.deadline = time.monotonic() + timeout_s
        self.queue = ctx.Queue()
        port = _free_port()
        self.procs = [ctx.Process(target=_world_rank,
                                  args=(calls, r, world, port, self.queue, timeout_s))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        """Each rank's list of results, in rank order, tensors as numpy
        arrays.  Raises if a rank raised or died, or when the world outlives
        its ``timeout_s``; every process has ended when it returns."""
        import queue

        out = {}
        try:
            while len(out) < self.world:
                try:
                    r, error, value = self.queue.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in self.procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank died with exit code {dead[0]}")
                    if time.monotonic() > self.deadline:
                        raise TimeoutError(f"the world of {self.world} ranks ran past "
                                           f"{self.timeout_s} s")
                    continue
                if error is not None:
                    raise RuntimeError(f"rank {r} of {self.world} failed:\n{error}")
                out[r] = value
        finally:
            for p in self.procs:
                if len(out) < self.world:
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [out[r] for r in range(self.world)]


def collective_inputs(rank: int, world: int) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s inputs of ``collectives_worker``; ``shared`` is the
    same on every rank."""
    g = np.random.default_rng(100 + rank)
    return {
        "x": g.normal(size=(world, 3)).astype(np.float32),
        "w": g.normal(size=(world, 3)).astype(np.float32),
        "stripe": g.normal(size=(2, 7, 4)).astype(np.float32),
        "halo_w": g.normal(size=(2, 11, 4)).astype(np.float32),
        "shared": np.random.default_rng(7).normal(size=(world, 3)).astype(np.float32),
    }


def collectives_worker(rank: int, world: int) -> Dict[str, torch.Tensor]:
    """Each collective's value and its input's gradient for a weighted sum
    of its output (``collective_inputs``; a 2-row halo on 7-row stripes)."""
    from gaussian_splatting_torch.parallel import collectives as coll

    t = {k: torch.from_numpy(v) for k, v in collective_inputs(rank, world).items()}
    out = {}
    for name, fn, x, w in (
        ("sum", coll.all_reduce_sum, t["x"], t["w"]),
        ("a2a", coll.all_to_all, t["x"], t["w"]),
        ("halo", lambda v: coll.halo_exchange(v, 2), t["stripe"], t["halo_w"]),
        ("gather", coll.all_gather, t["x"][0], t["shared"]),
    ):
        leaf = x.clone().requires_grad_(True)
        y = fn(leaf)
        (g,) = torch.autograd.grad((y * w).sum(), leaf)
        out[name], out[name + "_grad"] = y, g
    out["max"] = coll.all_reduce_max(torch.tensor([rank, -rank], dtype=torch.int32))
    out["any"] = coll.all_reduce_max(torch.tensor(rank == world - 1))
    return out


# the sharded render checks: the issue's 48 x 32 px, 256 Gaussians
SHARD_RENDER = dict(width=48, height=32, num_gaussians=256)


def shard_render_scene(heavy: bool = False) -> SyntheticScene:
    """The sharded render's scene; ``heavy`` has large Gaussians, most of
    which straddle stripe boundaries."""
    kw = dict(spread=0.6, scale_range=(0.1, 0.3), seed=11) if heavy else dict(seed=9)
    return random_scene(SHARD_RENDER["num_gaussians"], sh_degree=1,
                        width=SHARD_RENDER["width"], height=SHARD_RENDER["height"],
                        device="cpu", **kw)


def shard_render_worker(rank: int, world: int) -> Dict[str, torch.Tensor]:
    """``render_gaussian_sharded`` on this rank's contiguous shard: the image,
    the overflow flag and the means' gradient of sum((image - 0.25)^2); on
    the heavy scene, the overflow flag at ``exchange_capacity=8`` and the
    image and flag at the default capacity."""
    from gaussian_splatting_torch.parallel.gshard import render_gaussian_sharded

    def shard(scene, grad=False):
        k = scene.means3d.shape[0] // world
        arrays = [a[rank * k: (rank + 1) * k].clone() for a in
                  (scene.means3d, scene.scales, scene.quats, scene.opacities, scene.sh)]
        arrays[0].requires_grad_(grad)
        return arrays

    s = shard_render_scene()
    leaves = shard(s, grad=True)
    image, overflow = render_gaussian_sharded(*leaves, s.cam, s.bg, sh_degree=1,
                                              return_overflow=True)
    (grad,) = torch.autograd.grad(((image - 0.25) ** 2).sum(), leaves[0])
    h = shard_render_scene(heavy=True)
    with torch.no_grad():
        _, tiny = render_gaussian_sharded(*shard(h), h.cam, h.bg, sh_degree=1,
                                          exchange_capacity=8, return_overflow=True)
        heavy, heavy_ovf = render_gaussian_sharded(*shard(h), h.cam, h.bg, sh_degree=1,
                                                   return_overflow=True)
    return dict(image=image, overflow=overflow, grad=grad, tiny_overflow=tiny,
                heavy_image=heavy, heavy_overflow=heavy_ovf)


def step_batch(gt: np.ndarray, exposure_idx: int = 0, invdepth: Optional[np.ndarray] = None,
               depth_mask: Optional[np.ndarray] = None):
    """A ``train.step.StepBatch`` on the CPU: black background, no alpha."""
    from gaussian_splatting_torch.train.step import StepBatch

    h, w = gt.shape[1:]
    zeros = torch.zeros((h, w))
    return StepBatch(
        gt_image=torch.from_numpy(gt), alpha_mask=torch.ones((1, h, w)),
        invdepth_gt=zeros if invdepth is None else torch.from_numpy(invdepth),
        depth_mask=zeros if depth_mask is None else torch.from_numpy(depth_mask),
        exposure_idx=torch.tensor(exposure_idx), bg_color=torch.zeros(3))


def parallel_steps_worker(rank: int, world: int, mode: str, leaves: Dict, batches: list,
                          cam_seeds: list, steps: int, use_exposure: bool,
                          use_depth: bool) -> Dict:
    """``steps`` iterations of ``dp_train_step`` (rank r: camera ``cam_seeds[r]``
    and batch r of ``batches``, dicts of ``step_batch`` arguments) or of
    ``gshard_train_step`` (every rank: camera and batch 0, the state
    sharded) from the state ``interop.train_state_from_jax(**leaves)``.
    Returns each step's packed metrics and the final whole state."""
    from gaussian_splatting_torch.config import OptimizationConfig, RasterizeConfig
    from gaussian_splatting_torch.interop import train_state_from_jax
    from gaussian_splatting_torch.parallel.dp import dp_train_step
    from gaussian_splatting_torch.parallel.gshard import (
        gather_state,
        gshard_train_step,
        shard_state,
    )

    w, h = batches[0]["gt"].shape[2], batches[0]["gt"].shape[1]
    state = train_state_from_jax(**leaves, device="cpu")
    view = rank if mode == "dp" else 0
    cam = random_scene(4, width=w, height=h, seed=cam_seeds[view], device="cpu").cam
    batch = step_batch(**batches[view])
    if mode == "gshard":
        state = shard_state(state)
    step = dp_train_step if mode == "dp" else gshard_train_step
    packed = []
    for _ in range(steps):
        state, metrics = step(state, cam, batch, opt=OptimizationConfig(),
                              raster=RasterizeConfig(), use_exposure=use_exposure,
                              use_depth=use_depth)
        packed.append(metrics["packed"])
    if mode == "gshard":
        state = gather_state(state)
    return {"packed": torch.stack(packed), "state": state.tensors()}


def parallel_train_worker(rank: int, world: int, scene_dir: str, out_dir: str, modes: list,
                          train_kw: Dict) -> Dict:
    """``train.loop.train`` on the CPU with each ``parallel`` mode of
    ``modes`` in turn (model path ``out_dir/<mode>``): each iteration's loss,
    the returned state, and every path under ``out_dir`` this rank opened
    for writing or created (an audit hook's record)."""
    import os
    import sys

    from gaussian_splatting_torch.config import ModelConfig, OptimizationConfig, PipelineConfig
    from gaussian_splatting_torch.train.loop import train

    writes = set()
    writing_flags = os.O_WRONLY | os.O_RDWR | os.O_CREAT

    def audit(event, args):
        if event == "open":
            path, mode, flags = args
            if not (mode and any(c in mode for c in "wax+")) and not (
                    mode is None and isinstance(flags, int) and flags & writing_flags):
                return
        elif event in ("os.mkdir", "os.rename", "os.remove", "shutil.copyfile"):
            path = args[-1] if event == "shutil.copyfile" else args[0]
        else:
            return
        if isinstance(path, (str, os.PathLike)) and os.fspath(path).startswith(out_dir):
            writes.add(os.path.relpath(os.fspath(path), out_dir))

    sys.addaudithook(audit)
    out = {}
    for mode in modes:
        losses = []
        cfg = ModelConfig(source_path=scene_dir, model_path=os.path.join(out_dir, mode))
        state = train(cfg, OptimizationConfig(**train_kw["opt"]), PipelineConfig(),
                      parallel=mode, device="cpu",
                      on_iteration=lambda it, s, m: losses.append(float(m["packed"][0])),
                      **{k: v for k, v in train_kw.items() if k != "opt"})
        out[mode] = {"losses": losses, "state": state.tensors()}
    out["writes"] = sorted(writes)
    return out


def emulated_exchange(means3d, scales, quats, opacities, sh, cam, *, n: int, sh_degree: int):
    """gshard's exchange for n ranks, emulated in one process: n contiguous
    shards each projected, packed and routed, and stripe d given the
    rank-major concatenation of the n sends addressed to it, which is what
    ``all_to_all`` delivers.  Returns (each stripe's (n * cap_x, 16)
    records, ``stripe_from_records``'s keyword arguments but ``d`` and
    ``bg_color``, records routed as (source, destination) counts, and
    whether any exchange buffer overflowed)."""
    from gaussian_splatting_torch.config import RasterizeConfig
    from gaussian_splatting_torch.ops.expand import BIG
    from gaussian_splatting_torch.ops.preprocess import preprocess
    from gaussian_splatting_torch.parallel import gshard

    cfg = RasterizeConfig()
    tile_w, tile_h, grid_x, grid_y_local = gshard._geometry(cam, cfg, n)
    total = means3d.shape[0]
    cap_x, capacity = gshard._capacities(total, n, cfg, 0)
    k = total // n
    sends, overflow = [], False
    for s in range(n):
        part = [a[s * k: (s + 1) * k] for a in (means3d, scales, quats, opacities, sh)]
        proj = preprocess(*part, cam, sh_degree=sh_degree, tile_w=tile_w, tile_h=tile_h,
                          antialiasing=cfg.antialiasing)
        send, ovf = gshard.route_records(gshard.pack_records(proj), proj, n=n,
                                         grid_y_local=grid_y_local, cap_x=cap_x)
        sends.append(send)
        overflow |= bool(ovf)
    received = [torch.cat([sends[s][d] for s in range(n)]) for d in range(n)]
    routed = [[int((sends[s][d][:, gshard.R_DEPTH] < BIG).sum()) for d in range(n)]
              for s in range(n)]
    kw = dict(grid_x=grid_x, grid_y_local=grid_y_local, tile_w=tile_w, tile_h=tile_h,
              width=cam.width, capacity=capacity)
    return received, kw, routed, overflow


def crop_fovs(width: int, height: int, fovx: float, fovy: float, w: int, h: int):
    """The central ``w`` x ``h`` window of a ``width`` x ``height`` view, at
    the view's own focal lengths: (fovx', fovy', x0, y0), with
    fov' = 2 atan(w / (2 f)) and (x0, y0) the window's first pixel.  The
    margins must be even, so that the window's pixel centres are the view's."""
    if (width - w) % 2 or (height - h) % 2:
        raise ValueError(f"a {w}x{h} window is not centred on {width}x{height} pixels")
    fx = width / (2.0 * math.tan(fovx / 2.0))
    fy = height / (2.0 * math.tan(fovy / 2.0))
    return (2.0 * math.atan(w / (2.0 * fx)), 2.0 * math.atan(h / (2.0 * fy)),
            (width - w) // 2, (height - h) // 2)


def slot_capacity(demand: int) -> int:
    """Twice a render's slot ``demand``, rounded up to a multiple of 1024:
    the capacity the late-state checks render with, past the demand."""
    return -(-2 * demand // 1024) * 1024


def read_state_crop(path: str) -> Dict[str, np.ndarray]:
    """A late-state fixture (``tools/torch_c4_probe.py --cut``) as numpy
    arrays: the six parameter arrays (``PARAM_NAMES``) of the Gaussians kept,
    the window's camera (``R``, ``T``, ``fovx``, ``fovy``, ``width``,
    ``height``), its ground truth ``gt`` (3, h, w), the scene's ``extent``,
    the snapshot's ``iteration`` and active ``sh_degree``."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def state_crop_camera(crop: Dict[str, np.ndarray], device=None) -> CameraParams:
    return make_camera(crop["R"], crop["T"], float(crop["fovx"]), float(crop["fovy"]),
                       int(crop["width"]), int(crop["height"]), device=device)


def state_crop_model(crop: Dict[str, np.ndarray], capacity: int, device=None):
    """The fixture's Gaussians in the first slots of a model of ``capacity``
    empty slots, at the snapshot's SH degree and the scene's extent."""
    from gaussian_splatting_torch.models.gaussians import PARAM_NAMES, GaussianModel

    n = crop["means3d"].shape[0]
    degree = int(crop["sh_degree"])
    model = GaussianModel.empty(capacity, degree, device=device)
    with torch.no_grad():
        for name in PARAM_NAMES:
            getattr(model, name)[:n] = torch.from_numpy(crop[name])
        model.alive[:n] = True
    model.spatial_lr_scale = float(crop["extent"])
    return model
