"""Process-group helpers: one process per rank, as ``torchrun`` starts them.

Counterpart of ``gaussian_splatting_tpu/parallel/mesh.py``.  JAX runs one
process over a device mesh; the port runs one process per card
(``torchrun --nproc_per_node N -m gaussian_splatting_torch.train --parallel
dp|gshard ...``), each running the same loop.  Without ``torchrun``'s
environment a process forms a world of one on a free loopback port, which is
how a single card runs the parallel modes.  The backend is NCCL for a CUDA
device and gloo for the CPU; an NCCL failure raises, it never falls back.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from gaussian_splatting_torch import resolve_device

# A rank that dies leaves its peers blocked in a collective until this passes.
TIMEOUT_S = 600.0


def init_distributed(device=None, timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join ``torchrun``'s process group (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or form a world of
    one; returns this rank's device.  A CUDA rank runs on ``cuda:LOCAL_RANK``
    and makes it the current device before its first kernel: the kernel
    launchers launch on the current device's current stream."""
    dev = resolve_device(device)
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    local = int(env.get("LOCAL_RANK", env.get("RANK", "0"))) if torchrun else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if torchrun:
        dist.init_process_group(backend, init_method="env://", rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]), timeout=timeout)
    else:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True, timeout=timeout)
        dist.init_process_group(backend, store=store, rank=0, world_size=1, timeout=timeout)
    return dev


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0 writes the run's files (configs, snapshots, checkpoints) and
    serves the viewer, so each is written once."""
    return rank() == 0


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
