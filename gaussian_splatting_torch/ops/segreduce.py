"""K6 segment reduce: per-Gaussian sums of expansion-order gradient rows.

Counterpart of ``gaussian_splatting_tpu/ops/segreduce.py::
segment_reduce_rows``.  The JAX kernel takes field-major (rows, N) values and
the owning Gaussian of every slot; the port takes row-major (N, 10) values
and the per-Gaussian segment offsets the expansion table already holds
(Gaussian g owns slots [offsets[g], offsets[g + 1])).  A Gaussian whose rows
are all zero gets exact zeros.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_torch import _kernels

COLS = 10


def segment_reduce_rows(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(N, 10) rows + (P + 1,) int32 offsets (non-decreasing, clamped to N)
    -> (P, 10) per-segment sums.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if rows.device.type == "cpu":
        return segment_reduce_rows_plain(rows, offsets)
    _kernels.check_cuda("segment_reduce", rows, offsets)
    if rows.dtype != torch.float32 or rows.dim() != 2 or rows.shape[1] != COLS:
        raise ValueError("segment_reduce: rows must be (N, 10) float32")
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError("segment_reduce: offsets must be (P + 1,) int32")
    P = offsets.shape[0] - 1
    out = torch.empty((P, COLS), dtype=torch.float32, device=rows.device)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "segment_reduce", "gs_segment_reduce", [vp, vp, ci, ci, vp, vp],
        rows.data_ptr(), offsets.data_ptr(), rows.shape[0], P, out.data_ptr(),
        _kernels.current_stream(rows.device),
    )
    return out


def segment_reduce_rows_plain(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain twin: step k adds the k-th row of every segment still running,
    front to back as the kernel does, so the two agree to the bit."""
    lo = offsets[:-1].long()
    lengths = offsets[1:].long() - lo
    P = lengths.shape[0]
    acc = torch.zeros((P, COLS), dtype=torch.float32, device=rows.device)
    steps = int(lengths.max()) if P else 0
    last = max(rows.shape[0] - 1, 0)
    for k in range(steps):
        live = (lengths > k)[:, None]
        acc = torch.where(live, acc + rows[(lo + k).clamp(max=last)], acc)
    return acc
