"""K7 segmented cumsum: running sums along a long axis that restart at
flagged indices.

Counterpart of ``gaussian_splatting_tpu/ops/segscan.py::segmented_cumsum``
without its TPU arguments (``block``, ``interpret``).  ``out[:, i]`` is the
sum of ``vals[:, j..i]`` since the last start ``j <= i``, where index 0 and
every index with ``flags > 0`` start a segment from a carry of +0.0.  The
sums run front to back with no difference of prefixes, so a segment of
exact zeros scans to exact zeros, and the value at a segment's last index
is the segment's total, bit for bit the sum K6 (``ops/segreduce.py``) forms.
"""

from __future__ import annotations

import ctypes

import torch

from gaussian_splatting_torch import _kernels


def segmented_cumsum(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """(rows, N) float32 values + (N,) float32 flags -> (rows, N) float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if vals.device.type == "cpu":
        return segmented_cumsum_plain(vals, flags)
    _kernels.check_cuda("segscan", vals, flags)
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError("segscan: vals must be (rows, N) float32")
    if flags.dtype != torch.float32 or flags.shape != (vals.shape[1],):
        raise ValueError("segscan: flags must be (N,) float32")
    rows, n = vals.shape
    out = torch.empty_like(vals)
    if out.numel() == 0:
        return out
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "segscan", "gs_segscan", [vp, vp, ci, ci, vp, vp],
        vals.data_ptr(), flags.data_ptr(), n, rows, out.data_ptr(),
        _kernels.current_stream(vals.device),
    )
    return out


def segmented_cumsum_plain(vals: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Plain twin: step k adds the k-th element of every running segment,
    front to back from +0.0 as the kernel does, so the two agree to the
    bit."""
    rows, n = vals.shape
    out = torch.empty_like(vals)
    if n == 0:
        return out
    is_start = flags > 0
    is_start[0] = True
    starts = torch.nonzero(is_start).flatten()
    lengths = torch.diff(starts, append=starts.new_full((1,), n))
    acc = torch.zeros((rows, starts.shape[0]), dtype=vals.dtype, device=vals.device)
    for k in range(int(lengths.max())):
        live = lengths > k
        pos = (starts + k).clamp(max=n - 1)
        acc = torch.where(live, acc + vals[:, pos], acc)
        out[:, pos[live]] = acc[:, live]
    return out
