"""K2 blend forward and K5 blend backward: per-tile front-to-back alpha
blending and its gradient.

Counterpart of ``gaussian_splatting_tpu/ops/blend_pallas.py``.  The output
layout, constants and the meaning of NB (the absolute sorted-stream position
at which a pixel's transmittance would fall below ``T_EPS``, else
``NB_BIG``) are kept exactly: the backward's contributor set is "eligible
and stream position < NB".  Instead of the (16, cap) sorted field records of
the TPU version, both directions read each instance's fields through the
sorted owner index from a per-Gaussian (P, 10) table; the backward writes
(cap, 10) gradients per sorted slot.
"""

from __future__ import annotations

import ctypes
import torch

from gaussian_splatting_torch import _kernels

ALPHA_MIN = 1.0 / 255.0
ALPHA_CAP = 0.99
T_EPS = 1e-4
POWER_EPS = 1e-4  # eligibility slack over the exact power <= 0 test

# Per-Gaussian field columns (the TPU version's record rows F_X..F_INVD)
F_X, F_Y, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_INVD = range(10)
NUM_FIELDS = 10

# Packed output columns: (num_tiles, PIX, OUT_COLS)
O_R, O_G, O_B, O_T, O_INVD, O_NB = range(6)
OUT_COLS = 8
NB_BIG = float(1 << 24)
CT_COLS = O_INVD + 1  # the five columns the render consumes
# Cotangent columns of the render core's output: the gradient of the loss
# with respect to R, G, B, the final T (the background's dot) and invdepth
CT_R, CT_G, CT_B, CT_BGDOT, CT_INVD = O_R, O_G, O_B, O_T, O_INVD


def blend_forward(
    sorted_owner: torch.Tensor,  # (cap,) int32 Gaussian at each sorted position
    tile_starts: torch.Tensor,  # (num_tiles,) int32
    tile_ends: torch.Tensor,  # (num_tiles,) int32
    fields: torch.Tensor,  # (P, NUM_FIELDS) f32
    *,
    grid_x: int,
    tile_w: int = 16,
    tile_h: int = 16,
) -> torch.Tensor:
    """Packed (num_tiles, tile_w*tile_h, OUT_COLS) blend records.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if fields.device.type == "cpu":
        return blend_forward_plain(
            sorted_owner, tile_starts, tile_ends, fields,
            grid_x=grid_x, tile_w=tile_w, tile_h=tile_h,
        )
    _kernels.check_cuda("blend_forward", sorted_owner, tile_starts, tile_ends, fields)
    if (tile_w, tile_h) != (16, 16):
        raise ValueError("blend_forward kernel: tiles must be 16x16")
    if sorted_owner.dtype != torch.int32 or tile_starts.dtype != torch.int32 or (
        tile_ends.dtype != torch.int32
    ):
        raise ValueError("blend_forward: indices must be int32")
    if fields.dtype != torch.float32 or fields.shape[1:] != (NUM_FIELDS,):
        raise ValueError("blend_forward: fields must be (P, 10) float32")
    _check_rows_aligned("blend_forward", fields)
    num_tiles = tile_starts.shape[0]
    out = torch.empty(
        (num_tiles, tile_w * tile_h, OUT_COLS), dtype=torch.float32,
        device=fields.device,
    )
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "blend_forward", "gs_blend_forward", [vp] * 4 + [ci] * 2 + [vp] * 2,
        sorted_owner.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        fields.data_ptr(), num_tiles, grid_x, out.data_ptr(),
        _kernels.current_stream(fields.device),
    )
    return out


def _check_rows_aligned(name: str, fields: torch.Tensor) -> None:
    """The kernels stage each 40-byte field row with 8-byte ``cp.async``
    copies, so the table must start on an 8-byte boundary."""
    if fields.data_ptr() % 8:
        raise ValueError(f"{name}: fields must start on an 8-byte boundary")


def blend_forward_plain(
    sorted_owner: torch.Tensor,
    tile_starts: torch.Tensor,
    tile_ends: torch.Tensor,
    fields: torch.Tensor,
    *,
    grid_x: int,
    tile_w: int = 16,
    tile_h: int = 16,
) -> torch.Tensor:
    """Plain PyTorch twin: step k handles the k-th instance of every tile at
    once, one operation per pass in the kernel's order (so on the card the
    two agree to the bit unless the compiler reorders a sum)."""
    dev = fields.device
    num_tiles = tile_starts.shape[0]
    pix = tile_w * tile_h
    tid = torch.arange(num_tiles, device=dev)
    lp = torch.arange(pix, device=dev)
    px = ((tid % grid_x) * tile_w)[:, None] + (lp % tile_w)[None, :]
    py = ((tid // grid_x) * tile_h)[:, None] + (lp // tile_w)[None, :]
    px = px.to(torch.float32)
    py = py.to(torch.float32)

    starts = tile_starts.long()
    counts = (tile_ends.long() - starts).clamp(min=0)
    steps = int(counts.max()) if num_tiles else 0

    T = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    C = torch.zeros((num_tiles, pix, 3), dtype=torch.float32, device=dev)
    D = torch.zeros_like(T)
    NB = torch.full_like(T, NB_BIG)
    done = torch.zeros((num_tiles, pix), dtype=torch.bool, device=dev)
    last = max(sorted_owner.shape[0] - 1, 0)
    for k in range(steps):
        # every 32 steps, stop once each tile is saturated or exhausted
        if k % 32 == 0 and k and bool(
            (done.all(dim=1) | (counts <= k)).all()
        ):
            break
        live = (counts > k)[:, None]
        pos = starts + k
        # tiles past their range read some in-bounds row; ``live`` masks it
        g = sorted_owner[pos.clamp(max=last)].long().clamp(max=fields.shape[0] - 1)
        f = fields[g]  # (tiles, 10)
        dx = f[:, F_X, None] - px
        dy = f[:, F_Y, None] - py
        power = -0.5 * (f[:, F_CA, None] * dx * dx + f[:, F_CC, None] * dy * dy) - (
            f[:, F_CB, None] * dx * dy
        )
        alpha = torch.clamp(f[:, F_OP, None] * torch.exp(power), max=ALPHA_CAP)
        eligible = live & ~done & (power <= POWER_EPS) & (alpha >= ALPHA_MIN)
        test_T = T * (1.0 - alpha)
        bad = eligible & (test_T < T_EPS)
        contrib = eligible & ~bad
        w = torch.where(contrib, alpha * T, 0.0)
        C = torch.where(contrib[..., None], C + w[..., None] * f[:, None, F_R : F_B + 1], C)
        D = torch.where(contrib, D + w * f[:, F_INVD, None], D)
        T = torch.where(contrib, test_T, T)
        NB = torch.where(bad, pos.to(torch.float32)[:, None], NB)
        done = done | bad

    zeros = torch.zeros_like(T)
    return torch.stack([C[..., 0], C[..., 1], C[..., 2], T, D, NB, zeros, zeros], dim=-1)


WARP = 32


def blend_backward(
    sorted_owner: torch.Tensor,  # (cap,) int32
    tile_starts: torch.Tensor,  # (num_tiles,) int32
    tile_ends: torch.Tensor,  # (num_tiles,) int32
    fields: torch.Tensor,  # (P, NUM_FIELDS) f32, the forward's
    packed: torch.Tensor,  # (num_tiles, PIX, OUT_COLS) f32 forward output
    ct: torch.Tensor,  # (num_tiles, PIX, CT_COLS) f32 cotangent
    *,
    grid_x: int,
    tile_w: int = 16,
    tile_h: int = 16,
) -> torch.Tensor:
    """(cap, NUM_FIELDS) field gradients per sorted slot.  Every slot of
    every tile range is written; slots at or past the valid stream length
    are not, so callers select by ``n_valid``.

    CPU tensors run the plain version; CUDA tensors launch the kernel."""
    if fields.device.type == "cpu":
        return blend_backward_plain(
            sorted_owner, tile_starts, tile_ends, fields, packed, ct,
            grid_x=grid_x, tile_w=tile_w, tile_h=tile_h,
        )
    _kernels.check_cuda("blend_backward", sorted_owner, tile_starts, tile_ends,
                        fields, packed, ct)
    if (tile_w, tile_h) != (16, 16):
        raise ValueError("blend_backward kernel: tiles must be 16x16")
    if sorted_owner.dtype != torch.int32 or tile_starts.dtype != torch.int32 or (
        tile_ends.dtype != torch.int32
    ):
        raise ValueError("blend_backward: indices must be int32")
    num_tiles = tile_starts.shape[0]
    pix = tile_w * tile_h
    if fields.dtype != torch.float32 or fields.shape[1:] != (NUM_FIELDS,) or (
        packed.shape != (num_tiles, pix, OUT_COLS) or ct.shape != (num_tiles, pix, CT_COLS)
    ) or packed.dtype != torch.float32 or ct.dtype != torch.float32:
        raise ValueError("blend_backward: fields, packed or cotangent has the wrong shape")
    _check_rows_aligned("blend_backward", fields)
    out = torch.empty((sorted_owner.shape[0], NUM_FIELDS), dtype=torch.float32,
                      device=fields.device)
    launch_blend_backward(sorted_owner, tile_starts, tile_ends, fields, packed, ct,
                          grid_x, out)
    return out


def launch_blend_backward(sorted_owner, tile_starts, tile_ends, fields, packed, ct,
                          grid_x, out):
    """Launch K5 into ``out``, a contiguous (cap, NUM_FIELDS) float32 CUDA
    buffer, on inputs that ``blend_backward`` has checked.  Slots at or past
    the valid stream length keep what ``out`` held (the card checks fill it
    with NaN to show that)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    _kernels.launch(
        "blend_backward", "gs_blend_backward", [vp] * 6 + [ci] * 2 + [vp] * 2,
        sorted_owner.data_ptr(), tile_starts.data_ptr(), tile_ends.data_ptr(),
        fields.data_ptr(), packed.data_ptr(), ct.data_ptr(), tile_starts.shape[0], grid_x,
        out.data_ptr(), _kernels.current_stream(fields.device),
    )


def _pixel_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (pixel) axis of (..., 256), pixel ``16 row + col``,
    in K5's order.  Warp w covers the 8x8 quarter (w % 2, w // 2) of the
    tile, and its lane l the column l % 8 of rows 2 (l // 8) and 2 (l // 8)
    + 1: each lane first adds its two pixels, top then bottom; a binary tree
    over the warp then adds lanes l and l + 16, then l + 8, ... l + 1 (the
    kernel's xor reduce-scatter forms the same sums,
    ``tests/test_torch_blend_order.py``); last, the 4 warp sums are added in
    warp order."""
    lead = x.shape[:-1]
    x = x.reshape(*lead, 2, 4, 2, 2, 8)  # row = 8 wy + 2 r + h, col = 8 wx + c
    x = x.select(-3, 0) + x.select(-3, 1)  # (..., wy, r, wx, c)
    x = x.transpose(-3, -2).reshape(*lead, 4, WARP)  # warp 2 wy + wx, lane 8 r + c
    half = WARP // 2
    while half:
        x = x[..., :half] + x[..., half : 2 * half]
        half //= 2
    x = x[..., 0]
    acc = x[..., 0]
    for w in range(1, x.shape[-1]):
        acc = acc + x[..., w]
    return acc


def blend_backward_plain(
    sorted_owner: torch.Tensor,
    tile_starts: torch.Tensor,
    tile_ends: torch.Tensor,
    fields: torch.Tensor,
    packed: torch.Tensor,
    ct: torch.Tensor,
    *,
    grid_x: int,
    tile_w: int = 16,
    tile_h: int = 16,
) -> torch.Tensor:
    """Plain PyTorch twin: step k replays the k-th instance of every tile
    at once, one operation per pass in the kernel's order, and sums over
    pixels in the kernel's order, so on the card the two agree to the bit
    unless the compiler reorders an operation.  Slots outside every tile
    range are zero."""
    dev = fields.device
    num_tiles = tile_starts.shape[0]
    pix = tile_w * tile_h
    tid = torch.arange(num_tiles, device=dev)
    lp = torch.arange(pix, device=dev)
    px = (((tid % grid_x) * tile_w)[:, None] + (lp % tile_w)[None, :]).to(torch.float32)
    py = (((tid // grid_x) * tile_h)[:, None] + (lp // tile_w)[None, :]).to(torch.float32)

    dR, dG, dB = ct[..., CT_R], ct[..., CT_G], ct[..., CT_B]
    dT, dD = ct[..., CT_BGDOT], ct[..., CT_INVD]
    Ctot = (packed[..., O_R] * dR + packed[..., O_G] * dG + packed[..., O_B] * dB
            + packed[..., O_INVD] * dD + packed[..., O_T] * dT)
    nb = packed[..., O_NB]

    starts = tile_starts.long()
    counts = (tile_ends.long() - starts).clamp(min=0)
    # past its last contributor (the largest NB) a tile's slots are zero
    needed = torch.minimum(counts, (nb.amax(dim=1) - starts.to(torch.float32)).clamp(min=0).long())
    steps = int(needed.max()) if num_tiles else 0

    out = torch.zeros((sorted_owner.shape[0], NUM_FIELDS), dtype=torch.float32, device=dev)
    T = torch.ones((num_tiles, pix), dtype=torch.float32, device=dev)
    Bq = torch.zeros_like(T)
    last = max(sorted_owner.shape[0] - 1, 0)
    for k in range(steps):
        live = counts > k
        pos = starts + k
        g = sorted_owner[pos.clamp(max=last)].long().clamp(max=fields.shape[0] - 1)
        f = fields[g]  # (tiles, 10)
        dx = f[:, F_X, None] - px
        dy = f[:, F_Y, None] - py
        power = -0.5 * (f[:, F_CA, None] * dx * dx + f[:, F_CC, None] * dy * dy) - (
            f[:, F_CB, None] * dx * dy
        )
        raw = f[:, F_OP, None] * torch.exp(power)
        alpha = torch.clamp(raw, max=ALPHA_CAP)
        contrib = (live[:, None] & (power <= POWER_EPS) & (alpha >= ALPHA_MIN)
                   & (pos.to(torch.float32)[:, None] < nb))
        q = f[:, F_R, None] * dR + f[:, F_G, None] * dG + f[:, F_B, None] * dB + (
            f[:, F_INVD, None] * dD
        )
        w = alpha * T
        wq = w * q
        Bq_new = Bq + wq
        gl = torch.where(
            contrib & (raw < ALPHA_CAP),
            wq - (alpha * (1.0 / (1.0 - alpha))) * (Ctot - Bq_new),
            0.0,
        )
        T = torch.where(contrib, T * (1.0 - alpha), T)
        Bq = torch.where(contrib, Bq_new, Bq)
        gx = gl * dx
        gy = gl * dy
        terms = torch.stack(
            [gl, gx, gy, gx * dx, gx * dy, gy * dy, w * dR, w * dG, w * dB, w * dD], dim=1
        )  # (tiles, 10, pix)
        S = _pixel_sum(torch.where(contrib[:, None, :], terms, 0.0))  # (tiles, 10)
        ca, cb, cc, op = f[:, F_CA], f[:, F_CB], f[:, F_CC], f[:, F_OP]
        grad = torch.stack([
            -(ca * S[:, 1] + cb * S[:, 2]),
            -(cc * S[:, 2] + cb * S[:, 1]),
            -0.5 * S[:, 3],
            -S[:, 4],
            -0.5 * S[:, 5],
            torch.where(op > 0.0, S[:, 0] * (1.0 / torch.clamp(op, min=1e-30)), 0.0),
            S[:, 6], S[:, 7], S[:, 8], S[:, 9],
        ], dim=1)
        out[pos[live]] = grad[live]
    return out
