"""Differentiable collectives over ``torch.distributed`` (the port's
counterparts of the ``shard_map`` collectives the JAX package's parallel
steps use: ``psum``, ``pmax``, ``all_to_all``, ``ppermute`` and the
all-gather of ``out_specs``).

Conventions, which the parallel steps rely on:

- ``all_reduce_sum``'s backward all-reduces the cotangent, the transpose
  JAX's ``shard_map(check_vma=False)`` gives ``psum``.  A loss computed the
  same way on every rank therefore sends every rank n times its gradient
  through it, and ``gshard`` divides that factor back out.
- ``all_to_all`` and ``halo_exchange`` are permutations of rows between
  ranks; their backwards send each cotangent row back where its row came
  from.
- ``all_gather`` serves a consumer that runs the same computation on every
  rank: its backward keeps this rank's slice of the cotangent.

Built on the plain ``torch.distributed`` calls (``torch.distributed.nn``'s
functional collectives are deprecated).  Every rank must call each
function in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gaussian_splatting_torch.parallel.mesh import rank, world_size


def _sum(x: torch.Tensor) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _sum(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks (``psum``); the backward all-reduces the cotangent."""
    return _AllReduceSum.apply(x)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Maximum over ranks (``pmax``), not differentiable.  Booleans travel
    as int32 and come back as booleans."""
    y = x.detach().to(torch.int32 if x.dtype == torch.bool else x.dtype).contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y.to(x.dtype)


def _exchange(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _exchange(x)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """(n, ...) -> (n, ...): row s of the result is the row this rank's
    index that rank s sent (``all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``).  The backward is the reverse exchange."""
    if x.shape[0] != world_size():
        raise ValueError(f"all_to_all: leading axis {x.shape[0]} != world size {world_size()}")
    return _AllToAll.apply(x)


def _swap_rows(up_send, down_send):
    """Send ``up_send`` to rank - 1 and ``down_send`` to rank + 1; return
    what rank - 1 and rank + 1 sent (zeros at the mesh ends)."""
    r, n = rank(), world_size()
    from_up = torch.zeros_like(down_send)
    from_down = torch.zeros_like(up_send)
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, up_send.contiguous(), r - 1),
                dist.P2POp(dist.irecv, from_up, r - 1)]
    if r + 1 < n:
        ops += [dist.P2POp(dist.isend, down_send.contiguous(), r + 1),
                dist.P2POp(dist.irecv, from_down, r + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_up, from_down


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        from_up, from_down = _swap_rows(x[:, :rows], x[:, -rows:])
        return torch.cat([from_up, x, from_down], dim=1)

    @staticmethod
    def backward(ctx, g):
        rows = ctx.rows
        core = g[:, rows:-rows].clone()
        # the cotangent of the rows taken from rank - 1 goes back to its
        # bottom rows, that of the rows taken from rank + 1 to its top rows
        back_up, back_down = _swap_rows(g[:, :rows], g[:, -rows:])
        core[:, :rows] += back_up
        core[:, -rows:] += back_down
        return core, None


def halo_exchange(x: torch.Tensor, rows: int) -> torch.Tensor:
    """(C, S, W) stripe -> (C, S + 2 rows, W): the last ``rows`` rows of rank
    - 1 above, the first ``rows`` rows of rank + 1 below, zeros at the mesh
    ends (two ``ppermute`` shifts)."""
    if x.shape[1] < rows:
        raise ValueError(f"halo_exchange: a stripe of {x.shape[1]} rows has no {rows}-row halo")
    return _Halo.apply(x, rows)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # booleans travel as uint8 (gloo has no bool gather)
        y = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(y) for _ in range(world_size())]
        dist.all_gather(parts, y)
        return torch.stack(parts).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[rank()]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """x -> (n, *x.shape), rank-major, of any dtype.  The backward keeps this rank's slice:
    the consumer runs the same computation on every rank, so every rank
    holds the same cotangent."""
    return _AllGather.apply(x)
