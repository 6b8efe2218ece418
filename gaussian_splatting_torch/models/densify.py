"""Adaptive density control: clone / split / prune as masked tensor ops.

Counterpart of ``gaussian_splatting_tpu/models/densify.py``.  Everything
works on fixed-capacity tensors with an alive mask: *prune* clears
``alive``; *clone* copies candidate rows into free slots; *split* draws two
children from N(mean, Sigma) with the scales divided by 1.6, one of which
overwrites the parent slot and one of which takes a free slot.  Candidates
pair with free slots in JAX's stable order (candidates first, free slots
first); candidates that find no free slot are dropped and counted.  New
slots are reported in ``new_slot_mask`` so their Adam moments can be reset.
The functions return new tensors and leave their inputs as they are.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaussian_splatting_torch.ops.transforms import normalize_quat, quat_to_rotmat

Tensors = Dict[str, torch.Tensor]


class DensifyResult(NamedTuple):
    params: Tensors
    stats: Tensors  # alive + the zeroed densification statistics
    new_slot_mask: torch.Tensor  # (C,) bool: slots whose Adam moments must reset
    num_cloned: torch.Tensor
    num_split: torch.Tensor
    num_pruned: torch.Tensor
    dropped: torch.Tensor  # candidates that found no free slot


def _assign_free_slots(cand_mask: torch.Tensor, free_mask: torch.Tensor):
    """Pair the i-th candidate with the i-th free slot.  Returns (src, dst,
    valid, n_cand, n_free): for valid pairs, row ``src[i]`` goes to slot
    ``dst[i]``; ``dst`` is a permutation of the slots."""
    C = cand_mask.shape[0]
    order_src = torch.argsort((~cand_mask).to(torch.uint8), stable=True)  # candidates first
    order_dst = torch.argsort((~free_mask).to(torch.uint8), stable=True)  # free slots first
    n_cand = cand_mask.sum(dtype=torch.int32)
    n_free = free_mask.sum(dtype=torch.int32)
    i = torch.arange(C, dtype=torch.int32, device=cand_mask.device)
    valid = (i < n_cand) & (i < n_free)
    return order_src, order_dst, valid, n_cand, n_free


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _copy_rows(arr: torch.Tensor, src, dst, valid) -> torch.Tensor:
    out = arr.clone()
    out[dst] = torch.where(_rows(valid, arr), arr[src], arr[dst])
    return out


def densify_and_prune(
    params: Tensors,
    stats: Tensors,
    *,
    grad_threshold: float,
    min_opacity: float,
    extent: float,
    max_screen_size: int,
    percent_dense: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> DensifyResult:
    """One density-control step.  ``stats`` holds ``alive`` and the
    accumulated NDC-space positional gradient norms (``xyz_grad_accum`` /
    ``denom``) and ``max_radii2d``.  The split children's standard-normal
    (C, 3) draws come from ``generator``, or are given as ``noise`` =
    (child A's, child B's)."""
    params = dict(params)
    C = params["means3d"].shape[0]
    dev = params["means3d"].device
    alive = stats["alive"]
    denom = stats["denom"]
    grads = torch.where(denom > 0, stats["xyz_grad_accum"] / torch.clamp(denom, min=1.0), 0.0)
    scales = torch.exp(params["scales"])
    max_scale = scales.amax(dim=-1)
    high_grad = alive & (grads >= grad_threshold)

    # ---------------- clone (small Gaussians) ----------------
    clone_mask = high_grad & (max_scale <= percent_dense * extent)
    free = ~alive
    src, dst, valid, n_clone, _ = _assign_free_slots(clone_mask, free)
    params = {k: _copy_rows(v, src, dst, valid) for k, v in params.items()}
    alive = alive.clone()
    alive[dst] = torch.where(valid, True, alive[dst])
    new_slots = torch.zeros((C,), dtype=torch.bool, device=dev)
    new_slots[dst] = valid
    num_cloned = torch.minimum(n_clone, free.sum(dtype=torch.int32))
    dropped = torch.clamp(n_clone - num_cloned, min=0)

    # ---------------- split (large Gaussians) ----------------
    split_mask = high_grad & (max_scale > percent_dense * extent)
    if noise is None:
        noise = tuple(
            torch.randn((C, 3), generator=generator, dtype=torch.float32, device=dev)
            for _ in range(2)
        )
    R = quat_to_rotmat(normalize_quat(params["quats"]))

    def sample_child(eps):
        return params["means3d"] + (R * (eps * scales)[:, None, :]).sum(dim=-1)

    childA_mean = sample_child(noise[0])
    childB_mean = sample_child(noise[1])
    child_scales = torch.log(scales / (0.8 * 2.0))

    free = ~alive
    src_s, dst_s, valid_s, n_split, _ = _assign_free_slots(split_mask, free)
    # child B -> a free slot: the parent's row, then its own mean and scale
    params = {k: _copy_rows(v, src_s, dst_s, valid_s) for k, v in params.items()}
    sel = valid_s[:, None]
    params["means3d"][dst_s] = torch.where(sel, childB_mean[src_s], params["means3d"][dst_s])
    params["scales"][dst_s] = torch.where(sel, child_scales[src_s], params["scales"][dst_s])
    alive[dst_s] = torch.where(valid_s, True, alive[dst_s])
    new_slots[dst_s] = torch.where(valid_s, True, new_slots[dst_s])
    num_split = torch.minimum(n_split, free.sum(dtype=torch.int32))
    dropped = dropped + torch.clamp(n_split - num_split, min=0)

    # child A overwrites the parent in place, for parents whose child B
    # found a slot; a dropped split leaves the parent as it was
    placedB = torch.zeros((C,), dtype=torch.bool, device=dev)
    placedB[src_s] = valid_s
    splitA = split_mask & placedB
    params["means3d"] = torch.where(splitA[:, None], childA_mean, params["means3d"])
    params["scales"] = torch.where(splitA[:, None], child_scales, params["scales"])
    new_slots = new_slots | splitA

    # ---------------- prune ----------------
    prune_mask = torch.sigmoid(params["opacities"]) < min_opacity
    if max_screen_size:
        # new rows have no screen-radius history
        radii_hist = torch.where(new_slots, 0.0, stats["max_radii2d"])
        prune_mask = (
            prune_mask
            | (radii_hist > max_screen_size)
            | (torch.exp(params["scales"]).amax(dim=-1) > 0.1 * extent)
        )
    prune_mask = prune_mask & alive
    num_pruned = prune_mask.sum(dtype=torch.int32)
    alive = alive & ~prune_mask

    zeros = torch.zeros((C,), dtype=torch.float32, device=dev)
    return DensifyResult(
        params=params,
        stats=dict(alive=alive, max_radii2d=zeros, xyz_grad_accum=zeros.clone(),
                   denom=zeros.clone()),
        new_slot_mask=new_slots,
        num_cloned=num_cloned,
        num_split=num_split,
        num_pruned=num_pruned,
        dropped=dropped,
    )


def add_densification_stats(
    stats: Tensors, tap_grad: torch.Tensor, radii: torch.Tensor
) -> Tensors:
    """Accumulate the NDC-space positional gradient norm and the visible
    count, and raise ``max_radii2d``; returns the three new statistics."""
    visible = radii > 0
    norm = torch.linalg.vector_norm(tap_grad, dim=-1)
    return dict(
        xyz_grad_accum=stats["xyz_grad_accum"] + torch.where(visible, norm, 0.0),
        denom=stats["denom"] + visible.to(torch.float32),
        max_radii2d=torch.maximum(stats["max_radii2d"], radii.to(torch.float32) * visible),
    )


def reset_opacity(opacities: torch.Tensor) -> torch.Tensor:
    """Opacity logits with every opacity clamped to at most 0.01."""
    new_op = torch.minimum(torch.sigmoid(opacities), opacities.new_full((), 0.01))
    return torch.log(new_op / (1.0 - new_op))
