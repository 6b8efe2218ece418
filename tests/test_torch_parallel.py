"""Port parity: the collectives and the Gaussian/tile-sharded render on
gloo worlds of 2 and 4 CPU ranks (each spawned once per module), and the
exchange records against the JAX package's on its virtual CPU mesh.

- Each collective's value and gradient against one process's computation
  of the same function of every rank's input.
- ``pack_records`` and ``route_records`` exactly equal to JAX's
  ``_pack_records`` and ``_exchange_records`` under ``shard_map``, given the
  same projection.
- ``render_gaussian_sharded`` against the port's single render at 48x32:
  image within 3e-5, the means' gradient within 1e-4 (JAX
  ``tests/test_parallel.py``'s tolerances); the exchange overflow flagged at
  ``exchange_capacity=8`` and gone at the default (JAX's test at line 67).
"""

import jax
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from gaussian_splatting_tpu.ops.preprocess import preprocess as jax_preprocess
from gaussian_splatting_tpu.parallel import gshard as jgshard
from gaussian_splatting_tpu.parallel.mesh import make_mesh
from gaussian_splatting_tpu.utils.testing import random_scene as jax_random_scene
from gaussian_splatting_torch.config import RasterizeConfig
from gaussian_splatting_torch.ops.preprocess import ProjectedGaussians
from gaussian_splatting_torch.ops.rasterize import render
from gaussian_splatting_torch.parallel import gshard
from gaussian_splatting_torch.utils.testing import (
    SHARD_RENDER,
    World,
    collective_inputs,
    collectives_worker,
    shard_render_scene,
    shard_render_worker,
)

WORLDS = (2, 4)


@pytest.fixture(scope="module", params=WORLDS)
def world(request):
    """(n, each rank's [collectives, sharded render] results)."""
    n = request.param
    return n, World(n, (collectives_worker,), (shard_render_worker,), timeout_s=90.0).results()


def _reference_collectives(n):
    ins = [collective_inputs(r, n) for r in range(n)]
    x = np.stack([i["x"] for i in ins])  # (rank, n, 3)
    w = np.stack([i["w"] for i in ins])
    ref = {}
    for r in range(n):
        ref[r] = {
            "sum": x.sum(axis=0), "sum_grad": w.sum(axis=0),
            # row s of rank r's result is row r of rank s's input; the
            # gradient's row d is the weight rank d put on what r sent it
            "a2a": x[:, r], "a2a_grad": w[:, r],
            "gather": x[:, 0], "gather_grad": ins[r]["shared"][r],
            "max": np.array([n - 1, 0], np.int32), "any": np.array(True),
        }
    # the halo in one process: stripes stacked, zero-padded by 2 rows, each
    # rank's window of 7 + 4 rows weighted by its own weights
    stripes = torch.from_numpy(np.concatenate([i["stripe"] for i in ins], axis=1))
    stripes.requires_grad_(True)
    padded = torch.nn.functional.pad(stripes, (0, 0, 2, 2))
    windows = [padded[:, 7 * r: 7 * r + 11] for r in range(n)]
    loss = sum((win * torch.from_numpy(ins[r]["halo_w"])).sum() for r, win in enumerate(windows))
    (g,) = torch.autograd.grad(loss, stripes)
    for r in range(n):
        ref[r]["halo"] = windows[r].detach().numpy()
        ref[r]["halo_grad"] = g[:, 7 * r: 7 * r + 7].numpy()
    return ref


@pytest.mark.parametrize("name", ["sum", "a2a", "halo", "gather", "max"])
def test_collective_values_and_gradients(world, name):
    n, results = world
    ref = _reference_collectives(n)
    keys = ("max", "any") if name == "max" else (name, name + "_grad")
    for r in range(n):
        for key in keys:
            np.testing.assert_allclose(results[r][0][key], ref[r][key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{key} on rank {r} of {n}")


def test_all_reduce_sum_gradient_is_n_fold(world):
    """The transpose JAX's shard_map gives psum: with the same weights on
    every rank, each rank's gradient is n times the weight."""
    n, results = world
    w_sum = sum(collective_inputs(r, n)["w"] for r in range(n))
    for r in range(n):
        np.testing.assert_allclose(results[r][0]["sum_grad"], w_sum, rtol=1e-6)


def _to_port_proj(jp, lo, hi) -> ProjectedGaussians:
    return ProjectedGaussians(**{
        f: torch.from_numpy(np.array(getattr(jp, f))[lo:hi].astype(
            np.int32 if f in ("span_x0", "span_cum") else np.array(getattr(jp, f)).dtype))
        for f in ProjectedGaussians._fields})


@pytest.fixture(scope="module")
def jax_projection():
    js = jax_random_scene(SHARD_RENDER["num_gaussians"], sh_degree=1,
                          width=SHARD_RENDER["width"], height=SHARD_RENDER["height"], seed=9)
    jp = jax.jit(lambda *a: jax_preprocess(*a, js.cam, sh_degree=1))(
        js.means3d, js.scales, js.quats, js.opacities, js.sh)
    return js, jp


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cap_x", [0, 8])
def test_pack_and_route_match_jax(jax_projection, n, cap_x):
    js, jp = jax_projection
    total = js.means3d.shape[0]
    cfg = RasterizeConfig()
    cap_x, _ = gshard._capacities(total, n, cfg, cap_x)
    _, _, _, gyl = gshard._geometry(js.cam, cfg, n)

    def body(proj):
        rec = jgshard._pack_records(proj)
        flat, ovf = jgshard._exchange_records(rec, proj, n=n, grid_y_local=gyl, cap_x=cap_x)
        return rec, flat, ovf[None]

    rec_j, flat_j, ovf_j = (np.asarray(a) for a in jax.jit(shard_map(
        body, mesh=make_mesh(n), in_specs=(P("data"),), out_specs=(P("data"),) * 3,
        check_vma=False))(jp))
    k = total // n
    sends, flags = [], []
    for s in range(n):
        proj = _to_port_proj(jp, s * k, (s + 1) * k)
        rec = gshard.pack_records(proj)
        np.testing.assert_array_equal(rec.numpy(), rec_j[s * k: (s + 1) * k])
        send, ovf = gshard.route_records(rec, proj, n=n, grid_y_local=gyl, cap_x=cap_x)
        assert send.shape == (n, cap_x, gshard.REC_COLS)
        sends.append(send.numpy())
        flags.append(bool(ovf))
    np.testing.assert_array_equal(flags, ovf_j)
    assert any(flags) == (cap_x == 8)
    # what all_to_all delivers to stripe d: the sends addressed to d, rank-major
    m = n * cap_x
    for d in range(n):
        recv = np.concatenate([sends[s][d] for s in range(n)])
        np.testing.assert_array_equal(recv, flat_j[d * m: (d + 1) * m], err_msg=f"stripe {d}")


def _single(scene, grad=False):
    means = scene.means3d.clone().requires_grad_(grad)
    out = render(means, scene.scales, scene.quats, scene.opacities, scene.sh, scene.cam,
                 scene.bg, sh_degree=1)
    assert not bool(out.overflow)
    return out.image, means


def test_sharded_render_matches_single(world):
    n, results = world
    image, _ = _single(shard_render_scene())
    for r in range(n):
        got = results[r][1]
        assert not bool(got["overflow"])
        np.testing.assert_allclose(got["image"], image.detach().numpy(), atol=3e-5, rtol=0,
                                   err_msg=f"rank {r} of {n}")
    assert float(image.max()) > 0.1


def test_sharded_render_gradient_matches_single(world):
    n, results = world
    image, means = _single(shard_render_scene(), grad=True)
    (g,) = torch.autograd.grad(((image - 0.25) ** 2).sum(), means)
    got = np.concatenate([results[r][1]["grad"] for r in range(n)])
    np.testing.assert_allclose(got, g.numpy(), atol=1e-4, rtol=0)
    assert np.abs(got).max() > 1.0


def test_exchange_overflow_flagged_and_cured(world):
    n, results = world
    image, _ = _single(shard_render_scene(heavy=True))
    for r in range(n):
        got = results[r][1]
        assert bool(got["tiny_overflow"]), "exchange_capacity=8 must overflow"
        assert not bool(got["heavy_overflow"])
        np.testing.assert_allclose(got["heavy_image"], image.numpy(), atol=3e-5, rtol=0)
