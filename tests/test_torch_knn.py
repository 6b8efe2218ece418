"""Port parity: ``ops/knn.py`` (Morton codes, the Morton-window 3-NN and the
exact 3-NN) against the JAX package's on seeded clouds.  Morton codes match
bitwise (the port does JAX's uint32 arithmetic in int64 with masks), the
distances within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops import knn as jknn
from gaussian_splatting_torch.ops import knn as tknn


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * rng.uniform(0.2, 3.0, 3)
    pts[: n // 10] = pts[n // 10 : 2 * (n // 10)]  # coincident points: zero distances
    return pts.astype(np.float32)


@pytest.mark.parametrize("n", [2000, 25000])
def test_morton_codes_bitwise(n):
    pts = _cloud(n, 1)
    ours = tknn.morton_codes(torch.from_numpy(pts)).numpy()
    theirs = np.asarray(jknn.morton_codes(jnp.asarray(pts))).astype(np.int64)
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n", [2000, 25000])
def test_window_knn_matches_jax(n):
    pts = _cloud(n, 2)
    ours = tknn.knn_mean_sq_dist(torch.from_numpy(pts)).numpy()
    theirs = np.asarray(jknn.knn_mean_sq_dist(jnp.asarray(pts)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)


def test_exact_knn_matches_jax():
    pts = _cloud(2000, 3)
    ours = tknn.knn_mean_sq_dist_exact(torch.from_numpy(pts)).numpy()
    theirs = np.asarray(jknn.knn_mean_sq_dist_exact(jnp.asarray(pts)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=0)
    assert (ours >= 0).all()
