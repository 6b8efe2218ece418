"""Port parity: K7's plain twin (``ops/segscan.py``) against the JAX
package's Pallas ``segmented_cumsum`` in interpret mode, within 1e-4 as
``tests/test_segscan.py`` holds the Pallas kernel to a sequential reference;
exact +0.0 on zero segments; the leading segment before the first flag; and
the segment totals against K6's twin, bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.ops.segscan import segmented_cumsum as jax_segmented_cumsum
from gaussian_splatting_torch.ops.segreduce import segment_reduce_rows
from gaussian_splatting_torch.ops.segscan import segmented_cumsum


def _both(vals, flags):
    ours = segmented_cumsum(torch.from_numpy(vals), torch.from_numpy(flags)).numpy()
    theirs = np.asarray(jax_segmented_cumsum(jnp.asarray(vals), jnp.asarray(flags),
                                             interpret=True))
    return ours, theirs


@pytest.mark.parametrize("n", [257, 2048, 3000, 5000])
def test_twin_matches_jax(rng, n):
    vals = rng.normal(size=(16, n)).astype(np.float32)
    flags = (rng.uniform(size=n) < 0.1).astype(np.float32)
    flags[0] = 1.0
    if n == 3000:  # the second segment spans JAX's 2048-wide block boundary
        flags[:] = 0.0
        flags[[0, 500]] = 1.0
    ours, theirs = _both(vals, flags)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


def test_leading_segment_and_signed_zeros(rng):
    """Indices before the first flag continue from a carry of 0; zero
    segments (with -0.0 inputs too) scan to exact +0.0 in both packages."""
    n = 4096
    vals = rng.normal(size=(16, n)).astype(np.float32)
    vals[:, 1000:1100] = 0.0
    vals[:, 1000] = -0.0
    vals[:, 3000] = -0.0
    flags = np.zeros(n, np.float32)
    flags[[40, 1000, 1100, 2000, 3000, 3001, 3500]] = 1.0  # none at 0; 3000: one slot
    ours, theirs = _both(vals, flags)
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    np.testing.assert_allclose(ours[:, :40], np.cumsum(vals[:, :40], axis=1), atol=1e-5)
    for out in (ours, theirs):
        assert (out[:, 1000:1100].view(np.int32) == 0).all()  # +0.0, bit for bit
        assert (out[:, 3000].view(np.int32) == 0).all()


def test_segment_totals_equal_segment_reduce(rng):
    """At each non-empty segment's last slot the scan holds K6's sum."""
    lengths = rng.integers(0, 7, 800)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    n = int(offsets[-1])
    rows = rng.normal(size=(n, 10)).astype(np.float32)
    rows[offsets[100]:offsets[140]] = 0.0
    flags = np.zeros(n, np.float32)
    nonempty = lengths > 0
    flags[offsets[:-1][nonempty]] = 1.0
    scan = segmented_cumsum(torch.from_numpy(rows.T.copy()), torch.from_numpy(flags))
    seg = segment_reduce_rows(torch.from_numpy(rows), torch.from_numpy(offsets))
    ends = scan[:, torch.from_numpy(offsets[1:][nonempty] - 1).long()].t()
    assert torch.equal(ends.contiguous().view(torch.int32), seg[nonempty].view(torch.int32))
