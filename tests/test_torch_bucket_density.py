"""The port's bucketed radius count (``ops/bucket_density.py``, plain
PyTorch) against the JAX package's, on the CPU, over the cases of
tests/test_bucket_density.py: fractional radius to grid ratios, odd grid
capacities, no live people, people exactly at the radius, and a bucket
past its cap. Counts and overflow are integers and must be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import bucket_density as jbd
from lidar_ai_recommendation_software_tpu_torch.ops import (
    bucket_density as tbd)


def _both(pos, live, origin, gx, gy, gs, r, cap):
    mask = np.arange(len(pos)) < live
    want, wov = jbd.radius_count_bucketed(
        jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(origin), gx, gy,
        gs, r, bucket_cap=cap)
    got, gov = tbd.radius_count_bucketed(
        torch.from_numpy(pos), torch.from_numpy(mask),
        torch.from_numpy(origin), gx, gy, gs, r, bucket_cap=cap)
    assert got.dtype == torch.int32 and got.shape == (gx, gy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gov) == int(wov)
    return got.numpy(), int(gov)


@pytest.mark.parametrize("seed,k,live,gx,gy,gs,r", [
    (0, 256, 200, 64, 48, 1.0, 2.0),
    (1, 512, 512, 96, 96, 0.5, 2.0),   # fractional radius/grid ratio
    (2, 128, 90, 33, 65, 1.0, 3.3),    # non-integer s, odd grid caps
    (3, 64, 0, 16, 16, 1.0, 2.0),      # no live people
])
def test_bucketed_matches_jax(seed, k, live, gx, gy, gs, r):
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(0, 1, (k, 2)) * (gx * gs, gy * gs)).astype(
        np.float32)
    origin = np.float32([-0.75, 0.25])
    counts, ov = _both(pos, live, origin, gx, gy, gs, r, cap=96)
    assert ov == 0
    assert (counts.sum() > 0) == (live > 0)


def test_bucketed_exact_radius_matches_jax():
    """People at float32 distance exactly r from cell centre (4.5, 4.5)
    count (<=); the one 1e-3 beyond does not."""
    c = np.float32([4.5, 4.5])
    pos = np.stack([c + [2.0, 0.0], c + [0.0, -2.0], c + [2.001, 0.0],
                    c]).astype(np.float32)
    counts, ov = _both(pos, 4, np.zeros(2, np.float32), 16, 16, 1.0, 2.0,
                       cap=8)
    assert ov == 0 and counts[4, 4] == 3


@pytest.mark.parametrize("cap", [4, 64])
def test_bucketed_overflow_matches_jax(cap):
    """64 people in a few buckets: at cap 4 the dropped people are counted
    (and the same ones dropped, so the counts agree too); at 64 none."""
    pos = np.random.RandomState(7).uniform(0, 4, (64, 2)).astype(
        np.float32)
    _, ov = _both(pos, 64, np.zeros(2, np.float32), 32, 32, 1.0, 2.0, cap)
    assert (ov > 0) == (cap == 4)
