"""The port's voxel hash grid (``ops/hashgrid.py``) and the hash-grid route
of ``ball_group``: against a brute-force numpy oracle (the cases of
``tests/test_hashgrid.py``) and bit-equal to the JAX package on the same
seeded clouds.

Everything here is exact: grids, counts, neighbour indices and validity.

Bucket overflow is mirrored, not fixed: a voxel holding more than
``bucket_capacity`` points gives only its first ``bucket_capacity`` sorted
points as candidates, so ``ball_count`` undercounts there, as the JAX
package's does (its docstring says "exact"). ``ball_group``'s K-subset
depends on this, and the port returns the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import grouping as jgr
from lidar_ai_recommendation_software_tpu.ops import hashgrid as jhg
from lidar_ai_recommendation_software_tpu_torch.ops import grouping as tgr
from lidar_ai_recommendation_software_tpu_torch.ops import hashgrid as thg


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_cloud(n, cap, d=3, seed=0, scale=5.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-scale, scale, (n, d)).astype(np.float32)
    buf = np.zeros((cap, d), np.float32)
    buf[:n] = pts
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pts, buf, mask


def _brute_counts(pts, radius):
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return (d2 <= radius * radius).sum(1)


@pytest.mark.parametrize("n,cap,radius", [(500, 512, 0.8), (1000, 1024, 0.3),
                                          (77, 128, 2.0)])
def test_ball_count_matches_bruteforce(n, cap, radius):
    pts, buf, mask = _random_cloud(n, cap)
    grid = thg.build_grid(_t(buf), _t(mask), radius)
    counts = thg.ball_count(grid, _t(buf), _t(mask), radius,
                            bucket_capacity=64)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts[:n].numpy(),
                                  _brute_counts(pts, radius))
    np.testing.assert_array_equal(counts[n:].numpy(), 0)


def test_ball_query_returns_exact_neighbor_sets():
    n, cap, radius = 400, 512, 1.0
    pts, buf, mask = _random_cloud(n, cap, seed=3)
    grid = thg.build_grid(_t(buf), _t(mask), radius)
    idx, ok = thg.ball_query(grid, _t(buf), _t(mask), radius, k=64,
                             bucket_capacity=64)
    assert idx.dtype == torch.int32 and ok.dtype == torch.bool
    idx, ok = idx.numpy(), ok.numpy()
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    for i in range(0, n, 17):
        assert set(idx[i][ok[i]]) == set(np.where(d2[i] <= radius ** 2)[0])


def test_ball_query_2d():
    n, cap, radius = 300, 512, 1.5
    pts, buf, mask = _random_cloud(n, cap, d=2, seed=7, scale=10.0)
    grid = thg.build_grid(_t(buf), _t(mask), radius)
    counts = thg.ball_count(grid, _t(buf), _t(mask), radius,
                            bucket_capacity=64)
    np.testing.assert_array_equal(counts[:n].numpy(),
                                  _brute_counts(pts, radius))


def test_masked_points_excluded():
    pts, buf, mask = _random_cloud(100, 256, seed=5)
    mask[50:] = False
    grid = thg.build_grid(_t(buf), _t(mask), 1.0)
    counts = thg.ball_count(grid, _t(buf), _t(mask), 1.0).numpy()
    np.testing.assert_array_equal(counts[:50], _brute_counts(pts[:50], 1.0))
    np.testing.assert_array_equal(counts[50:], 0)


def _overflowing_cloud():
    """A venue slab with a pile of 120 points in a 5 cm cube, more than a
    32-slot bucket holds, and a few masked points."""
    rng = np.random.RandomState(11)
    pts = rng.uniform(-6, 6, (900, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    pts[:120] = rng.uniform(0.2, 0.25, (120, 3)).astype(np.float32)
    mask = rng.rand(900) > 0.05
    mask[:120] = True
    return pts, mask


CLOUDS = {
    "uniform_3d": lambda: (_random_cloud(700, 768, seed=1)[1:]),
    "uniform_2d": lambda: (_random_cloud(500, 512, d=2, seed=2)[1:]),
    "masked_tail": lambda: (_random_cloud(300, 512, seed=4)[1:]),
    "bucket_overflow": _overflowing_cloud,
}


@pytest.mark.parametrize("name", sorted(CLOUDS))
@pytest.mark.parametrize("radius,bucket_capacity", [(0.5, 32), (1.2, 64)])
def test_grid_count_and_query_bit_equal_to_jax(name, radius,
                                               bucket_capacity):
    pts, mask = CLOUDS[name]()
    jgrid = jhg.build_grid(jnp.asarray(pts), jnp.asarray(mask), radius)
    tgrid = thg.build_grid(_t(pts), _t(mask), radius)
    for field in ("points", "mask", "cell_size", "origin", "dims", "order",
                  "sorted_ids", "sorted_points"):
        want = np.asarray(getattr(jgrid, field))
        got = getattr(tgrid, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    q, qm = pts[::3], mask[::3]
    jc = jhg.ball_count(jgrid, jnp.asarray(q), jnp.asarray(qm), radius,
                        bucket_capacity=bucket_capacity, chunk=64)
    tc = thg.ball_count(tgrid, _t(q), _t(qm), radius,
                        bucket_capacity=bucket_capacity, chunk=64)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for k in (8, 40):
        ji, jv = jhg.ball_query(jgrid, jnp.asarray(q), jnp.asarray(qm),
                                radius, k, bucket_capacity=bucket_capacity,
                                chunk=100)
        ti, tv = thg.ball_query(tgrid, _t(q), _t(qm), radius, k,
                                bucket_capacity=bucket_capacity, chunk=100)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if name == "bucket_overflow" and bucket_capacity == 32:
        # the mirrored defect: the pile's voxel yields 32 candidates, so
        # the pile's points count fewer neighbours than there are
        d2 = ((q[:, None] - pts[None]) ** 2).sum(-1)
        true = ((d2 <= np.float32(radius) ** 2) & mask[None]).sum(1)
        assert (true[:40] >= 120).all() and (tc.numpy()[:40] < 120).all()


def test_ball_group_hashgrid_bit_equal_to_jax():
    """``tests/test_grouping.py::test_ball_group_hashgrid_backend_matches_dense``
    on the port: the hash-grid route gives the JAX package's indices and
    validity bit for bit, the dense route's neighbour set wherever a
    neighbourhood fits in K, and the same neighbour count everywhere."""
    rng = np.random.RandomState(7)
    pts = rng.uniform(-20, 20, (20000, 3)).astype(np.float32)
    pts[:, 2] *= 0.05
    q = pts[rng.choice(20000, 256, replace=False)]
    qm, pm = np.ones(256, bool), np.ones(20000, bool)
    k, r = 24, 0.8
    ji, jv = jgr.ball_group(jnp.asarray(q), jnp.asarray(qm),
                            jnp.asarray(pts), jnp.asarray(pm), r, k,
                            method="hashgrid")
    i_h, v_h = tgr.ball_group(_t(q), _t(qm), _t(pts), _t(pm), r, k,
                              method="hashgrid")
    np.testing.assert_array_equal(i_h.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v_h.numpy(), np.asarray(jv))
    i_d, v_d = tgr.ball_group(_t(q), _t(qm), _t(pts), _t(pm), r, k,
                              method="dense")
    i_d, v_d, i_h, v_h = (x.numpy() for x in (i_d, v_d, i_h, v_h))
    np.testing.assert_array_equal(v_d.sum(1), v_h.sum(1))
    for i in range(256):
        if v_d[i].sum() < k:
            assert set(i_d[i][v_d[i]]) == set(i_h[i][v_h[i]])
        else:
            d2 = ((q[i] - pts[i_h[i][v_h[i]]]) ** 2).sum(-1)
            assert (d2 <= r * r + 1e-5).all()
        # padding repeats the first neighbour
        assert (i_h[i][~v_h[i]] == i_h[i][0]).all()
