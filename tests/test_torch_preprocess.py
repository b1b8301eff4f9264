"""The PyTorch port's preprocessing and all-pairs clustering against the
JAX package's, on the CPU.

Tolerances: percentiles, masks, labels and cluster counts are exact (the
same float32 arithmetic in the same order); the ground plane is within
1e-4 (its normal equations sum in another order); colours within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN

from lidar_ai_recommendation_software_tpu import preprocess as jpre
from lidar_ai_recommendation_software_tpu.config import (
    MODULAR_CONFIG, MONOLITH_CONFIG)
from lidar_ai_recommendation_software_tpu.ops import clustering as jcl
from lidar_ai_recommendation_software_tpu.pipeline import Pipeline as JaxPipe
from lidar_ai_recommendation_software_tpu.types import PointCloud as JCloud
from lidar_ai_recommendation_software_tpu_torch import preprocess as tpre
from lidar_ai_recommendation_software_tpu_torch.ops import clustering as tcl
from lidar_ai_recommendation_software_tpu_torch.types import (
    PointCloud as TCloud)
from port_helpers import port_cfg

CONFIGS = {"monolith": MONOLITH_CONFIG, "modular": MODULAR_CONFIG}


@pytest.mark.parametrize("seed,n,valid,q", [
    (0, 1000, 1000, 30.0), (1, 4096, 3000, 30.0), (2, 777, 5, 50.0),
    (3, 64, 1, 30.0), (4, 2048, 2048, 0.0), (5, 2048, 1999, 100.0),
])
def test_masked_percentile_exact(seed, n, valid, q):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 3, n).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[rng.permutation(n)[:valid]] = True
    want = np.asarray(jpre.masked_percentile(jnp.asarray(x),
                                             jnp.asarray(mask), q))
    got = tpre.masked_percentile(torch.from_numpy(x), torch.from_numpy(mask),
                                 q).numpy()
    assert got == want


@pytest.fixture(scope="module")
def fixture_preprocessed(fixture_points):
    """Both packages' preprocess of the seed-42 fixture, per config."""
    out = {}
    for name, config in CONFIGS.items():
        cfg = JaxPipe(config).fit_capacity(fixture_points)
        jc = JCloud.from_numpy(fixture_points, cfg.capacity.max_points)
        want = jax.jit(jpre.preprocess, static_argnames="config")(jc, cfg)
        tc = TCloud.from_numpy(fixture_points, cfg.capacity.max_points)
        out[name] = (want, tpre.preprocess(tc, port_cfg(cfg)))
    return out


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_preprocess_matches_jax(fixture_preprocessed, variant):
    want, got = fixture_preprocessed[variant]
    for field in ("mask", "ground_mask", "labels", "n_clusters",
                  "cluster_overflow", "mins", "maxs", "normals"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.ground_plane.numpy(),
                               np.asarray(want.ground_plane), atol=1e-4)
    np.testing.assert_allclose(got.colors.numpy(), np.asarray(want.colors),
                               atol=1e-6)
    assert got.dimensions == pytest.approx(want.dimensions)
    if variant == "monolith":
        assert int(got.n_clusters) == 446


def _buffer(pts, cap):
    buf = np.zeros((cap, pts.shape[1]), np.float32)
    buf[:len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[:len(pts)] = True
    return buf, mask


def _both_labels(pts, eps, min_samples, cap):
    buf, mask = _buffer(pts, cap)
    jl, jn, _ = jcl.dbscan_labels(jnp.asarray(buf), jnp.asarray(mask), eps,
                                  min_samples)
    tl, tn, tov = tcl.dbscan_labels(torch.from_numpy(buf),
                                    torch.from_numpy(mask), eps, min_samples)
    assert int(tov) == 0
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tn) == int(jn)
    return tl.numpy()[:len(pts)], int(tn)


def test_dbscan_fixture_labels_bit_equal(oracle_monolith):
    pro = oracle_monolith["processed"]
    ng = pro["points"][~pro["ground_mask"]].astype(np.float32)
    labels, ncl = _both_labels(ng, 0.3, 5, cap=8192)
    sk = DBSCAN(eps=0.3, min_samples=5).fit(ng).labels_
    assert ncl == sk.max() + 1 == 446
    assert (labels == -1).sum() == (sk == -1).sum() == 2544


@pytest.mark.parametrize("seed,n,eps,ms", [(0, 800, 0.4, 5), (1, 500, 0.6, 4),
                                           (2, 1200, 0.3, 3)])
def test_dbscan_random_labels_bit_equal(seed, n, eps, ms):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-8, 8, (12, 3))
    cluster_pts = (centers[rng.randint(0, 12, n // 2)]
                   + rng.normal(0, 0.15, (n // 2, 3)))
    noise = rng.uniform(-10, 10, (n - n // 2, 3))
    pts = np.vstack([cluster_pts, noise]).astype(np.float32)
    _, ncl = _both_labels(pts, eps, ms, cap=1 << (n - 1).bit_length())
    assert ncl == DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_.max() + 1


def test_dbscan_max_iters_cap_matches_jax():
    """A chain longer than the sweeps allowed stops at the same
    unconverged labels in both packages."""
    pts = np.zeros((600, 3), np.float32)
    pts[:, 0] = np.random.RandomState(0).permutation(600) * 0.25
    buf, mask = _buffer(pts, 1024)
    jl, jn, _ = jcl.dbscan_bruteforce(jnp.asarray(buf), jnp.asarray(mask),
                                      0.3, 2, max_iters=2)
    tl, tn, _ = tcl.dbscan_bruteforce(torch.from_numpy(buf),
                                      torch.from_numpy(mask), 0.3, 2,
                                      max_iters=2)
    assert int(jn) > 1  # unconverged: one chain, several labels
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_buffer_above_bruteforce_cap_raises():
    """A buffer above the all-pairs cap takes the column-grid backend,
    which refuses a table past the int32 slot index (1,282 x 1,282
    columns x 2,048 slots) before allocating it."""
    n = tcl.BRUTEFORCE_MAX_POINTS + 32
    pts = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="int32 slot index"):
        tcl.dbscan_labels(pts, torch.ones(n, dtype=torch.bool), 0.3, 5,
                          ncx=1280, ncy=1280, column_cap=2048)
