"""The port's Pipeline.analyze at venue scale, on the CPU, against the JAX
package's Pipeline: a 50,000-point venue (clustering buffer 57,344 points,
so the column-grid clustering), the column-cap retry, and the bucketed
density with its overflow retry.

Tolerances, as tests/test_torch_pipeline.py: labels, people counts,
density grids, hotspots, bottleneck cells and severities exact; average
density exact; flow vectors, magnitudes and speeds within 1e-5 (sin/cos
ulps); centroids within 1e-5 m (float64 prefix sums against float32
scatter sums).
"""

import numpy as np
import pytest

from lidar_ai_recommendation_software_tpu.config import MONOLITH_CONFIG
from lidar_ai_recommendation_software_tpu.models import density as JD
from lidar_ai_recommendation_software_tpu.pipeline import Pipeline as JaxPipe
from lidar_ai_recommendation_software_tpu.synthetic import (
    sample_venue, scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.models import density as TD
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.types import PointCloud
from port_helpers import port_cfg

TOL = 1e-5


def _assert_same(got, want, people=None):
    gd, wd = got["density"], want["density"]
    for key in ("total_people", "avg_density", "max_density", "origin",
                "hotspots"):
        assert gd[key] == wd[key], key
    np.testing.assert_array_equal(gd["density_grid"], wd["density_grid"])
    gp, wp = got["processed"], want["processed"]
    np.testing.assert_array_equal(gp.labels.numpy(), np.asarray(wp.labels))
    assert int(gp.n_clusters) == int(wp.n_clusters)
    assert int(gp.cluster_overflow) == int(wp.cluster_overflow) == 0
    np.testing.assert_array_equal(got["people"].mask.numpy(),
                                  np.asarray(want["people"].mask))
    np.testing.assert_allclose(got["people"].positions.numpy(),
                               np.asarray(want["people"].positions),
                               atol=TOL)
    gf, wf = got["flow"], want["flow"]
    assert gf["dominant_direction"] == wf["dominant_direction"]
    assert gf["bottlenecks"] == wf["bottlenecks"]
    assert abs(gf["avg_speed"] - wf["avg_speed"]) < TOL
    for key in ("positions", "vectors", "magnitudes"):
        np.testing.assert_allclose(gf["flow_vectors"][key],
                                   wf["flow_vectors"][key], atol=TOL)
    assert got["recommendations"] == want["recommendations"]
    if people is not None:
        assert gd["total_people"] == people


@pytest.fixture(scope="module")
def venue():
    return scaled_venue(50_000)


def test_venue_50k_matches_jax(venue):
    jpipe, tpipe = JaxPipe(), Pipeline(device="cpu")
    cfg = jpipe.fit_capacity(venue)
    assert port_cfg(cfg) == tpipe.fit_capacity(venue)
    assert cfg.capacity.cluster_capacity == 57_344
    assert (cfg.capacity.cluster_cells_x, cfg.capacity.cluster_column_cap
            ) == (256, 16)
    _assert_same(tpipe.analyze(venue), jpipe.analyze(venue), people=2236)


class _SmallColumns:
    """fit_capacity with a column cap of 4, which the venue overflows."""

    def fit_capacity(self, points):
        return super().fit_capacity(points).with_capacity(
            cluster_column_cap=4)


class _JaxSmallColumns(_SmallColumns, JaxPipe):
    pass


class _PortSmallColumns(_SmallColumns, Pipeline):
    pass


def test_column_cap_retry_matches_jax(venue):
    """Starting from a column cap the venue overflows, both packages
    double the cap and the buffer until nothing is dropped, and land on
    the same result as a run sized right from the start."""
    pts = venue[:45_000]
    pipe = _PortSmallColumns(device="cpu")
    cfg = pipe.fit_capacity(pts)
    first, _, _ = pipe.analyze_device(
        PointCloud.from_numpy(pts, cfg.capacity.max_points), cfg)
    assert int(first.cluster_overflow) > 0
    got = pipe.analyze(pts)
    want = _JaxSmallColumns().analyze(pts)
    _assert_same(got, want)
    direct = Pipeline(device="cpu").analyze(pts)
    np.testing.assert_array_equal(got["processed"].labels.numpy(),
                                  direct["processed"].labels.numpy())


def test_bucketed_dispatch_and_retry_matches_jax(monkeypatch):
    """The bucketed density forced on at the fixture's size in both
    packages (threshold 0, as tests/test_bucket_density.py does) with a
    starting bucket cap of 2: both double it until nothing is dropped and
    give the all-pairs grid."""
    pts = sample_venue()
    base = Pipeline(device="cpu").analyze(pts)
    monkeypatch.setattr(JD, "BUCKETED_MIN_PAIRS", 0)
    monkeypatch.setattr(TD, "BUCKETED_MIN_PAIRS", 0)
    cfg = MONOLITH_CONFIG.with_capacity(density_bucket_cap=2)
    pipe = Pipeline(port_cfg(cfg), device="cpu")
    fit = pipe.fit_capacity(pts)
    _, _, first = pipe.analyze_device(
        PointCloud.from_numpy(pts, fit.capacity.max_points), fit)
    assert int(first.density.radius_overflow) > 0
    got = pipe.analyze(pts)
    want = JaxPipe(cfg).analyze(pts)
    _assert_same(got, want, people=446)
    np.testing.assert_array_equal(got["density"]["density_grid"],
                                  base["density"]["density_grid"])
