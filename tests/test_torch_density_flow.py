"""The PyTorch port's people extraction, density and flow against the JAX
package's, fed the same processed cloud, on the CPU.

Tolerances: density grids, hotspot cells and densities, bottleneck cells
and severities, masks and counts are exact; centroids are within 1e-5 m
(float64 prefix sums against float32 scatter sums); flow vectors and
speeds within 1e-5 (sin/cos differ by ulps between XLA and PyTorch).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.config import (
    MODULAR_CONFIG, MONOLITH_CONFIG)
from lidar_ai_recommendation_software_tpu.models import density as JD
from lidar_ai_recommendation_software_tpu.models import flow as JF
from lidar_ai_recommendation_software_tpu.ops import clustering as jcl
from lidar_ai_recommendation_software_tpu.pipeline import Pipeline as JaxPipe
from lidar_ai_recommendation_software_tpu.preprocess import preprocess
from lidar_ai_recommendation_software_tpu.types import People as JPeople
from lidar_ai_recommendation_software_tpu.types import PointCloud as JCloud
from lidar_ai_recommendation_software_tpu_torch.models import density as TD
from lidar_ai_recommendation_software_tpu_torch.models import flow as TF
from lidar_ai_recommendation_software_tpu_torch.ops import clustering as tcl
from lidar_ai_recommendation_software_tpu_torch.types import (
    People as TPeople, ProcessedCloud as TProcessed)

CONFIGS = {"monolith": MONOLITH_CONFIG, "modular": MODULAR_CONFIG}
FLOW_TOL = 1e-5
CENTROID_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _to_torch(jax_obj, cls):
    return cls(**{f.name: _t(getattr(jax_obj, f.name))
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def stages(fixture_points):
    """Per config: the JAX preprocess and people of the fixture, then
    density and flow from both packages on those same inputs."""
    out = {}
    for name, config in CONFIGS.items():
        cfg = JaxPipe(config).fit_capacity(fixture_points)
        jc = JCloud.from_numpy(fixture_points, cfg.capacity.max_points)
        jproc = jax.jit(preprocess, static_argnames="config")(jc, cfg)
        jppl = jax.jit(JD.extract_people, static_argnames="config")(jproc,
                                                                    cfg)
        uni = JF.bottleneck_uniforms(cfg.flow.random_seed,
                                     cfg.flow.bottleneck_count)
        jd = jax.jit(JD.analyze_density, static_argnames="config")(
            jproc, jppl, cfg)
        jf = jax.jit(JF.analyze_flow, static_argnames="config")(
            jproc, jppl, jnp.asarray(uni, jnp.float32), cfg)

        tproc = _to_torch(jproc, TProcessed)
        tppl = TD.extract_people(tproc, cfg)
        jppl_t = _to_torch(jppl, TPeople)
        td = TD.analyze_density(tproc, jppl_t, cfg)
        tf = TF.analyze_flow(tproc, jppl_t,
                             torch.as_tensor(uni, dtype=torch.float32), cfg)
        out[name] = dict(jppl=jppl, tppl=tppl, jd=jd, td=td, jf=jf, tf=tf)
    return out


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_extract_people(stages, variant):
    s = stages[variant]
    np.testing.assert_array_equal(s["tppl"].mask.numpy(),
                                  np.asarray(s["jppl"].mask))
    assert int(s["tppl"].overflow) == int(s["jppl"].overflow) == 0
    np.testing.assert_allclose(s["tppl"].positions.numpy(),
                               np.asarray(s["jppl"].positions),
                               atol=CENTROID_TOL)
    np.testing.assert_allclose(s["tppl"].z.numpy(), np.asarray(s["jppl"].z),
                               atol=CENTROID_TOL)


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_analyze_density(stages, variant):
    want = stages[variant]["jd"].to_host_dict()
    got = stages[variant]["td"].to_host_dict()
    assert got["total_people"] == want["total_people"]
    assert got["avg_density"] == want["avg_density"]
    assert got["max_density"] == want["max_density"]
    assert got["origin"] == want["origin"]
    np.testing.assert_array_equal(got["density_grid"], want["density_grid"])
    assert got["hotspots"] == want["hotspots"]
    if variant == "monolith":
        assert got["total_people"] == 446
        dens = [h["density"] for h in got["hotspots"]]
        # equal densities: the tie order decides which cells are listed
        assert dens[0] == 3.5 and len(set(dens)) < len(dens)


@pytest.mark.parametrize("variant", sorted(CONFIGS))
def test_analyze_flow(stages, variant):
    want = stages[variant]["jf"].to_host_dict()
    got = stages[variant]["tf"].to_host_dict()
    assert got["dominant_direction"] == want["dominant_direction"]
    assert abs(got["avg_speed"] - want["avg_speed"]) < FLOW_TOL
    assert got["bottlenecks"] == want["bottlenecks"]
    for key in ("positions", "vectors", "magnitudes"):
        assert got["flow_vectors"][key].shape == \
            want["flow_vectors"][key].shape
        np.testing.assert_allclose(got["flow_vectors"][key],
                                   want["flow_vectors"][key], atol=FLOW_TOL)
    if variant == "monolith":
        assert [b["severity"] for b in got["bottlenecks"]] == [8, 8, 8, 7, 7]


def _people(pos, live):
    k = len(pos)
    mask = np.arange(k) < live
    return (JPeople(positions=jnp.asarray(pos), mask=jnp.asarray(mask),
                    z=jnp.zeros(k), overflow=jnp.asarray(0)),
            TPeople(positions=_t(pos), mask=_t(mask), z=torch.zeros(k),
                    overflow=torch.tensor(0)))


@pytest.mark.parametrize("seed,k,live,gx,gy,gs,r", [
    (0, 256, 200, 64, 48, 1.0, 2.0),
    (1, 512, 512, 96, 96, 0.5, 2.0),
    (2, 128, 90, 33, 65, 1.0, 3.3),
    (3, 64, 0, 16, 16, 1.0, 2.0),
])
def test_radius_count_grid(seed, k, live, gx, gy, gs, r):
    rng = np.random.RandomState(seed)
    pos = (rng.uniform(0, 1, (k, 2)) * (gx * gs, gy * gs)).astype(np.float32)
    jp, tp = _people(pos, live)
    origin = np.float32([-1.25, 0.5])
    nx, ny = gx - 3, gy - 1
    want, _ = JD.radius_count_grid(jp, jnp.asarray(origin), jnp.asarray(nx),
                                   jnp.asarray(ny), gx, gy, gs, r)
    got, ov = TD.radius_count_grid(tp, _t(origin), torch.tensor(nx),
                                   torch.tensor(ny), gx, gy, gs, r)
    assert int(ov) == 0 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_radius_count_grid_exact_radius():
    c = np.float32([4.5, 4.5])
    pos = np.stack([c + [2.0, 0.0], c + [0.0, -2.0], c + [2.001, 0.0],
                    c]).astype(np.float32)
    jp, tp = _people(pos, 4)
    origin = np.zeros(2, np.float32)
    want, _ = JD.radius_count_grid(jp, jnp.asarray(origin), jnp.asarray(16),
                                   jnp.asarray(16), 16, 16, 1.0, 2.0)
    got, _ = TD.radius_count_grid(tp, _t(origin), torch.tensor(16),
                                  torch.tensor(16), 16, 16, 1.0, 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[4, 4]) == 3


def test_bucketed_range_raises():
    _, tp = _people(np.zeros((1 << 12, 2), np.float32), 10)
    with pytest.raises(NotImplementedError, match="item 6"):
        TD.radius_count_grid(tp, torch.zeros(2), torch.tensor(1),
                             torch.tensor(1), 1024, 1024, 1.0, 2.0,
                             bucket_cap=32)


def test_histogram_grid():
    rng = np.random.RandomState(5)
    pos = rng.uniform(-3, 20, (300, 2)).astype(np.float32)
    jp, tp = _people(pos, 250)
    origin = np.float32([-3.0, -3.0])
    want = JD.histogram_grid(jp, jnp.asarray(origin), jnp.asarray(24),
                             jnp.asarray(23), 32, 32, 1.0)
    got = TD.histogram_grid(tp, _t(origin), torch.tensor(24),
                            torch.tensor(23), 32, 32, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("y_major", [True, False])
def test_top_hotspots_tie_order(y_major):
    """Many equal densities: the stable sort must pick the same cells, in
    the same order, as jax.lax.top_k."""
    rng = np.random.RandomState(9)
    grid = (rng.randint(0, 4, (12, 10)) * 0.25).astype(np.float32)
    valid = np.ones_like(grid, bool)
    valid[10:, :] = False
    cx = np.arange(12, dtype=np.float32) + 0.5
    cy = np.arange(10, dtype=np.float32) - 3.5
    want = JD.top_hotspots(jnp.asarray(grid), jnp.asarray(valid),
                           jnp.asarray(cx), jnp.asarray(cy),
                           jnp.asarray(0.5, jnp.float32), 7, y_major)
    got = TD.top_hotspots(_t(grid), _t(valid), _t(cx), _t(cy),
                          torch.tensor(0.5), 7, y_major)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [8, 5])
def test_cluster_centroids(k):
    rng = np.random.RandomState(3)
    pts = rng.uniform(-15, 15, (500, 3)).astype(np.float32)
    labels = rng.randint(-1, 7, 500).astype(np.int32)
    jc, jv, jo = jcl.cluster_centroids(jnp.asarray(pts), jnp.asarray(labels),
                                       k)
    tc, tv, to = tcl.cluster_centroids(_t(pts), _t(labels), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(to) == int(jo) == max(0, 7 - k)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=CENTROID_TOL)


@pytest.mark.parametrize("dx,dy", [(0, 0), (2, -1), (-2, 2), (1, 3)])
def test_shift(dx, dy):
    a = np.arange(5 * 4 * 2, dtype=np.float32).reshape(5, 4, 2)
    want = JF._shift(jnp.asarray(a), dx, dy, 0.0)
    np.testing.assert_array_equal(TF._shift(_t(a), dx, dy, 0.0).numpy(),
                                  np.asarray(want))
    b = a[..., 0] > 10
    want = JF._shift(jnp.asarray(b), dx, dy, False)
    np.testing.assert_array_equal(TF._shift(_t(b), dx, dy, False).numpy(),
                                  np.asarray(want))


def test_scalar_division_rounds_once():
    """float / tensor in PyTorch is reciprocal() * float (two roundings);
    the flow rescale must divide once, as XLA does."""
    den = np.random.RandomState(11).uniform(0.5, 3, 4096).astype(np.float32)
    got = TF._div(1.3, _t(den)).numpy()
    np.testing.assert_array_equal(got, np.float32(1.3) / den)
    want = jnp.float32(1.3) / jnp.asarray(den)
    np.testing.assert_array_equal(got, np.asarray(want))
