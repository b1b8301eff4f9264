"""The port's CPU oracle (``oracle/reference.py``, NumPy and SciPy) against
the JAX package's (NumPy and scikit-learn), run on the same numpy input.

Exact: DBSCAN labels, ``total_people``, ``density_grid``/``density_map``,
hotspots and bottlenecks (positions, densities, severities, order and
count). Every other float within ``RTOL`` relative. Where the oracle
stands in for a scikit-learn call (DBSCAN, ``StandardScaler``), that call
is also held against the port's on the same array, bit for bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from sklearn.cluster import DBSCAN
from sklearn.preprocessing import StandardScaler

from lidar_ai_recommendation_software_tpu.oracle import reference as jax_ref
from lidar_ai_recommendation_software_tpu_torch.oracle import reference
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    sample_venue, scaled_venue)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-12
# float leaves held exactly: the grids, and the hotspots' and bottlenecks'
# cell centres and densities
EXACT = {"density_grid", "density_map", "x", "y", "density"}


def assert_same(got, want, path="out"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{k}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), path
        if w.dtype.kind == "f" and path.rsplit(".", 1)[-1] not in EXACT:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def _ground(rng, n, extent):
    return np.column_stack([rng.uniform(0, extent, (n, 2)), np.zeros(n)])


def few_non_ground(n_elevated):
    """60 ground points and ``n_elevated`` above them: 6 in a blob, the
    rest scattered. With at most 10 above the ground the oracle skips
    DBSCAN and labels them all one cluster; at 11 scikit-learn's DBSCAN
    takes brute force instead of its KD-tree (the blob a person, the rest
    noise)."""
    rng = np.random.RandomState(5)
    blob = np.array([5.0, 5.0]) + rng.uniform(-0.1, 0.1, (6, 2))
    scattered = rng.uniform(2, 8, (n_elevated - 6, 2))
    up = np.column_stack([np.vstack([blob, scattered]),
                          np.full(n_elevated, 1.5)])
    return np.vstack([_ground(rng, 60, 10.0), up])


def no_people():
    """Points above the ground 2 m apart on a grid: every one is noise."""
    rng = np.random.RandomState(6)
    g = np.arange(10, dtype=np.float64) * 2.0
    xx, yy = np.meshgrid(g, g)
    up = np.column_stack([xx.ravel(), yy.ravel(), np.full(100, 1.5)])
    return np.vstack([_ground(rng, 600, 20.0), up])


def constant_z():
    """People whose points all sit at z = 1.7: a constant column, whose
    summed mean rounds, so its variance is tiny but not 0, and
    ``StandardScaler`` sets its scale to 1."""
    rng = np.random.RandomState(7)
    centres = rng.uniform(2, 18, (30, 2))
    xy = np.repeat(centres, 8, axis=0) + rng.uniform(-0.2, 0.2, (240, 2))
    up = np.column_stack([xy, np.full(240, 1.7)])
    return np.vstack([_ground(rng, 500, 20.0), up])


def lattice_003():
    """A block of lattice points 0.3 m apart (the monolith's eps) with
    holes, above a ground plane: many neighbours lie exactly eps apart
    (their difference rounds to the double 0.3), the rest an ulp off."""
    rng = np.random.RandomState(8)
    i, j, k = np.meshgrid(np.arange(20), np.arange(20), np.arange(4),
                          indexing="ij")
    lat = np.column_stack([2 + i.ravel() * 0.3, 2 + j.ravel() * 0.3,
                           1.0 + k.ravel() * 0.3])
    lat = lat[rng.uniform(size=len(lat)) < 0.7]
    return np.vstack([_ground(rng, 2000, 12.0), lat])


def cells_at_two_metres():
    """A processed cloud of one-point people on a half-integer grid, cell
    centres at k + 0.5: many people lie exactly 2.0 from a cell centre."""
    rng = np.random.RandomState(9)
    xy = rng.randint(0, 21, (150, 2)) * 0.5
    pts = np.column_stack([xy, np.ones(len(xy))])
    return {"points": pts, "clusters": np.arange(len(pts)),
            "dimensions": {"x_range": (0.0, 10.0), "y_range": (0.0, 10.0),
                           "width": 10.0, "length": 10.0}}


# name -> the oracle's call on its input, given either module
CASES = {
    "fixture_monolith": lambda ref: ref.analyze(sample_venue(), "monolith"),
    "fixture_modular": lambda ref: ref.analyze(sample_venue(), "modular"),
    "venue_40960_monolith": lambda ref: ref.analyze(scaled_venue(40_960)),
    # bench.py's CPU baseline cloud, which chip_smoke.py holds the card to
    "venue_100000_monolith": lambda ref: ref.analyze(scaled_venue(100_000)),
    "lattice_at_eps_monolith": lambda ref: ref.analyze(lattice_003()),
    "lattice_cells_at_r2": lambda ref: ref.density_analysis(
        cells_at_two_metres(), mode="radius"),
    "ten_non_ground": lambda ref: ref.analyze(few_non_ground(10)),
    "eleven_non_ground": lambda ref: ref.analyze(few_non_ground(11)),
    "no_people": lambda ref: ref.analyze(no_people()),
    "constant_z_modular": lambda ref: ref.analyze(constant_z(), "modular"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_oracle_equals_jax(case):
    got = CASES[case](reference)
    want = CASES[case](jax_ref)
    assert_same(got, want)
    if case == "fixture_monolith":
        d, f = got["density"], got["flow"]
        assert (d["total_people"], d["max_density"],
                f["dominant_direction"]) == (446, 3.5, "E")
        assert [b["severity"] for b in f["bottlenecks"]] == [8, 8, 8, 7, 7]
    if case == "no_people":
        assert got["density"]["total_people"] == 0
        assert not (got["processed"]["clusters"] >= 0).any()
    if case.endswith("non_ground"):
        n = int((~got["processed"]["ground_mask"]).sum())
        assert n == int(case.startswith("eleven")) + 10
    if case == "lattice_cells_at_r2":
        assert got["total_people"] == 150


def _lattice(step):
    rng = np.random.RandomState(10)
    i, j, k = np.meshgrid(np.arange(12), np.arange(12), np.arange(3),
                          indexing="ij")
    x = np.column_stack([i.ravel() * step, j.ravel() * step,
                         k.ravel() * step])
    return x[rng.uniform(size=len(x)) < 0.7]


@pytest.mark.parametrize("step", [0.5, 0.3])
def test_dbscan_ties_at_exactly_eps(step):
    """Lattice points ``step`` = eps apart: at 0.5 every square is exact,
    so every axis neighbour is a tie that ``d² <= eps²`` keeps; at 0.3
    some differences round to the double 0.3 (ties) and some an ulp off.
    The labels are scikit-learn's DBSCAN's, core, border and noise."""
    x = _lattice(step)
    got = reference._dbscan(x, step)
    want = DBSCAN(eps=step, min_samples=5).fit(x).labels_
    np.testing.assert_array_equal(got, want)
    d = x[:, None, :] - x[None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    assert (d2 == step * step).sum() > len(x)  # ties are present
    assert (want >= 0).any() and (want == -1).any()


@pytest.mark.parametrize("column", ["spread", "constant", "offset"])
def test_standard_scale_bit_equal_to_sklearn(column):
    """``StandardScaler().fit_transform`` bit for bit: a spread column, a
    constant one (scale 1), and one at a 1e5 offset with 1e-9 of noise,
    whose variance (about 1e-18) is not 0 but near-constant by
    scikit-learn's test, so its scale is 1 too."""
    rng = np.random.RandomState(11)
    x = rng.normal(0, 3, (1000, 3)) + np.array([4.0, -2.0, 1.0])
    if column == "constant":
        x[:, 2] = 1.7
    if column == "offset":
        x[:, 2] = 1e5 + rng.normal(0, 1e-9, 1000)
    got = reference._standard_scale(x)
    want = StandardScaler().fit_transform(x)
    np.testing.assert_array_equal(got, want)


def test_oracle_runs_without_sklearn_or_jax():
    """In a fresh process where sklearn, jax and the JAX package cannot be
    imported (the card's machine has none of them), the port's oracle
    gives the seed-42 fixture's golden values."""
    code = (
        "import sys\n"
        "for m in ('sklearn', 'jax', 'jaxlib', 'flax', "
        "'lidar_ai_recommendation_software_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from lidar_ai_recommendation_software_tpu_torch.oracle import "
        "reference as ref\n"
        "from lidar_ai_recommendation_software_tpu_torch.synthetic import "
        "sample_venue\n"
        "out = ref.analyze(sample_venue())\n"
        "d, f = out['density'], out['flow']\n"
        "print(d['total_people'], d['max_density'], "
        "f['dominant_direction'], *[b['severity'] for b in "
        "f['bottlenecks']])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.split() == ["446", "3.5", "E", "8", "8", "8", "7", "7"]
