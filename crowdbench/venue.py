"""The venue recipe of the reference application (app_simplified.py:994-1024),
frozen here so that the yardstick stays when the program changes.

A copy of the port's ``synthetic.sample_venue`` and ``scaled_venue``: the
same points bit for bit (``tests/test_crowdbench_venue.py`` holds it).
Uniform xy over +-extent, terrain ``0.1 sin(0.5x) cos(0.5y)``, person
discs of radius 0.3 m whose points get a height drawn uniform in
[0.1, 1.8] in point order; ``scaled_venue`` keeps about 11 points/m^2 and
the people per 100 m^2 that the caller gives at any size (the reference's
fixture: 50 people on 30 x 30 m, 5.56; the port's default, 0.56, is a
tenth of it, so this copy has no default).

One departure, in speed only: above 100,000 points the port finds each
point's nearest person centre with a KD-tree (about 1 s at 1,000,000
points); here each centre is measured against the points in the 5 x 5
cells of edge r around its own, by the formula of the dense path. A
point outside those cells is farther than r from the centre, and the
square root is monotone, so a point is inside a disc exactly when the
nearest centre is nearer than r: the same mask, and a 1,000,000-point
venue takes about 0.5 s, most of it the draws.
"""

from __future__ import annotations

import numpy as np


def _person_mask_dense(x, y, centers, person_radius):
    """Nearest-centre distance below ``person_radius``, in chunks: the
    port's path up to 100,000 points, bit for bit."""
    n, n_people = len(x), len(centers)
    mask = np.empty(n, dtype=bool)
    chunk = max(1, min(n, (1 << 24) // max(1, n_people)))
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        d2 = ((x[s:e, None] - centers[None, :, 0]) ** 2
              + (y[s:e, None] - centers[None, :, 1]) ** 2)
        mask[s:e] = np.sqrt(d2.min(axis=1)) < person_radius
    return mask


def _person_mask_cells(x, y, centers, person_radius):
    """The same mask from (centre, point) pairs: every point in the 5 x 5
    cells of edge ``person_radius`` around each centre's cell."""
    r = person_radius
    x0, y0 = x.min(), y.min()
    nx = int((x.max() - x0) // r) + 1
    ny = int((y.max() - y0) // r) + 1
    cell = ((x - x0) // r).astype(np.int64) * ny + ((y - y0) // r).astype(
        np.int64)
    order = np.argsort(cell, kind="stable")
    starts = np.searchsorted(cell[order], np.arange(nx * ny + 1))
    ci = ((centers[:, 0] - x0) // r).astype(np.int64)
    cj = ((centers[:, 1] - y0) // r).astype(np.int64)
    mask = np.zeros(len(x), dtype=bool)
    for di in range(-2, 3):
        for dj in range(-2, 3):
            a, b = ci + di, cj + dj
            ok = np.flatnonzero((a >= 0) & (a < nx) & (b >= 0) & (b < ny))
            c = a[ok] * ny + b[ok]
            lo, cnt = starts[c], starts[c + 1] - starts[c]
            first = np.repeat(np.cumsum(cnt) - cnt, cnt)
            idx = order[np.repeat(lo, cnt) + np.arange(int(cnt.sum()))
                        - first]
            who = np.repeat(ok, cnt)
            d2 = ((x[idx] - centers[who, 0]) ** 2
                  + (y[idx] - centers[who, 1]) ** 2)
            mask[idx[np.sqrt(d2) < r]] = True
    return mask


def sample_venue(n_points: int = 10000, n_people: int = 50,
                 extent: float = 15.0, people_extent: float = 10.0,
                 person_radius: float = 0.3, seed: int = 42) -> np.ndarray:
    """The reference's seed-42 venue (defaults): draws x (n), y (n), the
    person centres (n_people, 2), then one height per point inside a
    person disc, in point order. ``seed`` is below 2**32."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-extent, extent, n_points)
    y = rng.uniform(-extent, extent, n_points)
    z = 0.1 * np.sin(x * 0.5) * np.cos(y * 0.5)
    centers = rng.uniform(-people_extent, people_extent, (n_people, 2))
    if n_points <= 100_000:
        person_mask = _person_mask_dense(x, y, centers, person_radius)
    else:
        person_mask = _person_mask_cells(x, y, centers, person_radius)
    heights = rng.uniform(0.1, 1.8, int(person_mask.sum()))
    z = z.copy()
    z[person_mask] = heights
    return np.column_stack((x, y, z))


def venue_size(n_points: int, people_per_100m2: float) -> tuple:
    """(extent, people) of a venue of ``n_points``: the fixture's 30 x 30 m
    and 10,000 points grown at a constant ~11 points/m^2."""
    area = 30.0 * 30.0 * (n_points / 10000.0)
    extent = float(np.sqrt(area) / 2.0)
    return extent, max(1, int(people_per_100m2 * area / 100.0))


def scaled_venue(n_points: int, seed: int,
                 people_per_100m2: float) -> np.ndarray:
    """The fixture's recipe at ``n_points``, people at the same density."""
    extent, n_people = venue_size(n_points, people_per_100m2)
    return sample_venue(n_points=n_points, n_people=n_people, extent=extent,
                        people_extent=max(1.0, extent - 5.0), seed=seed)
