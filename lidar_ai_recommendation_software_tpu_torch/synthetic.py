"""Synthetic venue generators: the port's own copy of the JAX package's
``synthetic.py`` (NumPy and SciPy only), giving the same points bit for
bit.

``sample_venue`` reproduces — bit-for-bit, including NumPy RNG consumption
order — the reference's de-facto golden fixture: the seed-42 synthetic point
cloud built inline in the monolith app (app_simplified.py:994-1024 /
app_with_db.py:1020-1050): 10,000 points uniform in ±15 m xy, sinusoidal
terrain ``0.1 sin(0.5x) cos(0.5y)``, 50 person clusters of radius 0.3 m with
per-point heights drawn uniform in [0.1, 1.8].

``scaled_venue`` generalises the same recipe to arbitrary sizes for
benchmarking (100K / 1M / 10M points per BASELINE.md protocol).
"""

from __future__ import annotations

import numpy as np


def sample_venue(n_points: int = 10000, n_people: int = 50,
                 extent: float = 15.0, people_extent: float = 10.0,
                 person_radius: float = 0.3, seed: int = 42) -> np.ndarray:
    """The reference golden fixture (defaults = app_simplified.py:994-1024).

    RNG draw order matches the reference exactly: x (n), y (n),
    people_centers (n_people, 2), then one height draw per point that falls
    within ``person_radius`` of its nearest person centre, in point order.
    """
    rng = np.random
    rng.seed(seed)
    x = rng.uniform(-extent, extent, n_points)
    y = rng.uniform(-extent, extent, n_points)
    z = 0.1 * np.sin(x * 0.5) * np.cos(y * 0.5)

    centers = rng.uniform(-people_extent, people_extent, (n_people, 2))

    # Nearest-centre distance per point. Up to 100k points: vectorised
    # chunked form, bit-identical to the reference's per-point loop (the
    # parity fixture lives here). Beyond that: cKDTree nearest-neighbour —
    # same exact minimum distance, ~100x faster than the O(n*people)
    # dense pass (which takes ~20 min of NumPy at 10M points).
    if n_points <= 100_000:
        person_mask = np.empty(n_points, dtype=bool)
        chunk = max(1, min(n_points, (1 << 24) // max(1, n_people)))
        for s in range(0, n_points, chunk):
            e = min(n_points, s + chunk)
            d2 = ((x[s:e, None] - centers[None, :, 0]) ** 2
                  + (y[s:e, None] - centers[None, :, 1]) ** 2)
            person_mask[s:e] = np.sqrt(d2.min(axis=1)) < person_radius
    else:
        from scipy.spatial import cKDTree
        dist, _ = cKDTree(centers).query(np.column_stack((x, y)), k=1)
        person_mask = dist < person_radius

    # The reference draws one uniform per in-person point, in increasing
    # point order — replicate the stream consumption.
    heights = rng.uniform(0.1, 1.8, int(person_mask.sum()))
    z = z.copy()
    z[person_mask] = heights

    return np.column_stack((x, y, z))


def venue_sequence(n_frames: int = 5, dt: float = 0.5,
                   n_points: int = 10000, n_people: int = 50,
                   extent: float = 15.0, speed: float = 1.0,
                   person_points: int = 40, seed: int = 42) -> list:
    """A temporal sequence of venue frames with people drifting toward the
    right-edge exit at ``speed`` m/s (plus small per-person jitter) — the
    input the reference never has (its flow is simulated,
    crowd_flow_model.py:19-26).

    Unlike the density fixture (which, faithfully to the reference,
    leaves only ~3 uniform samples per person — below DBSCAN's
    min_samples, so 'people' there are terrain speckle), each person here
    carries ``person_points`` dedicated returns, the realistic LiDAR
    regime, so person clusters are dense, stable across frames and
    trackable. Terrain resamples per frame; person columns move
    coherently."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-extent * 0.66, extent * 0.66, (n_people, 2))
    jitter = rng.normal(0, 0.1 * speed, (n_people, 2))
    n_terrain = max(0, n_points - n_people * person_points)
    frames = []
    for t in range(n_frames):
        frng = np.random.RandomState(seed + 1000 + t)
        x = frng.uniform(-extent, extent, n_terrain)
        y = frng.uniform(-extent, extent, n_terrain)
        z = 0.1 * np.sin(x * 0.5) * np.cos(y * 0.5)
        # direction toward exit at (extent, 0)
        d = np.stack([extent - centers[:, 0], -centers[:, 1]], 1)
        d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
        vel = d * speed + jitter
        pos = centers + vel * dt * t
        px = (pos[:, 0:1]
              + frng.normal(0, 0.1, (n_people, person_points))).ravel()
        py = (pos[:, 1:2]
              + frng.normal(0, 0.1, (n_people, person_points))).ravel()
        pz = frng.uniform(0.1, 1.8, n_people * person_points)
        frames.append(np.column_stack((
            np.concatenate([x, px]), np.concatenate([y, py]),
            np.concatenate([z, pz]))))
    return frames


def scaled_venue(n_points: int, seed: int = 42,
                 people_per_100m2: float = 0.56) -> np.ndarray:
    """A benchmark venue scaled so crowd statistics stay realistic.

    The golden fixture has 50 people in a 30x30 m venue. We grow the venue
    area linearly with the point count (constant ~11 pts/m^2 sampling
    density) and keep the same people-per-area, so clustering workload grows
    linearly and density stats stay in the reference's regime.

    The same points as the JAX package's ``scaled_venue``, bit for bit.
    Unlike it, this copy keeps no on-disk cache: a 1M-point venue takes a
    few seconds through the cKDTree path, and the port writes nothing
    outside its checkout.
    """
    base_area = 30.0 * 30.0
    base_points = 10000.0
    area = base_area * (n_points / base_points)
    extent = float(np.sqrt(area) / 2.0)
    n_people = max(1, int(people_per_100m2 * area / 100.0))
    return sample_venue(
        n_points=n_points, n_people=n_people, extent=extent,
        people_extent=max(1.0, extent - 5.0), seed=seed,
    )


def lattice_points(counts: np.ndarray, cell: float,
                   seed: int) -> np.ndarray:
    """``counts[i, j]`` points jittered inside column (i, j) of a grid of
    ``cell``-wide columns, and one more at the origin, in column (0, 0),
    which pins a clustering grid of ``cell``-wide columns there: (P, 3)
    float32. Column occupancies made to order."""
    rng = np.random.RandomState(seed)
    i, j = np.nonzero(counts)
    reps = counts[i, j]
    ci, cj = np.repeat(i, reps), np.repeat(j, reps)
    jitter = rng.uniform(0.05, 0.95, (len(ci), 2))
    pts = np.column_stack([(ci + jitter[:, 0]) * cell,
                           (cj + jitter[:, 1]) * cell,
                           rng.uniform(0.0, 0.2, len(ci))])
    return np.concatenate([pts, [[0.0, 0.0, 0.0]]]).astype(np.float32)


def column_occupancy_cases():
    """Clouds whose column occupancies stress the column-grid clustering's
    tiled scan, at eps = 0.3 m (the columns' width): a list of (name,
    points (N, 3) float32, mask (N,), eps, min_samples, ncx, ncy, column
    cap), each cloud followed by masked points up to its buffer size."""

    def case(name, counts, buffer, min_samples, cap, seed):
        pts = lattice_points(counts, 0.3, seed)
        buf = np.zeros((buffer, 3), np.float32)
        buf[:len(pts)] = pts
        return (name, buf, np.arange(buffer) < len(pts), 0.3, min_samples,
                *counts.shape, cap)

    rng = np.random.RandomState(1)
    # 300 columns along y, so each x row's run of the stream ends inside a
    # row tile of 256 columns and the next row's starts: points in the
    # first, the last and the tile boundary's columns of every row
    ends = np.zeros((12, 300), np.int64)
    for j in (0, 1, 2, 254, 255, 256, 257, 297, 298, 299):
        ends[:, j] = rng.randint(1, 7, 12)
    # x rows 1 and 3 every column at its cap of 64, row 2 between them
    # sparse: the largest staging window a row tile can meet
    sparse = np.zeros((5, 300), np.int64)
    sparse[1] = sparse[3] = 64
    sparse[2, ::7] = 1
    # every column at its cap of 16 (the origin's point completes column
    # (0, 0))
    full = np.full((40, 40), 16, np.int64)
    full[0, 0] = 15
    # the pipeline's largest cap, 512: a window of 9 x 512 slots, past the
    # 48 KB a block gets without asking
    deep = rng.randint(0, 200, (6, 6))
    deep[2, 3] = deep[4, 1] = 512
    return [case("runs across x rows", ends, 8192, 3, 8, 2),
            case("sparse row between full rows", sparse, 40_960, 5, 64, 3),
            case("every column full", full, 25_600, 5, 16, 4),
            case("a cap of 512", deep, 16_384, 5, 512, 5)]
