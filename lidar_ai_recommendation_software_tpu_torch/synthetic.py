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


def table_fill_cases():
    """Clouds whose column occupancies stress the column table's fill
    (``ops/cuda/columns.py::table_fill``, tiles of whole columns by
    ``fill_plan``), at eps = 0.3 m: a list of (name, points (N, 3)
    float32, mask (N,), eps, min_samples, ncx, ncy, column cap), masked
    points after the cloud up to its buffer size."""

    def case(name, counts, buffer, cap, seed, masked=False):
        pts = lattice_points(counts, 0.3, seed)
        buf = np.zeros((buffer, 3), np.float32)
        buf[:len(pts)] = pts
        mask = np.arange(buffer) < len(pts)
        return (name, buf, mask & (not masked), 0.3, 5, *counts.shape, cap)

    rng = np.random.RandomState(14)
    # every column at its cap of 8 (the origin's point completes column
    # (0, 0)), 25 x 39 padded columns: tiles end inside the x rows
    full = np.full((23, 37), 8, np.int64)
    full[0, 0] = 7
    # every column 3 past its cap of 4
    past = np.full((30, 30), 7, np.int64)
    past[0, 0] = 6
    # three x rows of 300 columns, each column 1 to 2 past the cap of 16
    # points, so the runs of occupied columns cross every tile boundary
    runs = rng.randint(1, 19, (3, 300))
    # a cap of 512: a few columns full, one past it, the others at random
    deep = rng.randint(0, 600, (5, 5))
    deep[1, 1] = deep[3, 2] = 512
    deep[2, 4] = 513
    return [case("every column at its cap", full, 8192, 8, 1),
            case("every column past its cap", past, 8192, 4, 2),
            case("every point masked", rng.randint(0, 5, (16, 16)), 2048,
                 8, 3, masked=True),
            case("one point", np.zeros((4, 4), np.int64), 1, 16, 4),
            case("runs of columns across the fill's tiles", runs, 20_000,
                 16, 5),
            case("a fill cap of 512", deep, 10_000, 512, 6)]


def _place_case(name, run_lengths, valid_at, nch, k, seed):
    """A ``place_dense`` stream of runs of equal ids: run r has
    ``run_lengths[r]`` rows of id r, and its valid row, if any, at
    ``valid_at[r]`` (-1: none)."""
    rng = np.random.RandomState(seed)
    lengths = np.asarray(run_lengths, np.int64)
    ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    valid = np.zeros(len(ids), bool)
    at = np.asarray(valid_at, np.int64)
    valid[(starts + at)[at >= 0]] = True
    # ids past the last slot clip into it: keep one valid row there
    last = -(-max(k, 512) // 512) * 512 - 1
    clipped = np.flatnonzero(valid & (ids >= last))
    valid[clipped[:-1]] = False
    chans = rng.uniform(-1e4, 1e4, (nch, len(ids))).astype(np.float32)
    return name, ids, valid, chans, k


def place_dense_cases():
    """Streams that stress ``place_dense``'s tiling: a list of (name, ids
    (n,) int32 non-decreasing, valid (n,) bool with at most one valid row a
    slot, channels (C, n) float32, k). The first two have the same n and
    the same valid rows' count, one with a run of 1,000,000 invalid rows at
    the end (as the unlabelled rows of a scan clip into its last slot), one
    with short runs only; their times are compared."""
    rng = np.random.RandomState(11)
    # 125,000 runs of 8 rows, each ending in its valid row, then one run of
    # 1,000,000 invalid rows; against 125,000 runs of 16
    long_tail = _place_case(
        "one run of 1,000,000 invalid rows",
        [8] * 125_000 + [1_000_000], [7] * 125_000 + [-1], 7, 125_000, 1)
    short = _place_case("short runs, the same n", [16] * 125_000,
                        [15] * 125_000, 7, 125_000, 2)
    # lengths from 1 to 3,000 rows, so runs cross every warp and tile
    # boundary; the valid row first, last, in the middle or absent
    lengths = np.concatenate([rng.randint(1, 40, 3000),
                              rng.randint(1, 3000, 300)])
    rng.shuffle(lengths)
    choice = rng.randint(0, 4, len(lengths))
    valid_at = np.select([choice == 0, choice == 1, choice == 2],
                         [0, lengths - 1, lengths // 2], -1)
    ends = _place_case("valid rows first, last and inside runs of 1-3,000",
                       lengths, valid_at, 7, len(lengths), 3)
    one = _place_case("one channel", lengths, valid_at, 1, len(lengths), 4)
    nine = _place_case("nine channels", lengths, valid_at, 9,
                       len(lengths) - 700, 5)  # the tail clips
    empty = _place_case("no row", [], [], 7, 1000, 6)
    return [long_tail, short, ends, one, nine, empty]


def sa_mlp_pool_cases():
    """Inputs that stress ``sa_mlp_pool``'s tiling, at both tile sizes: a
    list of (name, grouped (M, K, Cin) float32, valid (M, K) bool,
    [(W, b)] * 3 float32).
    Every case has a centroid with no valid neighbour (row M // 2) and one
    with only its last neighbour valid (row 0)."""
    rng = np.random.RandomState(12)

    def case(name, m, k, cin, hidden):
        g = (rng.randn(m, k, cin) * 0.5).astype(np.float32)
        v = rng.rand(m, k) > 0.3
        v[m // 2] = False
        v[0] = False
        v[0, -1] = True
        dims = [cin, *hidden]
        w = [((rng.randn(a, b) * 0.2).astype(np.float32),
              (rng.randn(b) * 0.1).astype(np.float32))
             for a, b in zip(dims[:-1], dims[1:])]
        return name, g, v, w

    return [case("K = 16", 300, 16, 3, (32, 32, 64)),
            case("K = 48", 77, 48, 6, (16, 32, 24)),
            case("K = 128", 45, 128, 3, (32, 32, 64)),
            case("M = 1", 1, 32, 3, (32, 32, 64)),
            case("M = 1, K = 1", 1, 1, 5, (8, 8, 8)),
            case("M not a multiple of the tile", 131, 32, 67,
                 (64, 64, 128)),
            case("Cin = 67, K = 20", 53, 20, 67, (64, 64, 128)),
            case("wide layers", 9, 32, 40, (128, 64, 128)),
            # enough centroids for tiles of up to 128 rows: 6 centroids of
            # 20 rows (a centroid across pieces), 2 of 48 (3 pieces)
            case("128-row tiles, K = 20", 1100, 20, 3, (32, 32, 64)),
            case("128-row tiles, K = 48", 1100, 48, 6, (16, 32, 24))]


def _chains_with_forward_borders(n_chains: int, extent: float) -> tuple:
    """``n_chains`` lines of 12 points 0.07 m apart along x (every point a
    core point at eps 0.3, min_samples 5), one to a cell of a lattice over
    [0.5, extent - 0.5]^2, and, for each, one point 0.29 m off its first
    point across y (a border point: 3 neighbours, self included). Returns
    (chain points (12 * n_chains, 3), border points (n_chains, 3)) float32;
    put the chains at larger indices than the borders and every border
    point's label (its chain's smallest index) is larger than its own
    index."""
    side = int(np.ceil(np.sqrt(n_chains)))
    cell = (extent - 1.0) / side
    starts = np.stack([0.5 + (np.arange(n_chains) % side) * cell,
                       0.5 + (np.arange(n_chains) // side) * cell], 1)
    k = np.arange(12) * 0.07
    chains = np.concatenate([np.column_stack([s[0] + k, np.full(12, s[1]),
                                              np.full(12, 1.0)])
                             for s in starts])
    borders = np.column_stack([starts[:, 0], starts[:, 1] + 0.29,
                               np.full(n_chains, 1.0)])
    return chains.astype(np.float32), borders.astype(np.float32)


def dense_tail_cases():
    """Clouds whose clustering stresses the tail of the column-grid
    clustering (``ops/cuda/columns.py::dense_tail``: labels back to point
    order and ranked), at eps = 0.3 m and min_samples 5: a list of (name,
    points (N, 3) float32, mask (N,), eps, min_samples, ncx, ncy, column
    cap). Small enough for the JAX package's kernels in interpret mode."""
    rng = np.random.RandomState(21)

    def forward(n, n_chains, noise):
        """Chains at the end of the buffer, their border points at its
        start, uniform noise between."""
        chains, borders = _chains_with_forward_borders(n_chains, 9.0)
        pts = np.zeros((n, 3), np.float32)
        pts[:n_chains] = borders
        pts[n_chains:n_chains + noise] = rng.uniform(0, 9.0, (noise, 3))
        pts[n - len(chains):] = chains
        mask = np.zeros(n, bool)
        mask[:n_chains + noise] = True
        mask[n - len(chains):] = True
        return pts, mask

    pts, mask = forward(1024, 20, 200)
    out = [("labels pointing forward", pts, mask, 0.3, 5, 32, 32, 16)]

    # tight blobs, two of them past a cap of 8 in one column, and a third
    # of all points masked out at random
    centres = rng.uniform(0.5, 8.5, (30, 2))
    idx = rng.randint(0, 30, 1500)
    blob = np.column_stack([centres[idx] + rng.normal(0, 0.08, (1500, 2)),
                            rng.uniform(0, 1.8, 1500)])
    full = np.repeat(centres[:2], 20, axis=0) + rng.uniform(-0.02, 0.02,
                                                            (40, 2))
    pts = np.zeros((2048, 3), np.float32)
    pts[:1500] = blob
    pts[1500:1540] = np.column_stack([full, np.full(40, 0.9)])
    mask = np.zeros(2048, bool)
    mask[:1540] = rng.rand(1540) > 1 / 3
    mask[1500:1540] = True
    out.append(("dropped and masked points", pts, mask, 0.3, 5, 32, 32, 8))

    out.append(("empty stream", rng.uniform(0, 9, (1024, 3)).astype(
        np.float32), np.zeros(1024, bool), 0.3, 5, 32, 32, 16))

    pts, mask = forward(2085, 30, 900)
    out.append(("N not a multiple of the tile", pts, mask, 0.3, 5, 32, 32,
                16))
    return out


def dense_tail_label_cases():
    """Stream-order labels and point maps fed to ``dense_tail`` as they are
    (no clustering): a list of (name, labels (N,) int32, point_stream (N,)
    int32). Labels point anywhere, forward and back, at representatives
    and at points that are not (whose rank counts the representatives at
    or below them), past N - 1, and negative; about a third of the points
    have no slot (half the representatives keep theirs)."""
    rng = np.random.RandomState(22)

    def case(name, n, reps):
        rep = np.sort(rng.choice(n, size=min(reps, n), replace=False))
        # each point's label in point order: a representative's its own
        # index, the rest a representative's, or none (INT_MAX), or any
        # point's, or past N - 1, or negative
        labels = (rep[rng.randint(0, len(rep), n)] if len(rep)
                  else np.full(n, 2 ** 31 - 1))
        odd = rng.rand(n)
        labels = np.where(odd < 0.1, 2 ** 31 - 1, labels)
        labels = np.where((odd >= 0.1) & (odd < 0.12),
                          rng.randint(0, max(n, 1), n), labels)
        labels = np.where((odd >= 0.12) & (odd < 0.125), n + 5, labels)
        labels = np.where((odd >= 0.125) & (odd < 0.13), -7, labels)
        labels[rep] = rep
        # into stream order, junk at the positions no point reads
        stream = rng.permutation(n)
        stream[(rng.rand(n) < 1 / 3) & ~np.isin(np.arange(n), rep[::2])] = -1
        out = rng.randint(-2, n + 2, n)
        placed = stream >= 0
        out[stream[placed]] = labels[placed]
        return name, out.astype(np.int32), stream.astype(np.int32)

    return [case("no point", 0, 0), case("one point", 1, 1),
            case("33 points", 33, 4),
            case("200,003 points", 200_003, 9000),
            case("1,000,003 points, many words a block", 1_000_003, 40_000),
            case("no representative", 5000, 0)]
