"""The one traffic generator: a pool of scans made from ``--seed`` and the
order the one closed-loop caller submits them in, from a traffic file's
parameters.

Traffic file keys:
  ``pool``   scans in the pool, each a distinct moment of the venue (same
             extent, new draws);
  ``order``  ``"generator"`` keeps the generator's order (random over the
             venue); ``"sensor_posts"`` reorders each scan as sensors emit
             it: each point to the nearest of ``posts`` = [px, py] posts on
             a regular grid over the venue, posts in turn, within a post by
             azimuth in steps of ``azimuth_step_deg``, then by range.

The caller is always one, in a closed loop (``run.closed_loop``): the next
scan is submitted when the last result has returned.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from crowdbench import venue


def seed_state(seed: int, words: int) -> np.ndarray:
    """``words`` uint32 words from any whole number ``seed``."""
    entropy = seed if seed >= 0 else [1, -seed]
    return np.random.SeedSequence(entropy).generate_state(words)


def sensor_order(points: np.ndarray, extent: float, posts=(4, 4),
                 azimuth_step_deg: float = 0.2) -> np.ndarray:
    """The permutation that puts ``points`` in the order the sensor posts
    emit them: posts at the centres of a ``posts`` grid of cells over the
    venue (+-``extent``), a point to its cell's post (the nearest), posts
    in turn (x-major), within a post by azimuth step, then by range (to
    the millimetre; ties keep the generator's order)."""
    px, py = posts
    ex, ey = 2 * extent / px, 2 * extent / py
    col = np.clip(((points[:, 0] + extent) // ex).astype(np.int64), 0, px - 1)
    row = np.clip(((points[:, 1] + extent) // ey).astype(np.int64), 0, py - 1)
    dx = points[:, 0] - (-extent + (col + 0.5) * ex)
    dy = points[:, 1] - (-extent + (row + 0.5) * ey)
    azimuth = np.degrees(np.arctan2(dy, dx)) % 360.0
    steps = int(np.ceil(360.0 / azimuth_step_deg))
    step = np.minimum(np.floor(azimuth / azimuth_step_deg).astype(np.int64),
                      steps - 1)
    mm = np.round(np.hypot(dx, dy) * 1000.0).astype(np.int64)
    key = ((col * py + row) * steps + step) * (1 << 32) + mm
    return np.argsort(key, kind="stable")


def make_pool(config: Dict, traffic: Dict, seed: int) -> List[np.ndarray]:
    """The pool of scans of a cell: float64 (n, 3) arrays in the order the
    caller submits their points."""
    n = int(config["points"])
    state = seed_state(seed, int(traffic["pool"]))
    pool = []
    for s in state:
        pts = venue.scaled_venue(n, seed=int(s),
                                 people_per_100m2=config["people_per_100m2"])
        if traffic["order"] == "sensor_posts":
            extent, _ = venue.venue_size(n, config["people_per_100m2"])
            pts = pts[sensor_order(pts, extent, tuple(traffic["posts"]),
                                   traffic["azimuth_step_deg"])]
        elif traffic["order"] != "generator":
            raise ValueError(f"unknown order {traffic['order']!r}")
        pool.append(pts)
    return pool


def submissions(pool_size: int, seed: int) -> Iterator[int]:
    """Pool indices in the order they are submitted: rounds of a seeded
    permutation, so every scan is submitted equally often."""
    rng = np.random.RandomState(int(seed_state(seed, 1 + pool_size)[-1]))
    while True:
        yield from (int(i) for i in rng.permutation(pool_size))
