"""A crowd walking to an exit, frame by frame: the port's
``synthetic.venue_sequence`` frozen here, so that the yardstick stays when
the program changes. The same frames bit for bit
(``tests/test_crowdbench_sequence.py`` holds it).

Terrain resamples every frame: ``n_points - n_people * person_points``
points uniform over +-``extent`` at height ``0.1 sin(0.5x) cos(0.5y)``.
Person centres are uniform over +-0.66 ``extent``; each person walks
toward the exit at (``extent``, 0) at ``speed`` m/s, plus a N(0, 0.1
``speed``) velocity of its own, and carries ``person_points`` returns,
N(0, 0.1) m around its centre in x and y and uniform in [0.1, 1.8] m in
height. A frame's points are the terrain's, then each person's in turn.
``seed`` + 1000 + the frame's index seeds each frame's draws, so ``seed``
is below 2**32 - 1000 - ``n_frames``.
"""

from __future__ import annotations

from typing import List

import numpy as np


def venue_sequence(n_frames: int, dt: float, n_points: int, n_people: int,
                   extent: float, speed: float, person_points: int,
                   seed: int) -> List[np.ndarray]:
    """``n_frames`` frames, ``dt`` seconds apart: float64 (n_points, 3)
    arrays (fewer points where the people's returns outnumber them)."""
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
