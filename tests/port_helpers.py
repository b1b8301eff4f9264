"""Helpers shared by the tests that hold the PyTorch port against the JAX
package."""

import ast
import dataclasses
import functools
from pathlib import Path

import numpy as np

from lidar_ai_recommendation_software_tpu_torch import config as port_config
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    sample_venue, scaled_venue)

# a UTM-sized offset: a scan shifted by it is recentred by ``analyze``
UTM_SHIFT = np.array([5e5, 4e6, 0.0])

# the clouds the capacity fit is held on, by name (``fit_cloud``)
FIT_CLOUDS = ("venue_10k", "venue_40960", "venue_50k", "float32",
              "utm_shifted", "column_edges")


def port_cfg(cfg):
    """The port's ``PipelineConfig`` with every field of the JAX package's
    ``cfg`` (one made by ``with_capacity`` included), so both packages run
    the same configuration."""
    fields = dataclasses.asdict(cfg)
    default = port_config.PipelineConfig()
    kw = {}
    for f in dataclasses.fields(port_config.PipelineConfig):
        sub = getattr(default, f.name)
        kw[f.name] = (type(sub)(**fields[f.name])
                      if dataclasses.is_dataclass(sub) else fields[f.name])
    return port_config.PipelineConfig(**kw)


def imported_modules(path: Path) -> set:
    """Every module a Python file imports, at any depth (function bodies
    too), read with ``ast``."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def column_edge_cloud(cell: float, lo: float = -123.4,
                      extent: float = 400.0, n: int = 40_000,
                      seed: int = 7) -> np.ndarray:
    """(n + 4 + 9 K, 3) float64: ``n`` points uniform over the square
    [lo, lo + extent]^2 and its four corners (so that is the cloud's xy
    extent), then points on the column edges of ``cell``: x and y each
    ``lo + k * cell`` (k = 1 .. K, the edges inside the square) or one ulp
    below or above it, all nine pairs for every k."""
    rng = np.random.default_rng(seed)
    hi = lo + extent
    base = np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(0.0, 2.0, n)], axis=1)
    corners = np.array([[lo, lo, 0.0], [lo, hi, 0.0], [hi, lo, 0.0],
                        [hi, hi, 0.0]])
    edges = lo + np.arange(1, int(extent / cell) + 1) * cell
    edges = edges[edges < hi]
    sides = np.stack([np.nextafter(edges, -np.inf), edges,
                      np.nextafter(edges, np.inf)])  # (3, K)
    xs, ys = np.repeat(sides, 3, axis=0), np.tile(sides, (3, 1))
    on_edges = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)], axis=1)
    return np.concatenate([base, corners, on_edges])


# The column edge the capacity fit picks for ``column_edge_cloud``'s
# default 400 m square: 1,280 columns a side, so the extent over
# 1,279.999 (not eps = 0.3, which a reciprocal cannot hide behind).
FIT_EDGE_CELL = ((-123.4 + 400.0) - -123.4) / (1280 - 1e-3)


@functools.lru_cache(maxsize=None)
def fit_cloud(name: str) -> np.ndarray:
    """One of ``FIT_CLOUDS``: the fixture (10,000 points, the fit's
    branch without an occupancy count), venues of 40,960 and 50,000
    points, the 40,960 venue in float32 and shifted by ``UTM_SHIFT``, and
    ``column_edge_cloud`` on the edges of the fit's own cell."""
    if name == "venue_10k":
        return sample_venue()
    if name == "venue_50k":
        return scaled_venue(50_000)
    if name == "column_edges":
        return column_edge_cloud(FIT_EDGE_CELL)
    venue = scaled_venue(40_960)
    return {"venue_40960": venue, "float32": venue.astype(np.float32),
            "utm_shifted": venue + UTM_SHIFT}[name]
