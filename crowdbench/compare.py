"""The comparison that decides ``correct``: what the timed path returned
for a scan against the plain reference's answer for the same points.

Each number is a gap that reads 0 where the two agree; its limit comes
from the configuration file (``limits``), set between what sound runs of
the program read and what the control reads (``PERF.md`` gives both
readings for every limit). ``MISMATCH`` stands for a count or a label
that differs, where no distance is defined.

  people           |program's people - reference's| / reference's
  centroids        people of either side with no person of the other
                   within ``MATCH_M``, over the reference's people
  density_cells    share of grid cells whose density differs (1 when the
                   grids' shapes differ)
  density_stats    largest gap of the maximum and average density, of
                   the hotspots' densities, rank by rank, and of each
                   hotspot's density against the reference's grid at the
                   hotspot's position (ties between equal cells may order
                   them differently); MISMATCH when the hotspots' counts
                   differ, or when the recommendations are not what the
                   application's rules (``recommend.py``) give for the
                   program's own density and flow results
  flow             largest gap of a node's flow vector (m/s) and of the
                   average speed; MISMATCH when the node counts or the
                   dominant directions differ
  bottlenecks      largest gap of a bottleneck's position (m); MISMATCH
                   when the counts or a severity differ

The recommendations are a pure function of the density and flow results,
so they are held to the rules on the program's own results, exactly,
while those results are held to the reference's: a count at a cell that
rounding moves across a threshold then shows once, as a density gap.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

MISMATCH = 1000.0
MATCH_M = 1e-3

# What is judged on every scan of the window, and what on the sample that
# keeps the program's full arrays.
LIGHT = ("people", "density_stats", "bottlenecks")
HEAVY = ("centroids", "density_cells", "flow")


def _nearest(a: np.ndarray, b: np.ndarray, device, block: int = 2048
             ) -> np.ndarray:
    """Distance from each row of ``a`` to the nearest row of ``b``."""
    if len(a) == 0:
        return np.zeros(0)
    if len(b) == 0:
        return np.full(len(a), np.inf)
    ta = torch.as_tensor(a, dtype=torch.float64, device=device)
    tb = torch.as_tensor(b, dtype=torch.float64, device=device)
    out = [torch.cdist(ta[s:s + block], tb).min(1).values
           for s in range(0, len(ta), block)]
    return torch.cat(out).cpu().numpy()


def _pairs_gap(a, b, keys) -> float:
    """Largest summed gap over ``keys`` of two lists of dicts, in order;
    MISMATCH when their lengths differ."""
    if len(a) != len(b):
        return MISMATCH
    return max([sum(abs(float(x[k]) - float(y[k])) for k in keys)
                for x, y in zip(a, b)], default=0.0)


def _hotspot_gap(d: Dict, rd: Dict) -> float:
    """The hotspots' densities against the reference's, rank by rank,
    and against the reference's grid at each hotspot's cell."""
    mine, theirs = d["hotspots"], rd["hotspots"]
    if len(mine) != len(theirs):
        return MISMATCH
    grid = rd["density_map"]
    x0, y0 = rd["origin"]
    gap = 0.0
    for h, r in zip(mine, theirs):
        i = int(round((h["x"] - x0) / rd["grid_size"] - 0.5))
        j = int(round((h["y"] - y0) / rd["grid_size"] - 0.5))
        at = (grid[i, j] if 0 <= i < grid.shape[0] and 0 <= j < grid.shape[1]
              else -MISMATCH)
        gap = max(gap, abs(h["density"] - r["density"]),
                  abs(h["density"] - at))
    return gap


def light(program: Dict, ref: Dict) -> Dict[str, float]:
    """Numbers from the result dicts every scan returns."""
    from crowdbench.recommend import recommendations

    d, rd = program["density"], ref["density"]
    f, rf = program["flow"], ref["flow"]
    n_ref = ref["n_people"]
    stats = max(abs(d["max_density"] - rd["max_density"]),
                abs(d["avg_density"] - rd["avg_density"]),
                _hotspot_gap(d, rd))
    if program["recommendations"] != recommendations(d, f, ref["rules"]):
        stats = MISMATCH
    bott = _pairs_gap(f["bottlenecks"], rf["bottlenecks"], ("x", "y"))
    if any(x["severity"] != y["severity"]
           for x, y in zip(f["bottlenecks"], rf["bottlenecks"])):
        bott = MISMATCH
    return {"people": abs(d["total_people"] - n_ref) / max(1, n_ref),
            "density_stats": float(stats), "bottlenecks": float(bott)}


def heavy(program: Dict, ref: Dict, device) -> Dict[str, float]:
    """Numbers from the full arrays: the centroids, the density grid and
    the flow field."""
    n_ref = ref["n_people"]
    mine = program["centroids"]
    unmatched = (int((_nearest(ref["centroids"], mine, device)
                      > MATCH_M).sum())
                 + int((_nearest(mine, ref["centroids"], device)
                        > MATCH_M).sum()))
    grid = np.asarray(program["density"]["density_map"], np.float64)
    rgrid = ref["density"]["density_map"]
    cells = (1.0 if grid.shape != rgrid.shape else
             float((np.abs(grid - rgrid) > 1e-6).mean()))
    f, rf = program["flow"], ref["flow"]
    vec = np.asarray(f["flow_vectors"]["vectors"], np.float64)
    if (vec.shape != rf["vectors"].shape
            or f["dominant_direction"] != rf["dominant_direction"]):
        fl = MISMATCH
    else:
        fl = max(float(np.abs(vec - rf["vectors"]).max(initial=0.0)),
                 abs(f["avg_speed"] - rf["avg_speed"]))
    return {"centroids": unmatched / max(1, n_ref), "density_cells": cells,
            "flow": fl}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number is within its limit."""
    return all(numbers[k] <= limits[k] for k in numbers)


def worst(rows, names) -> Dict[str, Optional[float]]:
    """The largest reading of each number over ``rows``."""
    return {k: max((r[k] for r in rows if k in r), default=None)
            for k in names}
