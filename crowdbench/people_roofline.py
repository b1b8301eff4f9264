"""The work of turning the clustered buffer into people, counted from the
layer's inputs and outputs alone, never from a layout of the program's,
and whether a traced run's scans took the ``place_dense`` centroid route,
as the port's own ``density.centroids`` records say.

Kept beside ``roofline.py`` for the per-layer metrics of the people's
extraction (``metrics/density.people_ms.py``,
``metrics/kernels.people_roofline_pct.py``).
"""

from __future__ import annotations

from typing import Iterable

ROUTE = "place_dense"


def people_bytes(clustered_points: int) -> int:
    """Bytes the extraction has to move at least: each clustered point's
    xyz (3 x float32) and cluster id (int32) read once. The people it
    writes (16 bytes a person) are left out, so a share over this count
    can read low, never high."""
    return 16 * int(clustered_points)


def takes_place_dense(records: Iterable) -> bool:
    """True where the port's records (``profiling.Scan`` s) hold
    ``density.centroids`` spans and every one of them names the
    ``place_dense`` route; False where there is none (a port without the
    span, or no session) or one took another route."""
    routes = [sp.attrs.get("route") for scan in records for sp in scan.spans
              if sp.name == "density.centroids"]
    return bool(routes) and all(r == ROUTE for r in routes)
