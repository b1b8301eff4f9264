"""The kind ``sequence``: one call is ``Pipeline.analyze_sequence`` of a
window of consecutive frames of one walking crowd.

The interface is ``kinds/scan.py``'s. An item of the pool is a
``Window``: its frames, each an array of its own, and ``dt``, the
configuration's frame interval, which ``call`` hands to the program. The
pool is the sliding windows of ``frames`` consecutive frames of one walk
of ``walk_frames`` frames (``walk.py``) made from the seed, points in the
generator's order (terrain, then each person's returns).

Each call is held to the plain tracking reference (``tracking.py``): the
last frame's people, density and recommendations by ``compare.py``'s
numbers, and the tracked flow by these:

  bottlenecks  as ``compare.py``'s, on the tracked field
  flow         the larger of the share of lattice nodes, of those either
               side occupies, that one side alone occupies or whose
               vectors differ by more than ``NODE_TOL``, and the average
               speed's gap (m/s); ``compare.MISMATCH`` when the dominant
               directions differ. A node's vector is a mean of the
               velocities within one grid step of it, so a centroid that
               rounding puts on the other side of that step moves one
               node, and a share measures that where a largest gap cannot
  tracked      per frame, the person-like people of either side with no
               person of the other within ``compare.MATCH_M``, over the
               reference's person-like people; the largest over the
               frames (``compare.MISMATCH`` where the frame counts differ)
"""

from __future__ import annotations

import importlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from crowdbench import compare, tracking, venue, walk
from crowdbench import traffic as mixes

PORT = "lidar_ai_recommendation_software_tpu_torch"
NODE_TOL = 1e-3  # m/s

LIGHT = compare.LIGHT
HEAVY = compare.HEAVY + ("tracked",)


def _present(entries) -> Tuple[Tuple[str, str, str], ...]:
    """The entry points of ``entries`` that the port has: a port from
    before the ``temporal.*`` spans has no ``accumulate_samples``, and runs
    the cell without that span."""
    return tuple(e for e in entries
                 if hasattr(importlib.import_module(e[0]), e[1]))


# ``people_of_cloud``: each earlier frame's extraction; ``temporal_flow``:
# the tracking. ``match_people`` and ``accumulate_samples`` sit inside the
# port's ``temporal.match`` and ``temporal.nodes`` spans: synchronised,
# they hold those spans' records until the stage's device work is done.
SPANS = _present((
    (f"{PORT}.pipeline", "people_of_cloud", "people_of_cloud"),
    (f"{PORT}.models.temporal", "temporal_flow_multi", "temporal_flow"),
    (f"{PORT}.models.temporal", "match_people", "match_people"),
    (f"{PORT}.models.temporal", "accumulate_samples", "accumulate_samples"),
))


class Window(NamedTuple):
    frames: Tuple[np.ndarray, ...]
    dt: float


def make_pool(config: Dict, traffic: Dict, seed: int) -> List[Window]:
    n, size = int(traffic["walk_frames"]), int(config["frames"])
    if int(traffic["pool"]) != n - size + 1:
        raise ValueError(f"{traffic['pool']} windows of {size} frames "
                         f"do not slide over {n} frames")
    extent, _ = venue.venue_size(int(config["points"]),
                                 config["people_per_100m2"])
    # the walk seeds its frames with seed + 1000 + t: below 2**31 here
    walk_seed = int(mixes.seed_state(seed, 1)[0]) >> 1
    frames = walk.venue_sequence(
        n_frames=n, dt=config["dt"], n_points=int(config["points"]),
        n_people=int(config["people"]), extent=extent,
        speed=config["speed"], person_points=int(config["person_points"]),
        seed=walk_seed)
    return [Window(tuple(f.copy() for f in frames[i:i + size]),
                   config["dt"]) for i in range(n - size + 1)]


def points(item: Window) -> int:
    return sum(len(f) for f in item.frames)


def call(pipe, item: Window) -> Dict:
    return pipe.analyze_sequence(list(item.frames), dt=item.dt)


def reference(item: Window, settings: Dict, dtype, device) -> Dict:
    return tracking.analyze_sequence(
        [f.astype(np.float32) for f in item.frames], item.dt, settings,
        dtype, device)


def clustered(ref: Dict) -> int:
    return ref["clustered"]


def keep(out: Dict) -> Tuple[Dict, Dict]:
    """The result dicts without the full arrays, and the full arrays with
    the people and the tracked people still on the device."""
    d = {k: v for k, v in out["density"].items()
         if k not in ("density_map", "density_grid")}
    f = {k: v for k, v in out["flow"].items() if k != "flow_vectors"}
    return ({"density": d, "flow": f,
             "recommendations": out["recommendations"]},
            {"people": out["people"], "density": out["density"],
             "flow": out["flow"], "tracked_people": out["tracked_people"]})


def light(kept: Dict, ref: Dict) -> Dict[str, float]:
    return compare.light(kept, ref)


def _flow_gap(f: Dict, rf: Dict) -> float:
    if f["dominant_direction"] != rf["dominant_direction"]:
        return compare.MISMATCH
    g = rf["grid_size"]
    x0, y0 = rf["origin"]

    def by_node(pos, vec):
        pos = np.asarray(pos, np.float64).reshape(-1, 2)
        i = np.rint((pos[:, 0] - x0) / g).astype(np.int64)
        j = np.rint((pos[:, 1] - y0) / g).astype(np.int64)
        return dict(zip(zip(i.tolist(), j.tolist()),
                        np.asarray(vec, np.float64).reshape(-1, 2)))

    mine = by_node(f["flow_vectors"]["positions"],
                   f["flow_vectors"]["vectors"])
    theirs = by_node(rf["positions"], rf["vectors"])
    nodes = set(mine) | set(theirs)
    differ = sum(1 for n in nodes if n not in mine or n not in theirs
                 or np.abs(mine[n] - theirs[n]).max() > NODE_TOL)
    return max(differ / max(1, len(nodes)),
               abs(f["avg_speed"] - rf["avg_speed"]))


def _tracked_gap(mine: List[np.ndarray], theirs: List[np.ndarray],
                 device) -> float:
    if len(mine) != len(theirs):
        return compare.MISMATCH
    worst = 0.0
    for a, b in zip(mine, theirs):
        unmatched = (int((compare._nearest(b, a, device)
                          > compare.MATCH_M).sum())
                     + int((compare._nearest(a, b, device)
                            > compare.MATCH_M).sum()))
        worst = max(worst, unmatched / max(1, len(b)))
    return worst


def heavy(kept: Dict, ref: Dict, device) -> Dict[str, float]:
    if "centroids" not in kept:  # the program's people, read back now
        ppl, seq = kept["people"], kept["tracked_people"]
        kept = dict(
            kept, centroids=ppl.positions[ppl.mask].double().cpu().numpy(),
            tracked=[seq.positions[t][seq.mask[t]].double().cpu().numpy()
                     for t in range(seq.positions.shape[0])])
    nums = compare.heavy(kept, ref, device)
    nums["flow"] = _flow_gap(kept["flow"], ref["flow"])
    nums["tracked"] = _tracked_gap(kept["tracked"], ref["tracked"], device)
    return nums


def as_kept(ref: Dict) -> Tuple[Dict, Dict]:
    """A reference's answer in the shape of ``keep``'s dicts, its people
    read back already."""
    f = dict(ref["flow"], flow_vectors={"vectors": ref["flow"]["vectors"],
                                        "positions": ref["flow"]["positions"]})
    prog = {"density": ref["density"], "flow": f,
            "recommendations": ref["recommendations"],
            "centroids": ref["centroids"], "tracked": ref["tracked"]}
    return prog, prog
