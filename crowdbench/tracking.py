"""The plain tracking reference: a crowd's flow measured by tracking its
people over consecutive frames, written in plain PyTorch, in any dtype
and on any device.

It imports nothing of the program and takes nothing the program made.
It is given the frames the program is given (float32 points) and works
everything out again: each frame's inliers, ground split, DBSCAN and
cluster centroids (``reference.py``'s, by import), each cluster's mean
height, the tracking, the flow field and its bottlenecks, and, on the
last frame, the density and the recommendations. The numbers come from
the configuration file's ``pipeline`` settings.

Semantics (``flow`` settings in quotes):

  - A frame's people are its clusters whose mean height lies more than
    ``track_min_height`` above the frame's lowest inlier: person-like.
  - A frame's rows are its clusters in cluster order (by lowest core
    point index, as ``reference.centroids`` orders them), then empty
    rows. Each row of frame t + 1 names a row of frame t: a person-like
    row its nearest person-like row of frame t (squared distance
    ``dx*dx + dy*dy``, ties to the first row; row 0 where frame t has no
    person), every other row, empty ones included, row 0. A row is
    matched where it is person-like, the row it names is the person-like
    row whose nearest person-like row of frame t + 1 it is, and the
    two lie within ``track_max_speed * dt``; its velocity is the
    difference of the two centroids over ``dt``.
  - With three frames or more, a matched row of frame t + 1 keeps its
    velocity only where that agrees, within ``track_consistency_tol``
    (squared gap ``<=`` its square), with the velocity of the row it
    names in the pair before (that row matched too), or with the velocity
    of the row of frame t + 2 that names it in the pair after (that row
    matched too).
  - **The row that names it**: where several rows of frame t + 2 name
    the same row of frame t + 1, the last of them in row order is the one,
    matched or not. This is not plain mutual-partner semantics: a row's
    mutual partner can be passed over for a later row that names it
    without being named back, and row 0 of every frame is named last by
    an empty row, so it never agrees with the pair after. The JAX
    package's tracking inverts a pair's matches by a scatter whose last
    write wins, and the program keeps that on purpose, so both give the
    same answer; this reference states it. The program has empty rows in
    every frame: its people capacity exceeds the clusters (the
    configuration's ``program_paths`` gives it).
  - Each kept velocity is a sample at its row's position in frame t + 1.
    The lattice's nodes are (x0 + i g, y0 + j g) for the last frame's
    inlier minima (x0, y0), ``grid_size`` g, i < nx = ceil((x1 + g - x0)
    / g) and j < ny likewise, x1 and y1 the inlier maxima. A node's vector
    is the mean of the samples within g of it (``dx*dx + dy*dy <= g*g``,
    node minus sample), over every pair; nodes without one are empty and
    stay out of the statistics: the average speed and the mean vector are
    means over the occupied nodes, the dominant direction the 8-way
    compass of that mean vector ("N/A" where no node is occupied).
  - Bottlenecks are the monolith's stencil on this field: an occupied
    node slower than ``mono_slow_speed`` whose box (lattice offsets
    below ``mono_box_halfwidth``, itself included) holds an occupied node
    faster than ``mono_fast_speed``, with severity floor(10 (box max -
    speed) / box max), at most 10, from ``mono_min_severity`` up; the
    first ``max_bottlenecks`` by severity, ties in y-major order.

Every step runs in ``dtype``: float64 for the reference, bfloat16 for the
control (``control.py``). Distances are taken in blocks of rows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from crowdbench import reference as plain

DIRECTIONS = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]


def frame_clusters(points: np.ndarray, settings: Dict, dtype,
                   device) -> Dict:
    """One frame's clusters in cluster order: centroids ``xy`` (k, 2) and
    ``person`` (k,) bool, person-like by their mean height; the inliers'
    ``mins`` and ``maxs`` (3,); ``clustered``, the non-ground inliers."""
    pc, fc = settings["preprocess"], settings["flow"]
    p = torch.as_tensor(np.asarray(points, np.float32)).to(device, dtype)
    # the 3-sigma inliers and the ground split, as ``reference.analyze``
    mean = p.mean(0)
    std = torch.sqrt(((p - mean) ** 2).mean(0))
    inlier = ((p - mean).abs() < pc["outlier_sigma"] * std).all(1)
    pts = p[inlier]
    z = pts[:, 2]
    ng = pts[~(z <= plain._percentile(z, pc["ground_percentile"]))]
    if ng.shape[0] > pc["min_cluster_points"]:
        roots = plain.dbscan(ng, pc["dbscan_eps"], pc["dbscan_min_samples"])
    else:
        roots = torch.zeros(ng.shape[0], dtype=torch.int64, device=p.device)
    xy = plain.centroids(ng, roots)
    member = roots >= 0
    _, inv = torch.unique(roots[member], return_inverse=True)
    k = xy.shape[0]
    zsum = torch.zeros(k, dtype=p.dtype, device=p.device)
    zsum.index_add_(0, inv, ng[member][:, 2])
    zmean = zsum / torch.bincount(inv, minlength=k).to(p.dtype)
    mins, maxs = pts.min(0).values, pts.max(0).values
    return {"xy": xy, "person": zmean - mins[2] > fc["track_min_height"],
            "mins": mins, "maxs": maxs, "clustered": int(ng.shape[0])}


def _squared(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    return dx * dx + dy * dy


def _nearest(a: torch.Tensor, b: torch.Tensor, block: int = 4096):
    """For each row of ``a``, its nearest row of ``b`` (first on ties) and
    the squared distance; ``b`` not empty."""
    idx, d2 = [], []
    for s in range(0, a.shape[0], block):
        d = _squared(a[s:s + block], b)
        m = torch.min(d, dim=1)
        idx.append(m.indices)
        d2.append(m.values)
    if not idx:
        return (torch.zeros(0, dtype=torch.int64, device=a.device),
                torch.zeros(0, dtype=a.dtype, device=a.device))
    return torch.cat(idx), torch.cat(d2)


def track_pair(prev: Dict, curr: Dict, dt: float, fc: Dict) -> Dict:
    """Frame t -> t + 1: for each row (cluster) of frame t + 1, the row of
    frame t it names, whether it is matched, and its velocity (0 where
    not matched)."""
    dev, dtype = curr["xy"].device, curr["xy"].dtype
    k = curr["xy"].shape[0]
    names = torch.zeros(k, dtype=torch.int64, device=dev)
    matched = torch.zeros(k, dtype=torch.bool, device=dev)
    vel = torch.zeros((k, 2), dtype=dtype, device=dev)
    cp = torch.nonzero(curr["person"]).flatten()  # rows, in row order
    pp = torch.nonzero(prev["person"]).flatten()
    if len(cp) and len(pp):
        fwd, d2 = _nearest(curr["xy"][cp], prev["xy"][pp])
        bwd, _ = _nearest(prev["xy"][pp], curr["xy"][cp])
        limit = torch.tensor(fc["track_max_speed"] * dt, dtype=dtype,
                             device=dev) ** 2
        ok = (bwd[fwd] == torch.arange(len(cp), device=dev)) & (d2 <= limit)
        names[cp] = pp[fwd]
        matched[cp] = ok
        dt_t = torch.tensor(dt, dtype=dtype, device=dev)
        v = (curr["xy"][cp] - prev["xy"][pp[fwd]]) / dt_t
        vel[cp] = torch.where(ok[:, None], v, torch.zeros_like(v))
    return {"names": names, "matched": matched, "vel": vel}


def _named_last_by(pair: Dict, rows: int) -> List:
    """For each of ``rows`` rows of the earlier frame, the last row of the
    later frame that names it; None where no row names it, or where the
    last is an empty row (empty rows come last and name row 0)."""
    last: List = [None] * rows
    for r, j in enumerate(pair["names"].tolist()):
        last[j] = r
    if rows:
        last[0] = None  # named last by an empty row
    return last


def consistent(pairs: List[Dict], tol: float) -> List[torch.Tensor]:
    """Each pair's kept rows: matched, and with three frames or more, in
    agreement with the pair before or the pair after."""
    if len(pairs) < 2:
        return [p["matched"] for p in pairs]
    keeps = []
    for t, p in enumerate(pairs):
        dev, dtype = p["vel"].device, p["vel"].dtype
        tol2 = torch.tensor(tol, dtype=dtype, device=dev) ** 2
        k = p["matched"].shape[0]
        agree = torch.zeros(k, dtype=torch.bool, device=dev)
        if t > 0:
            before = pairs[t - 1]
            named = p["names"]
            dv = p["vel"] - before["vel"][named]
            agree |= (before["matched"][named]
                      & (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] <= tol2))
        if t < len(pairs) - 1:
            after = pairs[t + 1]
            last = _named_last_by(after, k)
            row = torch.tensor([w or 0 for w in last], dtype=torch.int64,
                               device=dev)
            has = torch.tensor([w is not None for w in last],
                               dtype=torch.bool, device=dev)
            dv = p["vel"] - after["vel"][row]
            agree |= (has & after["matched"][row]
                      & (dv[:, 0] * dv[:, 0] + dv[:, 1] * dv[:, 1] <= tol2))
        keeps.append(p["matched"] & agree)
    return keeps


def flow_field(frames: List[Dict], pairs: List[Dict],
               keeps: List[torch.Tensor], fc: Dict) -> Dict:
    """The tracked flow on the last frame's lattice, its statistics and
    its bottlenecks; ``vectors`` and ``positions`` of the occupied nodes
    in y-major order."""
    last = frames[-1]
    dev, dtype = last["xy"].device, last["xy"].dtype
    g = torch.tensor(fc["grid_size"], dtype=dtype, device=dev)
    x0, y0 = last["mins"][0], last["mins"][1]
    nx = max(1, int(torch.ceil((last["maxs"][0] + g - x0) / g)))
    ny = max(1, int(torch.ceil((last["maxs"][1] + g - y0) / g)))
    wsum = torch.zeros((nx, ny, 2), dtype=dtype, device=dev)
    cnt = torch.zeros((nx, ny), dtype=torch.int64, device=dev)
    offs = torch.arange(-2, 3, device=dev)
    for t, (p, keep) in enumerate(zip(pairs, keeps)):
        rows = torch.nonzero(keep).flatten()
        pos, vel = frames[t + 1]["xy"][rows], p["vel"][rows]
        # candidate nodes: 5 x 5 around each sample's lattice cell
        ci = torch.floor((pos[:, 0] - x0) / g).long()
        cj = torch.floor((pos[:, 1] - y0) / g).long()
        i = (ci[:, None, None] + offs[None, :, None]).expand(-1, 5, 5)
        j = (cj[:, None, None] + offs[None, None, :]).expand(-1, 5, 5)
        s = torch.arange(len(rows), device=dev)[:, None, None].expand(
            -1, 5, 5)
        i, j, s = i.reshape(-1), j.reshape(-1), s.reshape(-1)
        inside = (i >= 0) & (i < nx) & (j >= 0) & (j < ny)
        i, j, s = i[inside], j[inside], s[inside]
        dx = (x0 + i.to(dtype) * g) - pos[s, 0]
        dy = (y0 + j.to(dtype) * g) - pos[s, 1]
        near = dx * dx + dy * dy <= g * g
        i, j, s = i[near], j[near], s[near]
        flat = i * ny + j
        wsum.view(-1, 2).index_add_(0, flat, vel[s])
        cnt.view(-1).index_add_(0, flat, torch.ones_like(flat))
    occupied = cnt > 0
    vectors = torch.where(occupied[..., None],
                          wsum / cnt.clamp_min(1)[..., None].to(dtype),
                          torch.zeros_like(wsum))
    mags = torch.sqrt(vectors[..., 0] * vectors[..., 0]
                      + vectors[..., 1] * vectors[..., 1])
    n_occ = int(occupied.sum())
    if n_occ:
        avg_speed = float(mags[occupied].double().mean())
        mean = vectors[occupied].double().mean(0)
        angle = math.atan2(float(mean[1]), float(mean[0])) * 180 / math.pi
        dominant = DIRECTIONS[int((angle + 22.5) % 360 / 45)]
    else:
        avg_speed, dominant = 0.0, "N/A"

    # bottlenecks on the lattice, y-major: (ny, nx) arrays
    span = int(math.ceil(fc["mono_box_halfwidth"] / fc["grid_size"])) - 1
    m_yx = torch.where(occupied, mags, torch.zeros_like(mags)).T
    box = torch.nn.functional.max_pool2d(
        m_yx[None, None], 2 * span + 1, stride=1, padding=span)[0, 0]
    occ_yx = occupied.T
    sev = torch.floor(10 * (box - m_yx) / box.clamp_min(1e-12)).clamp_max(10)
    ok = (occ_yx & (m_yx < fc["mono_slow_speed"])
          & (box > fc["mono_fast_speed"]) & (sev >= fc["mono_min_severity"]))
    flat_ok = torch.nonzero(ok.reshape(-1)).flatten()
    order = torch.sort(sev.reshape(-1)[flat_ok], descending=True,
                       stable=True).indices
    top = flat_ok[order][:fc["max_bottlenecks"]]
    x0d, y0d, gd = float(x0), float(y0), float(g)
    bottlenecks = [{"x": x0d + (int(f) % nx) * gd,
                    "y": y0d + (int(f) // nx) * gd,
                    "severity": int(sev.reshape(-1)[f])} for f in top]
    jj, ii = torch.nonzero(occ_yx, as_tuple=True)  # y-major
    positions = torch.stack([x0 + ii.to(dtype) * g, y0 + jj.to(dtype) * g],
                            1)
    return {"avg_speed": avg_speed, "dominant_direction": dominant,
            "bottlenecks": bottlenecks,
            "vectors": vectors[ii, jj].double().cpu().numpy(),
            "positions": positions.double().cpu().numpy(),
            "origin": (x0d, y0d), "grid_size": fc["grid_size"]}


def analyze_sequence(frames: Sequence[np.ndarray], dt: float,
                     settings: Dict, dtype=torch.float64,
                     device="cpu") -> Dict:
    """The tracked analysis of float32 frames (n, 3) in time order: the
    last frame's people, density and recommendations with the tracked
    flow, each frame's person-like centroids (``tracked``), and the
    clustered points of every frame (``clustered``)."""
    from crowdbench.recommend import recommendations

    pc, dc, fc = settings["preprocess"], settings["density"], settings["flow"]
    if (pc["variant"], dc["mode"], fc["variant"]) != (
            "monolith", "radius", "monolith"):
        raise ValueError("the reference covers the monolith analysis only")
    if len(frames) < 2:
        raise ValueError("tracking needs two frames or more")
    per = [frame_clusters(f, settings, dtype, device) for f in frames]
    pairs = [track_pair(a, b, dt, fc) for a, b in zip(per, per[1:])]
    keeps = consistent(pairs, fc["track_consistency_tol"])
    fres = flow_field(per, pairs, keeps, fc)
    last = per[-1]
    people = last["xy"]
    mins, maxs = last["mins"], last["maxs"]
    dres = plain.density(people, mins[0], maxs[0], mins[1], maxs[1], dc)
    return {"n_people": int(people.shape[0]),
            "centroids": people.double().cpu().numpy(),
            "tracked": [f["xy"][f["person"]].double().cpu().numpy()
                        for f in per],
            "clustered": sum(f["clustered"] for f in per),
            "density": dres, "flow": fres,
            "recommendations": recommendations(dres, fres,
                                               settings["recommend"]),
            "rules": settings["recommend"]}
