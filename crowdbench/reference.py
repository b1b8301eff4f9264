"""The plain reference: the reference application's monolith analysis
(app_simplified.py) written in plain PyTorch, in any dtype and on any
device.

It imports nothing of the program and takes nothing the program made. It
is given the points the program is given, as the configuration states
them (float32), and works out everything again: the 3-sigma inlier mask,
the ground split at the z percentile, DBSCAN, the centroids, the density
grid and its hotspots, the flow field and its bottlenecks, and the
recommendations. The numbers come from the configuration file's
``pipeline`` settings.

Semantics, where the application leaves a choice to a library:

  - DBSCAN is scikit-learn's: a point's neighbours (itself included) are
    the points with ``((0 + dx*dx) + dy*dy) + dz*dz <= eps*eps``; core
    points have at least ``min_samples``; clusters are the connected
    components of the core points; a border point joins the cluster with
    the lowest core index among its core neighbours. Candidates come from
    a grid of eps-wide cells, each point against the 3 x 3 cells around
    its own; components from min-label propagation with pointer jumping.
  - ``np.percentile`` is linear interpolation between order statistics.
  - ``KDTree.query_radius`` counts people with ``dx*dx + dy*dy <= r*r``.
  - The bottleneck box ``|dx| < 3, |dy| < 3`` is taken on the 1 m node
    lattice: offsets -2..2 in each direction.

Every step runs in ``dtype``: float64 for the reference, bfloat16 for the
control (``control.py``). Work is done in blocks so that a 1,000,000-point
scan fits beside nothing else on the card.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

DIRECTIONS = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x, q), linear."""
    xs = torch.sort(x).values
    pos = (x.shape[0] - 1) * (q / 100.0)
    lo, hi = math.floor(pos), math.ceil(pos)
    t = torch.tensor(pos - lo, dtype=x.dtype, device=x.device)
    a, b = xs[lo], xs[hi]
    return a + (b - a) * t


def _neighbour_pairs(p: torch.Tensor, eps: float, block: int = 1 << 22):
    """Every ordered pair (i, j) with squared distance <= eps^2, self
    pairs included, for the points ``p`` (n, 3): (i, j) int64."""
    dev = p.device
    n = p.shape[0]
    r2 = torch.tensor(eps, dtype=p.dtype, device=dev) ** 2
    xy = p[:, :2].double()
    lo = xy.min(0).values
    cell = torch.floor((xy - lo) / eps).long()
    ncy = int(cell[:, 1].max()) + 3
    key = (cell[:, 0] + 1) * ncy + (cell[:, 1] + 1)
    order = torch.argsort(key)
    skey = key[order]
    rows, cols = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            nkey = key + dx * ncy + dy
            start = torch.searchsorted(skey, nkey)
            cnt = torch.searchsorted(skey, nkey, right=True) - start
            csum = torch.cumsum(cnt, 0)
            first = 0
            while first < n:  # about ``block`` candidate pairs at a time
                done = int(csum[first - 1]) if first else 0
                last = int(torch.searchsorted(csum, done + block,
                                              right=True))
                last = min(n, max(last, first + 1))
                c = cnt[first:last]
                i = torch.repeat_interleave(
                    torch.arange(first, last, device=dev), c)
                k = (torch.arange(i.shape[0], device=dev)
                     - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
                j = order[start[i] + k]
                t = p[i] - p[j]
                d2 = t[:, 0] * t[:, 0]
                d2 = d2 + t[:, 1] * t[:, 1]
                d2 = d2 + t[:, 2] * t[:, 2]
                keep = d2 <= r2
                rows.append(i[keep])
                cols.append(j[keep])
                first = last
    return torch.cat(rows), torch.cat(cols)


def dbscan(p: torch.Tensor, eps: float, min_samples: int) -> torch.Tensor:
    """Cluster of each point as the index of its cluster's lowest core
    point, -1 for noise: (n,) int64."""
    n = p.shape[0]
    dev = p.device
    i, j = _neighbour_pairs(p, eps)
    count = torch.bincount(i, minlength=n)
    core = count >= min_samples
    idx = torch.arange(n, device=dev)
    both = core[i] & core[j] & (i != j)
    ei, ej = i[both], j[both]
    lab = torch.where(core, idx, n)
    while True:
        new = lab.scatter_reduce(0, ei, lab[ej], reduce="amin")
        while True:  # pointer jumping: a label is a core index <= itself
            jumped = new[new.clamp_max(n - 1)]
            jumped = torch.where(new < n, jumped, new)
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    # border points: the lowest root among their core neighbours
    to = core[j] & ~core[i]
    border = torch.full((n,), n, dtype=torch.int64, device=dev)
    border = border.scatter_reduce(0, i[to], lab[j[to]], reduce="amin")
    out = torch.where(core, lab, border)
    return torch.where(out < n, out, -1)


def centroids(p: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
    """Mean xy of each cluster, clusters in the order of their lowest core
    index: (k, 2) in ``p``'s dtype."""
    member = roots >= 0
    uniq, inv = torch.unique(roots[member], return_inverse=True)
    k = uniq.shape[0]
    sums = torch.zeros((k, 2), dtype=p.dtype, device=p.device)
    sums.index_add_(0, inv, p[member][:, :2])
    cnt = torch.bincount(inv, minlength=k).to(p.dtype)
    return sums / cnt[:, None]


def _arange_len(start, stop, step) -> int:
    """len(np.arange(start, stop, step)) for tensors of one dtype."""
    return max(0, int(torch.ceil((stop - start) / step)))


def density(people: torch.Tensor, x0, x1, y0, y1, dc: Dict,
            block_cells: int = 1024) -> Dict:
    """The monolith's radius count (app_simplified.py:244-281): people
    within ``radius`` of each cell centre over ``radius_area``; x-major
    (nx, ny) ``density_map``, hotspots in y-major scan order."""
    dt, dev = people.dtype, people.device
    g = torch.tensor(dc["grid_size"], dtype=dt, device=dev)
    n = people.shape[0]
    area = (x1 - x0) * (y1 - y0)
    avg = float(n / max(1.0, float(area)))
    if n == 0:
        return {"total_people": 0, "avg_density": avg, "max_density": 0.0,
                "density_map": np.zeros((1, 1)), "hotspots": [],
                "origin": (float(x0), float(y0)),
                "grid_size": dc["grid_size"]}
    nx = _arange_len(x0, x1 + g, g) - 1
    ny = _arange_len(y0, y1 + g, g) - 1
    xg = x0 + torch.arange(nx + 1, dtype=dt, device=dev) * g
    yg = y0 + torch.arange(ny + 1, dtype=dt, device=dev) * g
    cx = (xg[:-1] + xg[1:]) / 2
    cy = (yg[:-1] + yg[1:]) / 2
    r = torch.tensor(dc["radius"], dtype=dt, device=dev)
    r2 = r * r
    centres = torch.stack([cx[:, None].expand(nx, ny).reshape(-1),
                           cy[None, :].expand(nx, ny).reshape(-1)], 1)
    counts = torch.empty(nx * ny, dtype=torch.int64, device=dev)
    for s in range(0, nx * ny, block_cells):
        c = centres[s:s + block_cells]
        t = c[:, None, 0] - people[None, :, 0]
        d2 = t * t
        t = c[:, None, 1] - people[None, :, 1]
        d2 = d2 + t * t
        counts[s:s + block_cells] = (d2 <= r2).sum(1)
    grid = (counts.to(torch.float64) / dc["radius_area"]).reshape(nx, ny)
    max_density = float(grid.max())
    thresh = max(dc["hotspot_min_threshold"],
                 avg * dc["hotspot_avg_multiplier"])
    flat = grid.T.reshape(-1)  # y-major scan, as the application's loops
    hit = torch.nonzero(flat >= thresh).flatten()
    order = torch.sort(flat[hit], descending=True, stable=True).indices
    top = hit[order][:dc["max_hotspots"]]
    cxd, cyd = cx.double(), cy.double()
    hotspots = [{"x": float(cxd[int(f) % nx]), "y": float(cyd[int(f) // nx]),
                 "density": float(flat[f])} for f in top]
    return {"total_people": n, "avg_density": avg,
            "max_density": max_density,
            "density_map": grid.cpu().numpy(), "hotspots": hotspots,
            "origin": (float(x0), float(y0)),
            "grid_size": dc["grid_size"]}


def flow(x0, x1, y0, y1, fc: Dict) -> Dict:
    """The monolith's synthesised field and its bottlenecks
    (app_simplified.py:318-449); nodes in y-major order."""
    dt, dev = x0.dtype, x0.device
    g = torch.tensor(fc["grid_size"], dtype=dt, device=dev)
    nx = _arange_len(x0, x1 + g, g)
    ny = _arange_len(y0, y1 + g, g)
    px = (x0 + torch.arange(nx, dtype=dt, device=dev) * g)[None, :].expand(
        ny, nx)
    py = (y0 + torch.arange(ny, dtype=dt, device=dev) * g)[:, None].expand(
        ny, nx)
    dx = x1 - px
    dy = (y0 + y1) / 2 - py
    dist = torch.sqrt(dx * dx + dy * dy)
    nz = dist > 0
    safe = torch.where(nz, dist, torch.ones_like(dist))
    ux = torch.where(nz, dx / safe, torch.zeros_like(dx))
    uy = torch.where(nz, dy / safe, torch.zeros_like(dy))
    k = fc["swirl_complexity"]
    ang = torch.sin(px * k) * torch.cos(py * k) * fc["swirl_amplitude"]
    ca, sa = torch.cos(ang), torch.sin(ang)
    vx = torch.where(nz, ux * ca - uy * sa, torch.zeros_like(ux))
    vy = torch.where(nz, ux * sa + uy * ca, torch.zeros_like(uy))
    rng = np.random.RandomState(fc["random_seed"])
    br = fc["bottleneck_radius"]
    for _ in range(fc["bottleneck_count"]):
        u = torch.tensor(rng.uniform(size=2), dtype=dt, device=dev)
        bx = (x0 + 1) + ((x1 - 1) - (x0 + 1)) * u[0]
        by = (y0 + 1) + ((y1 - 1) - (y0 + 1)) * u[1]
        d = torch.sqrt((px - bx) ** 2 + (py - by) ** 2)
        damp = torch.where(d < br, d / br, torch.ones_like(d))
        vx, vy = vx * damp, vy * damp
    mags = torch.sqrt(vx * vx + vy * vy)
    mmax = mags.max()
    scale = (fc["monolith_max_speed"] / mmax if float(mmax) > 0
             else torch.ones_like(mmax))
    vx, vy = vx * scale, vy * scale
    mags = torch.sqrt(vx * vx + vy * vy)
    avg_speed = float(mags.double().mean())
    mx, my = float(vx.double().mean()), float(vy.double().mean())
    angle = math.atan2(my, mx) * 180 / math.pi
    dominant = DIRECTIONS[int((angle + 22.5) % 360 / 45)]

    # bottlenecks: slow nodes with a fast node in their 5 x 5 box
    span = int(math.ceil(fc["mono_box_halfwidth"] / fc["grid_size"])) - 1
    box = torch.nn.functional.max_pool2d(
        mags[None, None], 2 * span + 1, stride=1, padding=span)[0, 0]
    sev = torch.floor(10 * (box - mags) / box).clamp_max(10)
    ok = ((mags < fc["mono_slow_speed"]) & (box > fc["mono_fast_speed"])
          & (sev >= fc["mono_min_severity"]))
    flat_ok = torch.nonzero(ok.reshape(-1)).flatten()
    sev_f = sev.reshape(-1)[flat_ok]
    order = torch.sort(sev_f, descending=True, stable=True).indices
    top = flat_ok[order][:fc["max_bottlenecks"]]
    pxf, pyf = px.reshape(-1).double(), py.reshape(-1).double()
    sevf = sev.reshape(-1)
    bottlenecks = [{"x": float(pxf[t]), "y": float(pyf[t]),
                    "severity": int(sevf[t])} for t in top]
    return {"avg_speed": avg_speed, "dominant_direction": dominant,
            "bottlenecks": bottlenecks,
            "vectors": torch.stack([vx, vy], -1).reshape(-1, 2).double()
            .cpu().numpy(),
            "positions": torch.stack([px, py], -1).reshape(-1, 2).double()
            .cpu().numpy()}


def analyze(points: np.ndarray, settings: Dict, dtype=torch.float64,
            device="cpu") -> Dict:
    """The whole monolith analysis of one scan of float32 points (n, 3).
    Returns people (count, centroids), the clustered count (the
    non-ground inliers), density, flow and recommendations."""
    from crowdbench.recommend import recommendations

    pc, dc, fc = settings["preprocess"], settings["density"], settings["flow"]
    if (pc["variant"], dc["mode"], fc["scale_mode"], fc["variant"]) != (
            "monolith", "radius", "monolith", "monolith"):
        raise ValueError("the reference covers the monolith analysis only")
    p = torch.as_tensor(np.asarray(points, np.float32)).to(device, dtype)
    mean = p.mean(0)
    std = torch.sqrt(((p - mean) ** 2).mean(0))
    inlier = ((p - mean).abs() < pc["outlier_sigma"] * std).all(1)
    pts = p[inlier]
    z = pts[:, 2]
    ground = z <= _percentile(z, pc["ground_percentile"])
    ng = pts[~ground]
    if ng.shape[0] > pc["min_cluster_points"]:
        roots = dbscan(ng, pc["dbscan_eps"], pc["dbscan_min_samples"])
    else:
        roots = torch.zeros(ng.shape[0], dtype=torch.int64, device=p.device)
    people = centroids(ng, roots)
    mins, maxs = pts.min(0).values, pts.max(0).values
    x0, y0, x1, y1 = mins[0], mins[1], maxs[0], maxs[1]
    dres = density(people, x0, x1, y0, y1, dc)
    fres = (flow(x0, x1, y0, y1, fc) if people.shape[0] else
            {"avg_speed": 0.0, "dominant_direction": "N/A",
             "bottlenecks": [], "vectors": np.zeros((0, 2)),
             "positions": np.zeros((0, 2))})
    return {"n_people": int(people.shape[0]),
            "centroids": people.double().cpu().numpy(),
            "clustered": int(ng.shape[0]),
            "density": dres, "flow": fres,
            "recommendations": recommendations(dres, fres,
                                               settings["recommend"]),
            "rules": settings["recommend"]}
