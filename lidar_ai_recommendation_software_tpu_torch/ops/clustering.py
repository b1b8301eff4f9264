"""DBSCAN-equivalent person clustering and cluster centroids.

The same clusters as the JAX package's ``ops/clustering.py``: core points
have at least ``min_samples`` eps-neighbours (self included, sklearn's
rule); clusters are the connected components of the core-core
eps-adjacency, found by min-label propagation with pointer jumping; border
points take the smallest label among their core neighbours; the rest is
noise (-1). Labels are dense ids 0..n_clusters-1 ordered by each
cluster's smallest point index.

This module holds the all-pairs backend, which serves clustering buffers
of up to ``BRUTEFORCE_MAX_POINTS`` points (and the modular variant up to
``BRUTEFORCE_HARD_CAP``). The eps-adjacency is kept as a list of edges:
at the monolith's eps = 0.3 m a point has a handful of neighbours, so a
sweep over the edge list touches far less memory than a dense adjacency.
"""

from __future__ import annotations

from typing import Tuple

import torch

INT_MAX = 2 ** 31 - 1

# Largest clustering buffer the all-pairs backend takes for the monolith
# variant; above it the JAX package switches to the column-grid
# connected-components kernels, which the port does not have yet.
BRUTEFORCE_MAX_POINTS = 32768

# Largest buffer of the modular variant, whose eps = 0.5 sigma in
# standardised space admits no spatial decomposition (the same ceiling as
# the JAX package's).
BRUTEFORCE_HARD_CAP = 131072

# Pair tests per chunk of the all-pairs distance pass (bounds the
# temporaries at a few hundred MB).
_PAIRS_PER_CHUNK = 1 << 24


def _eps_edges(points: torch.Tensor, mask: torch.Tensor, eps: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ordered pairs (i, j) of valid points with squared distance
    <= eps^2, self pairs included. Returns (rows, cols) int64, sorted by
    row.

    The squared distance is summed axis by axis as the JAX package sums
    it, and eps^2 is rounded the same way (squared in float32), so
    pairs at exactly eps fall on the same side in both."""
    n, d = points.shape
    e = torch.tensor(eps, dtype=points.dtype, device=points.device)
    r2 = e * e
    chunk = max(1, _PAIRS_PER_CHUNK // max(n, 1))
    rows, cols = [], []
    for s in range(0, n, chunk):
        q = points[s:s + chunk]
        diff = q[:, None, 0] - points[None, :, 0]
        d2 = diff * diff
        for k in range(1, d):
            diff = q[:, None, k] - points[None, :, k]
            d2 = d2 + diff * diff
        hit = (d2 <= r2) & mask[None, :] & mask[s:s + chunk, None]
        r, c = hit.nonzero(as_tuple=True)
        rows.append(r + s)
        cols.append(c)
    return torch.cat(rows), torch.cat(cols)


def _neighbour_min(labels: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """For every point, the smallest label over its edges (INT_MAX when
    it has none). Min is order-free, so the scatter is deterministic."""
    out = torch.full_like(labels, INT_MAX)
    return out.scatter_reduce_(0, rows, labels[cols], reduce="amin")


def dbscan_bruteforce(points: torch.Tensor, mask: torch.Tensor, eps: float,
                      min_samples: int, max_iters: int = 40
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact DBSCAN-equivalent clustering of padded ``points`` (N, D).

    Returns (labels (N,) int32, n_clusters () int32, overflow () int32 =
    0). The sweeps are the JAX package's: at most ``max_iters`` Jacobi
    min-label sweeps, each followed by two pointer-jumping rounds, ending
    at the first sweep that changes nothing."""
    n = points.shape[0]
    dev = points.device
    rows, cols = _eps_edges(points, mask, eps)
    counts = torch.bincount(rows, minlength=n)
    core = mask & (counts >= min_samples)
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    # Core-core edges carry the propagation; core-to-border edges label
    # the border points once at the end.
    to_core = core[cols]
    cc = to_core & core[rows]
    cc_rows, cc_cols = rows[cc], cols[cc]
    bd = to_core & ~core[rows]
    bd_rows, bd_cols = rows[bd], cols[bd]

    labels = torch.where(core, idx, INT_MAX)
    for _ in range(max_iters):
        nbr_min = _neighbour_min(labels, cc_rows, cc_cols)
        new = torch.where(core, torch.minimum(labels, nbr_min), labels)
        for _ in range(2):  # pointer jumping
            hop = new[new.clamp(0, n - 1)]
            new = torch.where(core, torch.minimum(new, hop), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    border_min = _neighbour_min(labels, bd_rows, bd_cols)
    labels = torch.where(mask & ~core & (border_min != INT_MAX), border_min,
                         labels)
    labels = torch.where(labels == INT_MAX, -1, labels)

    is_rep = (labels == idx) & core
    dense_minus1 = torch.cumsum(is_rep.to(torch.int64), 0) - 1
    dense = torch.where(labels >= 0, dense_minus1[labels.clamp(0, n - 1)],
                        -1)
    return (dense.to(torch.int32), is_rep.sum(dtype=torch.int32),
            torch.zeros((), dtype=torch.int32, device=dev))


def dbscan_labels(points: torch.Tensor, mask: torch.Tensor, eps: float,
                  min_samples: int, max_iters: int = 40,
                  brute_cap: int = BRUTEFORCE_MAX_POINTS
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster padded ``points`` (N, D): (labels (N,) int32 with -1 noise,
    n_clusters () int32, overflow () int32).

    ``brute_cap`` raises the all-pairs ceiling; the modular variant passes
    ``BRUTEFORCE_HARD_CAP``. A larger monolith buffer needs the
    venue-scale column-grid clustering, which is not ported yet."""
    if points.shape[0] <= max(brute_cap, BRUTEFORCE_MAX_POINTS):
        return dbscan_bruteforce(points, mask, eps, min_samples,
                                 max_iters=max_iters)
    raise NotImplementedError(
        f"a clustering buffer of {points.shape[0]} points needs the "
        f"venue-scale column-grid clustering (ROADMAP queue 1, item 4: "
        f"venue-scale clustering), which the PyTorch port does not have "
        f"yet; it clusters buffers of up to {BRUTEFORCE_MAX_POINTS} points "
        f"(clouds of up to 40,960 points)")


def cluster_centroids(points: torch.Tensor, labels: torch.Tensor,
                      max_clusters: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cluster centroids (segment means): (centroids (K, D) float32,
    valid (K,), overflow () int32 = clusters whose id is >= K and were
    dropped).

    Deterministic on every device: a stable sort by cluster id, a float64
    prefix sum, and differences at the segment ends; no float atomics.
    Counts are exact integers."""
    k = max_clusters
    seg = torch.where(labels >= 0, labels.to(torch.int64), k).clamp_max(k)
    order = torch.sort(seg, stable=True).indices
    cnts = torch.bincount(seg, minlength=k + 1)[:k]
    # (D, N) layout: PyTorch's scan along dim 0 of an (N, D) tensor runs
    # only D columns in parallel on CUDA (5 ms at N = 40,960).
    cols = points[order].T.to(torch.float64).contiguous()
    prefix = torch.nn.functional.pad(torch.cumsum(cols, 1), (1, 0))
    end = torch.cumsum(cnts, 0)
    sums = (prefix[:, end] - prefix[:, end - cnts]).T
    valid = cnts > 0
    cents = (sums / cnts.clamp_min(1)[:, None].to(torch.float64)).to(
        points.dtype)
    # ids are dense 0..C-1, so the clusters past K number max_id + 1 - K
    overflow = (labels.max().clamp_min(-1) + 1 - k).clamp_min(0)
    return cents, valid, overflow.to(torch.int32)
