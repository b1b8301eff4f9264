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
``BRUTEFORCE_HARD_CAP``), and the dispatch to the column-grid backend
above that (``ops/ccl.py``). The eps-adjacency is kept as compressed
rows of edges (``ops/cuda/eps.py::eps_edges``): at the monolith's eps =
0.3 m a point has a handful of neighbours, so a sweep over the edge list
touches far less memory than a dense adjacency.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops import ccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.columns import (
    INT_MAX, dense_ids)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.eps import (
    eps_edges)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.place import (
    place_dense)
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
    count, stage)

# Largest clustering buffer the all-pairs backend takes for the monolith
# variant; above it the column-grid connected components take over, as in
# the JAX package.
BRUTEFORCE_MAX_POINTS = 32768

# Largest buffer of the modular variant, whose eps = 0.5 sigma in
# standardised space admits no spatial decomposition (the same ceiling as
# the JAX package's).
BRUTEFORCE_HARD_CAP = 131072

# Above this many rows (the clustering's padded point buffer) the centroids
# pack their segment ends with ``place_dense``, the JAX package's switch.
SEGSUM_MAX_POINTS = 2_097_152


def _neighbour_min(labels: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor) -> torch.Tensor:
    """For every point, the smallest label over its edges (INT_MAX when
    it has none). Min is order-free, so the scatter is deterministic."""
    out = torch.full_like(labels, INT_MAX)
    return out.scatter_reduce_(0, rows, labels[cols], reduce="amin")


def _dbscan_edges(offsets: torch.Tensor, cols: torch.Tensor,
                  mask: torch.Tensor, min_samples: int, max_iters: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``dbscan_bruteforce`` on the eps-adjacency ``eps_edges`` built."""
    n = mask.shape[0]
    dev = mask.device
    counts = offsets.diff()
    core = mask & (counts >= min_samples)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    # expanded on the device: the edge count is known, so no read
    rows = torch.repeat_interleave(idx, counts, output_size=cols.shape[0])

    # Every edge serves both the propagation and the border labels: a
    # point that is not core keeps INT_MAX through the sweeps, so its edges
    # add nothing to a core point's minimum, and a row that is not core
    # takes its minimum over its core neighbours alone.
    labels = torch.where(core, idx, INT_MAX)
    for _ in range(max_iters):
        nbr_min = _neighbour_min(labels, rows, cols)
        new = torch.where(core, torch.minimum(labels, nbr_min), labels)
        for _ in range(2):  # pointer jumping
            hop = new[new.clamp(0, n - 1)]
            new = torch.where(core, torch.minimum(new, hop), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    border_min = _neighbour_min(labels, rows, cols)
    labels = torch.where(mask & ~core & (border_min != INT_MAX), border_min,
                         labels)
    labels = torch.where(labels == INT_MAX, -1, labels)
    dense, n_clusters = dense_ids(labels)
    return dense, n_clusters, torch.zeros((), dtype=torch.int32, device=dev)


def dbscan_bruteforce(points: torch.Tensor, mask: torch.Tensor, eps: float,
                      min_samples: int, max_iters: int = 40
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact DBSCAN-equivalent clustering of padded ``points`` (N, D).

    Returns (labels (N,) int32, n_clusters () int32, overflow () int32 =
    0). The sweeps are the JAX package's: at most ``max_iters`` Jacobi
    min-label sweeps, each followed by two pointer-jumping rounds, ending
    at the first sweep that changes nothing."""
    return _dbscan_edges(*eps_edges(points, mask, eps), mask, min_samples,
                         max_iters)


def dbscan_labels(points: torch.Tensor, mask: torch.Tensor, eps: float,
                  min_samples: int, ncx: int = 128, ncy: int = 128,
                  column_cap: int = 64, max_iters: int = 40,
                  brute_cap: int = BRUTEFORCE_MAX_POINTS
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster padded ``points`` (N, D): (labels (N,) int32 with -1 noise,
    n_clusters () int32, overflow () int32 = points dropped by a full
    column; 0 means the result is exact).

    Buffers of up to ``max(brute_cap, BRUTEFORCE_MAX_POINTS)`` points take
    the all-pairs backend (the modular variant passes
    ``BRUTEFORCE_HARD_CAP``: its eps is macroscopic in standardised space,
    where columns degenerate); larger ones the column-grid backend
    (``ccl.dbscan_gs``) on a ``ncx`` x ``ncy`` grid of ``column_cap``
    slots, on every device. Runs in a ``preprocess.cluster`` span, whose
    ``host_reads`` a tracing session counts; on the all-pairs backend the
    span's ``edges`` is the size of the eps-adjacency and its counter
    ``preprocess.eps_kernel`` is 1 where the ``eps_edges`` kernel built it
    and 0 where the plain version did."""
    with stage("preprocess.cluster") as attrs:
        if points.shape[0] <= max(brute_cap, BRUTEFORCE_MAX_POINTS):
            offsets, cols = eps_edges(points, mask, eps)
            attrs["edges"] = cols.shape[0]
            count("preprocess.eps_kernel", int(points.device.type == "cuda"))
            return _dbscan_edges(offsets, cols, mask, min_samples, max_iters)
        return ccl.dbscan_gs(points, mask, eps, min_samples, ncx=ncx,
                             ncy=ncy, column_cap=column_cap,
                             max_iters=max_iters)


def _sorted_prefix(points: torch.Tensor, seg: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows sorted stably by segment id: (seg_s (N,), inclusive float64
    prefix sums of the sorted coordinates, (D, N))."""
    order = torch.sort(seg, stable=True).indices
    # (D, N) layout: PyTorch's scan along dim 0 of an (N, D) tensor runs
    # only D columns in parallel on CUDA (5 ms at N = 40,960).
    cols = points[order].T.to(torch.float64).contiguous()
    return seg[order], torch.cumsum(cols, 1)


def _segment_end_rows(points: torch.Tensor, seg: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``_centroids_sorted`` hands to ``place_dense``: (sorted segment
    ids (N,) int32, the mask of each segment's end row among segments
    < k, channels (2 D + 1, N) float32: the inclusive float64 prefix of the
    sorted coordinates split into hi then lo float32 parts, and the row
    count up to each row)."""
    n = points.shape[0]
    seg_s, prefix = _sorted_prefix(points, seg)
    hi = prefix.to(torch.float32)
    lo = (prefix - hi.to(torch.float64)).to(torch.float32)
    cnt = torch.arange(1, n + 1, dtype=torch.float32, device=points.device)
    is_end = torch.ones(n, dtype=torch.bool, device=points.device)
    is_end[:-1] = seg_s[1:] != seg_s[:-1]
    return (seg_s.to(torch.int32), is_end & (seg_s < k),
            torch.cat([hi, lo, cnt[None]]))


def _centroids_sorted(points: torch.Tensor, seg: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment sums and counts by sort, prefix and a dense pack: (sums
    (K, D) float32, counts (K,) float32); slots past the last cluster are
    exactly 0.

    The route of the JAX package's ``_centroids_sorted``. Cluster ids are
    dense, so after the sort segment j's end row holds the inclusive prefix
    up to and including it, and a segment's sum is the difference of two
    adjacent dense slots once the end rows are packed by ``place_dense``.
    The prefix is summed in float64 and split into a (hi, lo) float32 pair,
    where the JAX package scans such pairs; the count channel rides float32,
    exact below 2^24 rows."""
    d = points.shape[1]
    placed, occ = place_dense(*_segment_end_rows(points, seg, k), k)
    real = occ[:k] > 0.5
    placed = placed[:, :k]
    diff = placed - torch.nn.functional.pad(placed[:, :-1], (1, 0))
    sums = torch.where(real, diff[:d] + diff[d:2 * d], 0.0)
    cnts = torch.where(real, diff[2 * d], 0.0)
    return sums.T, cnts


def cluster_centroids(points: torch.Tensor, labels: torch.Tensor,
                      max_clusters: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-cluster centroids (segment means): (centroids (K, D) float32,
    valid (K,), overflow () int32 = clusters whose id is >= K and were
    dropped).

    Deterministic on every device: a stable sort by cluster id, a float64
    prefix sum, and differences at the segment ends; no float atomics.
    Counts are exact integers. Buffers of more than ``SEGSUM_MAX_POINTS``
    rows (and fewer than 2^24) pack the segment ends with ``place_dense``
    (``_centroids_sorted``), as the JAX package does; the others read them
    by index."""
    k = max_clusters
    n = points.shape[0]
    seg = torch.where(labels >= 0, labels.to(torch.int64), k).clamp_max(k)
    if SEGSUM_MAX_POINTS < n < (1 << 24):
        sums, cnts = _centroids_sorted(points, seg, k)
        valid = cnts > 0
        cents = sums / cnts.clamp_min(1.0)[:, None]
    else:
        _, prefix = _sorted_prefix(points, seg)
        prefix = torch.nn.functional.pad(prefix, (1, 0))
        cnts = torch.bincount(seg, minlength=k + 1)[:k]
        end = torch.cumsum(cnts, 0)
        sums = (prefix[:, end] - prefix[:, end - cnts]).T
        valid = cnts > 0
        cents = (sums / cnts.clamp_min(1)[:, None].to(torch.float64)).to(
            points.dtype)
    # ids are dense 0..C-1, so the clusters past K number max_id + 1 - K
    overflow = (labels.max().clamp_min(-1) + 1 - k).clamp_min(0)
    return cents, valid, overflow.to(torch.int32)
