"""Ball-query grouping for set-abstraction layers.

``ball_group``: for M query centroids over N source points, up to K
neighbour indices within radius r, the PointNet++ grouping primitive. Two
backends, picked by the source count as the JAX package picks them:

  - dense, up to ``BRUTEFORCE_MAX_SOURCE`` sources: a chunked (M_chunk, N)
    masked distance pass and a top-k that selects the first K hits in
    index order; exact.
  - hashgrid above it (``ops/hashgrid.py``): voxel bucketing and a scan of
    the 3^3 adjacent voxels. It selects the first K hits in voxel-scan
    order, another K-subset than the dense one when a neighbourhood holds
    more than K, and each adjacent voxel gives at most ``bucket_capacity``
    candidates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops import hashgrid

# Above this source count "auto" takes the hash grid.
BRUTEFORCE_MAX_SOURCE = 262_144

INT_MIN = -2 ** 31


def ball_group(queries: torch.Tensor, qmask: torch.Tensor,
               points: torch.Tensor, pmask: torch.Tensor, radius: float,
               k: int, chunk: int = 512, method: str = "auto",
               bucket_capacity: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (idx (M, K) int32, valid (M, K) bool).

    Up to K source points within ``radius`` of each query: the first K in
    index order (dense) or in voxel-scan order (hashgrid). Slots beyond
    the neighbour count repeat the first neighbour (the usual PointNet++
    padding, so pooled features are unaffected); a query that is masked or
    has no neighbour returns index 0 and valid False everywhere.
    ``method``: "auto" (dense up to ``BRUTEFORCE_MAX_SOURCE`` source
    points, hashgrid above), "dense" or "hashgrid"."""
    if method not in ("auto", "dense", "hashgrid"):
        raise ValueError(f"unknown ball_group method {method!r}")
    m, n = queries.shape[0], points.shape[0]
    if method == "hashgrid" or (method == "auto"
                                and n > BRUTEFORCE_MAX_SOURCE):
        grid = hashgrid.build_grid(points, pmask, cell_size=radius)
        idx, val = hashgrid.ball_query(grid, queries, qmask, radius, k,
                                       bucket_capacity=bucket_capacity)
        return torch.where(val, idx, idx[:, :1]), val
    # r^2 is float32(r) squared in float32, as the JAX package squares it
    # (a third rounding beside radius_count's and the column kernels')
    r = torch.tensor(radius, dtype=points.dtype, device=points.device)
    r2 = r * r
    cols = torch.arange(n, dtype=torch.int32, device=points.device)
    idx_out, val_out = [], []
    for s in range(0, m, chunk):
        q, qm = queries[s:s + chunk], qmask[s:s + chunk]
        # summed axis by axis, each operation rounded on its own
        diff = q[:, None, 0] - points[None, :, 0]
        d2 = diff * diff
        for a in range(1, points.shape[1]):
            diff = q[:, None, a] - points[None, :, a]
            d2 = d2 + diff * diff
        hit = (d2 <= r2) & pmask[None, :] & qm[:, None]
        # the K smallest hit columns: the scores of hits are distinct, so
        # top-k's order among equal scores never matters
        score = torch.where(hit, -cols[None, :], INT_MIN)
        vals = torch.topk(score, k, dim=1, sorted=True).values
        val = vals != INT_MIN
        idx = torch.where(val, -vals, 0)
        idx_out.append(torch.where(val, idx, idx[:, :1]))
        val_out.append(val)
    if not idx_out:
        dev = points.device
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.bool, device=dev))
    return torch.cat(idx_out), torch.cat(val_out)


def group_features(points: torch.Tensor, features: Optional[torch.Tensor],
                   centroids: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Grouped relative coordinates (and features) of an SA layer:
    (M, K, 3 [+ C]) with invalid slots zeroed."""
    gather = idx.to(torch.int64)
    rel = points[gather] - centroids[:, None, :]
    rel = torch.where(valid[..., None], rel, 0.0)
    if features is None:
        return rel
    feats = torch.where(valid[..., None], features[gather], 0.0)
    return torch.cat([rel, feats], dim=-1)
