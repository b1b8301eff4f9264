"""Ball-query grouping for set-abstraction layers.

``ball_group``: for M query centroids over N source points, up to K
neighbour indices within radius r, the PointNet++ grouping primitive. The
dense backend is ported: a chunked (M_chunk, N) masked distance pass and a
top-k that selects the first K hits in scan order, exact, for sources of up
to ``BRUTEFORCE_MAX_SOURCE`` points. The JAX package's second backend, the
voxel hash grid for larger sources (``ops/hashgrid.py``), is not ported
yet: asking for it raises ``NotImplementedError`` (ROADMAP.md, queue 1,
item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Above this source count the JAX package switches to the hash grid.
BRUTEFORCE_MAX_SOURCE = 262_144

INT_MIN = -2 ** 31


def ball_group(queries: torch.Tensor, qmask: torch.Tensor,
               points: torch.Tensor, pmask: torch.Tensor, radius: float,
               k: int, chunk: int = 512, method: str = "auto"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (idx (M, K) int32, valid (M, K) bool).

    The first K source points within ``radius`` of each query, in index
    order. Slots beyond the neighbour count repeat the first neighbour
    (the usual PointNet++ padding, so pooled features are unaffected);
    a query that is masked or has no neighbour returns index 0 and
    valid False everywhere. ``method``: "auto" or "dense"; "hashgrid", and
    "auto" above ``BRUTEFORCE_MAX_SOURCE`` source points, raise
    ``NotImplementedError``."""
    if method not in ("auto", "dense", "hashgrid"):
        raise ValueError(f"unknown ball_group method {method!r}")
    m, n = queries.shape[0], points.shape[0]
    if method == "hashgrid" or (method == "auto"
                                and n > BRUTEFORCE_MAX_SOURCE):
        raise NotImplementedError(
            "the hash-grid ball query (ops/hashgrid.py of the JAX package) "
            "is not ported yet: ROADMAP.md, queue 1, item 10. Pass "
            "method='dense' for an exact all-pairs query")
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
