"""Voxel hash-grid neighbour search: the ball query for sources too large
for the dense all-pairs pass.

The counterpart of the JAX package's ``ops/hashgrid.py``, in plain
PyTorch on any device. Points are bucketed into voxels of edge >= the
radius and stably sorted by voxel id once; a radius neighbourhood then lies
in the 3^d adjacent voxels, each a contiguous run of the sorted order found
by binary search. Every candidate slot is a fixed-size window of
``bucket_capacity`` sorted slots per adjacent voxel, so shapes depend on
the query count and the capacity only. Queries run in chunks to bound the
(chunk, 3^d, capacity) transient.

A voxel holding more than ``bucket_capacity`` points contributes only its
first ``bucket_capacity`` (in sorted order) as candidates, so
``ball_count`` and ``ball_query`` miss the rest. The JAX package does the
same, and the port mirrors it: ``ball_group``'s K-subset depends on it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import torch

INT_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class HashGrid:
    """Sorted voxel bucketing of a padded point set."""

    points: torch.Tensor         # (N, D) original points
    mask: torch.Tensor           # (N,) validity
    cell_size: torch.Tensor      # () voxel edge, the points' dtype
    origin: torch.Tensor         # (D,) grid origin (the valid points' min)
    dims: torch.Tensor           # (D,) int32 voxel counts per axis
    order: torch.Tensor          # (N,) int32 sorted point indices
    sorted_ids: torch.Tensor     # (N,) int32 voxel id per sorted slot
    #                              (invalid points INT_MAX)
    sorted_points: torch.Tensor  # (N, D) points in sorted order


def _cell_coords(points, origin, cell_size, dims):
    # divides by the device tensor cell_size (CUDA multiplies by a Python
    # float's reciprocal, which rounds differently)
    c = torch.floor((points - origin) / cell_size).to(torch.int32)
    return torch.minimum(torch.maximum(c, torch.zeros_like(dims)), dims - 1)


def _linear_id(coords, dims):
    lid = coords[..., 0]
    for a in range(1, coords.shape[-1]):
        lid = lid * dims[a] + coords[..., a]
    return lid


def build_grid(points: torch.Tensor, mask: torch.Tensor,
               cell_size: float) -> HashGrid:
    """Bucket padded/masked ``points`` (N, D) into voxels of edge
    ``cell_size``; voxel counts per axis from the valid points' bounding
    box."""
    big = torch.finfo(points.dtype).max
    pmin = torch.where(mask[:, None], points, big).amin(0)
    pmax = torch.where(mask[:, None], points, -big).amax(0)
    cs = torch.tensor(cell_size, dtype=points.dtype, device=points.device)
    dims = torch.clamp(torch.floor((pmax - pmin) / cs).to(torch.int32) + 1,
                       min=1)
    coords = _cell_coords(points, pmin, cs, dims)
    ids = torch.where(mask, _linear_id(coords, dims), INT_MAX)
    order = torch.argsort(ids, stable=True)
    return HashGrid(points=points, mask=mask, cell_size=cs, origin=pmin,
                    dims=dims, order=order.to(torch.int32),
                    sorted_ids=ids[order], sorted_points=points[order])


def _neighbor_offsets(d: int, device) -> torch.Tensor:
    """The 3^d voxel offsets in ``itertools.product`` order, (3^d, d)."""
    return torch.tensor(list(itertools.product((-1, 0, 1), repeat=d)),
                        dtype=torch.int32, device=device)


def _bucket_windows(grid: HashGrid, queries: torch.Tensor):
    """(start, end) sorted-order window per query per adjacent voxel: two
    (Q, 3^d) int64 tensors (empty for a voxel outside the grid)."""
    offs = _neighbor_offsets(queries.shape[-1], queries.device)
    qc = _cell_coords(queries, grid.origin, grid.cell_size, grid.dims)
    nc = qc[:, None, :] + offs[None, :, :]
    in_bounds = ((nc >= 0) & (nc < grid.dims)).all(-1)
    clipped = torch.minimum(torch.maximum(nc, torch.zeros_like(grid.dims)),
                            grid.dims - 1)
    nid = torch.where(in_bounds, _linear_id(clipped, grid.dims), INT_MAX - 1)
    starts = torch.searchsorted(grid.sorted_ids, nid)
    ends = torch.searchsorted(grid.sorted_ids, nid, right=True)
    return starts, torch.where(in_bounds, ends, starts)


def _candidates(grid: HashGrid, cq: torch.Tensor, cqm: torch.Tensor,
                radius: float, bucket_capacity: int):
    """Every candidate neighbour of a query chunk: (candidate indices
    (C, 3^d, cap) int32, hit (C, 3^d, cap) bool), where hit marks
    candidates within ``radius`` (inclusive) of a valid query."""
    n = grid.points.shape[0]
    starts, ends = _bucket_windows(grid, cq)
    slot = torch.arange(bucket_capacity, device=cq.device)
    pos = starts[:, :, None] + slot
    valid = pos < ends[:, :, None]
    pos_c = pos.clamp(0, n - 1)
    cand_idx = grid.order[pos_c]
    cand = grid.sorted_points[pos_c]
    # summed axis by axis, each operation rounded on its own, as XLA sums
    # the JAX package's last axis
    diff = cand[..., 0] - cq[:, None, None, 0]
    d2 = diff * diff
    for a in range(1, cq.shape[-1]):
        diff = cand[..., a] - cq[:, None, None, a]
        d2 = d2 + diff * diff
    r = torch.tensor(radius, dtype=cq.dtype, device=cq.device)
    return cand_idx, valid & (d2 <= r * r) & cqm[:, None, None]


def ball_count(grid: HashGrid, queries: torch.Tensor, qmask: torch.Tensor,
               radius: float, bucket_capacity: int = 32,
               chunk: int = 16384) -> torch.Tensor:
    """Points within ``radius`` (inclusive) of each query, (Q,) int32; a
    query that is itself a grid point counts itself. Exact while no
    adjacent voxel holds more than ``bucket_capacity`` points (the module
    docstring)."""
    out = [_candidates(grid, queries[s:s + chunk], qmask[s:s + chunk],
                       radius, bucket_capacity)[1].sum((1, 2),
                                                       dtype=torch.int32)
           for s in range(0, queries.shape[0], chunk)]
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=queries.device)
    return torch.cat(out)


def ball_query(grid: HashGrid, queries: torch.Tensor, qmask: torch.Tensor,
               radius: float, k: int, bucket_capacity: int = 32,
               chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to ``k`` neighbour indices within ``radius`` per query: (indices
    (Q, k) int32, valid (Q, k) bool), the first k hits in voxel-scan order
    (the 3^d offsets in ``itertools.product`` order, each voxel's points in
    stable sorted order); slots past the hits hold index 0."""
    idx_out, val_out = [], []
    for s in range(0, queries.shape[0], chunk):
        cand_idx, hit = _candidates(grid, queries[s:s + chunk],
                                    qmask[s:s + chunk], radius,
                                    bucket_capacity)
        c = hit.shape[0]
        flat_hit = hit.reshape(c, -1)
        rank = torch.cumsum(flat_hit.to(torch.int32), 1) - 1
        take = flat_hit & (rank < k)
        # every surplus hit goes to the spill slot k, the only column with
        # repeated targets, which is cut away
        dest = torch.where(take, rank, k).to(torch.int64)
        out_idx = torch.zeros((c, k + 1), dtype=torch.int32,
                              device=queries.device)
        out_idx.scatter_(1, dest, cand_idx.reshape(c, -1))
        out_val = torch.zeros((c, k + 1), dtype=torch.bool,
                              device=queries.device)
        out_val.scatter_(1, dest, take)
        idx_out.append(out_idx[:, :k])
        val_out.append(out_val[:, :k])
    if not idx_out:
        dev = queries.device
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0, k), dtype=torch.bool, device=dev))
    return torch.cat(idx_out), torch.cat(val_out)
