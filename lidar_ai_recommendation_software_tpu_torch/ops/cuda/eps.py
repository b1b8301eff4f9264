"""``eps_edges``: the eps-adjacency of a clustering buffer as compressed
rows. Launch plan, wrapper and plain PyTorch version.

The JAX package has no kernel for it: its ``ops/clustering.py::
dbscan_bruteforce`` builds a packed-bitmask adjacency with tiled jnp. The
kernel is ``csrc/eps_edges.cu``; ``ops/clustering.py`` clusters the
all-pairs buffers (up to 32,768 points, 131,072 in the modular variant)
on its edges.

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, PAIRS_PER_CHUNK, _check, _cuda_device, _raise_on, _stream,
    load_library)

# The layout of csrc/eps_edges.cu, which the plan mirrors (its entry points
# refuse a grid that does not cover the points):
EPS_THREADS = 128
EPS_ROWS_PER_THREAD = 4          # query points a thread holds
EPS_ROW_TILE = EPS_THREADS * EPS_ROWS_PER_THREAD
EPS_COL_TILE = EPS_THREADS       # columns staged a tile, one a thread
# blocks the plan aims at: slices of one column tile while the grid stays
# under it, longer slices above
EPS_TARGET_BLOCKS = 4096
# launches of one call with at least one edge: the count and the fill
EPS_LAUNCHES = 2
# the largest D the kernel takes (a missing axis reads 0 on both ends)
EPS_MAX_DIM = 3


@dataclasses.dataclass(frozen=True)
class EpsPlan:
    """How ``csrc/eps_edges.cu`` covers N points: block (x, y) tests rows
    [x * EPS_ROW_TILE, (x + 1) * EPS_ROW_TILE) against column tiles
    [y * tiles_per_slice, (y + 1) * tiles_per_slice) of EPS_COL_TILE
    columns each, both cut at N. ``grid[1]`` is the number of slices,
    the second axis of the per-(row, slice) counts."""

    tiles_per_slice: int
    grid: tuple


def eps_plan(n: int) -> EpsPlan:
    """The launch plan for ``n`` points, by the shape alone: one block per
    row tile and slice, the slices one column tile long unless that makes
    more than ``EPS_TARGET_BLOCKS`` blocks."""
    row_tiles = -(-n // EPS_ROW_TILE)
    col_tiles = -(-n // EPS_COL_TILE)
    per_slice = max(1, -(-row_tiles * col_tiles // EPS_TARGET_BLOCKS))
    return EpsPlan(per_slice, (row_tiles, -(-col_tiles // per_slice)))


def eps_sq(eps: float) -> np.float32:
    """eps^2 as the clustering rounds it: float32(eps) squared in
    float32. (``radius_count`` squares in float64 and rounds once; the two
    differ at eps = 0.35.)"""
    e = np.float32(eps)
    return np.float32(e * e)


def eps_edges_reference(points: torch.Tensor, mask: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``eps_edges``, in chunks of about
    ``PAIRS_PER_CHUNK`` pair tests, each compacted with ``nonzero``.

    The squared distance is summed axis by axis as the JAX package sums
    it, and eps^2 is rounded the same way (squared in the points' dtype),
    so pairs at exactly eps fall on the same side in both."""
    n, d = points.shape
    e = torch.tensor(eps, dtype=points.dtype, device=points.device)
    r2 = e * e
    chunk = max(1, PAIRS_PER_CHUNK // max(n, 1))
    rows = [torch.zeros(0, dtype=torch.int64, device=points.device)]
    cols = [rows[0]]
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
    counts = torch.bincount(torch.cat(rows), minlength=n)
    offsets = torch.nn.functional.pad(torch.cumsum(counts, 0), (1, 0))
    return offsets, torch.cat(cols).to(torch.int32)


def _launch_args(points: torch.Tensor, mask: torch.Tensor, eps: float,
                 plan: EpsPlan) -> tuple:
    n, d = points.shape
    return (points.data_ptr(), mask.data_ptr(), d, float(eps_sq(eps)), n,
            plan.tiles_per_slice, *plan.grid)


def _count_pass(points: torch.Tensor, mask: torch.Tensor, eps: float,
                plan: EpsPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The count launch and the prefix over its counts: ((N, slices) int32
    counts, their inclusive int64 prefix in rows-major order, flat)."""
    dev = points.device
    n = points.shape[0]
    with torch.cuda.device(dev):
        counts = torch.empty((n, plan.grid[1]), dtype=torch.int32,
                             device=dev)
        err = load_library().eps_count_launch(
            *_launch_args(points, mask, eps, plan), counts.data_ptr(),
            _stream(dev))
        _raise_on(err, "eps_edges count")
        LAUNCHES["eps_edges"] += 1
        return counts, torch.cumsum(counts.view(-1), 0, dtype=torch.int64)


def _fill_pass(points: torch.Tensor, mask: torch.Tensor, eps: float,
               plan: EpsPlan, counts: torch.Tensor, ends: torch.Tensor,
               total: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fill launch into ``total`` columns, and the rows' offsets read
    off the prefix: ((N + 1,) int64, (total,) int32)."""
    dev = points.device
    n = points.shape[0]
    with torch.cuda.device(dev):
        cols = torch.empty(total, dtype=torch.int32, device=dev)
        if total:
            err = load_library().eps_fill_launch(
                *_launch_args(points, mask, eps, plan), counts.data_ptr(),
                ends.data_ptr(), cols.data_ptr(), _stream(dev))
            _raise_on(err, "eps_edges fill")
            LAUNCHES["eps_edges"] += 1
        row_ends = ends.view(n, plan.grid[1])[:, -1]
        return torch.nn.functional.pad(row_ends, (1, 0)), cols


def eps_edges(points: torch.Tensor, mask: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All ordered pairs (i, j) of valid points with squared distance at
    most float32(eps)^2, self pairs included, as compressed rows: (offsets
    (N + 1,) int64, cols (E,) int32), row i's columns ascending at
    ``cols[offsets[i]:offsets[i + 1]]``.

    points (N, D) float32, mask (N,) bool. CPU tensors take the plain
    version; CUDA tensors take ``csrc/eps_edges.cu`` by ``eps_plan(N)``
    (D of 1 to 3): the count launch, a prefix over its counts, one read
    of the host (the total, which sizes the columns), the fill launch."""
    if points.device.type == "cpu":
        return eps_edges_reference(points, mask, eps)
    dev = _cuda_device(points, "eps_edges")
    n, d = points.shape
    if not 1 <= d <= EPS_MAX_DIM:
        raise ValueError(f"eps_edges takes 1 to {EPS_MAX_DIM} axes, got {d}")
    _check("points", points, torch.float32, (n, d), dev)
    _check("mask", mask, torch.bool, (n,), dev)
    if n == 0:
        return (torch.zeros(1, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    plan = eps_plan(n)
    counts, ends = _count_pass(points, mask, eps, plan)
    total = int(ends[-1])  # the one read of the host
    return _fill_pass(points, mask, eps, plan, counts, ends, total)
