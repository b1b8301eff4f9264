"""Venue-scale DBSCAN-equivalent clustering: connected components over a
column table, carried by the five kernels of ``ops/cuda/columns.py``.

The counterpart of the JAX package's ``ops/ccl.py`` (``dbscan_gs``), and
the same clusters as its ``ops/clustering.py`` (``dbscan_columns``):

  1. points are packed into a table of xy columns whose edge is at least
     eps (``build_table``: one stable sort by column id, each column's
     first stream position by a binary search, the fill kernel), so every
     eps-neighbour of a point lies in the 3x3 columns around it;
  2. core points have at least ``min_samples`` eps-neighbours, self
     included (the count kernel, which, like the border-min kernel, reads
     each column's occupancy from ``cell_start``);
  3. every core point takes the smallest point index of its core-core
     eps component (the propagation: one union-find pass on the card,
     sweeps to the fixpoint on the CPU);
  4. border points take the smallest adjacent core label (the border-min
     kernel); the rest is noise;
  5. labels return to point order (the gather kernel) and become dense ids
     ranked by each cluster's smallest point index, as the all-pairs
     ``dbscan_bruteforce`` numbers them.

Steps 2-4 keep one value per point in stream order. Points past a
column's capacity are dropped and counted in the returned overflow; the
pipeline then doubles the capacities and re-runs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import columns
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.columns import (
    INT_MAX)

# Propagation sweeps allowed per unit of the configs' ``max_cc_iters``: the
# JAX package's budget, whose iteration is two orientations of 4
# Gauss-Seidel passes each. Only the CPU's sweeps read it; the card's
# union-find always reaches the fixpoint.
SWEEPS_PER_CC_ITER = 8


@dataclasses.dataclass
class ColumnTable:
    """The packed table, its stream and maps (layout:
    ``ops/cuda/columns.py``)."""

    table: torch.Tensor         # (S, 4) float32: x, y, z, stream position
    order: torch.Tensor         # (N,) int32 point at each stream position
    point_stream: torch.Tensor  # (N,) int32 stream position of each point
    stream_slot: torch.Tensor   # (N,) int32 slot of each stream position
    cell_start: torch.Tensor    # (ncells + 1,) int32 each column's first
    #                             stream position
    py: int                     # columns along y, borders included
    cap: int                    # slots per column
    overflow: torch.Tensor      # () int32 valid points dropped by the cap


def cell_ids(points: torch.Tensor, mask: torch.Tensor, min_cell: float,
             ncx: int, ncy: int) -> torch.Tensor:
    """Each point's padded column id (cx + 1) * (ncy + 2) + (cy + 1), and
    (ncx + 2) * (ncy + 2) for masked points; int32.

    The cell edge is max(min_cell, extent / (n - 1e-3)) over both axes,
    with every division by a device tensor, so it rounds once as in the
    JAX package (PyTorch multiplies by the reciprocal when the divisor is
    a Python float on CUDA)."""
    dt, dev = points.dtype, points.device
    big = torch.finfo(dt).max
    pmin = torch.where(mask[:, None], points[:, :2], big).amin(0)
    pmax = torch.where(mask[:, None], points[:, :2], -big).amax(0)

    def t(v):
        return torch.tensor(v, dtype=dt, device=dev)

    cell = torch.maximum(t(min_cell), torch.maximum(
        (pmax[0] - pmin[0]) / t(ncx - 1e-3),
        (pmax[1] - pmin[1]) / t(ncy - 1e-3)))
    cx = torch.floor((points[:, 0] - pmin[0]) / cell).to(torch.int32)
    cy = torch.floor((points[:, 1] - pmin[1]) / cell).to(torch.int32)
    py = ncy + 2
    cid = (cx.clamp(0, ncx - 1) + 1) * py + (cy.clamp(0, ncy - 1) + 1)
    return torch.where(mask, cid, (ncx + 2) * py)


def sorted_stream(points: torch.Tensor, mask: torch.Tensor,
                  min_cell: float, ncx: int, ncy: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cell-sorted point stream the fill kernel takes: (order (N,),
    the point at each stream position; scid (N,), its column id;
    cell_start ((ncx + 2) * (ncy + 2) + 1,), each column's first stream
    position), all int32. The sort is stable, so a column's points keep
    index order and a full column keeps its lowest indices, as the JAX
    package's sort does."""
    ncells = (ncx + 2) * (ncy + 2)
    scid, order = torch.sort(cell_ids(points, mask, min_cell, ncx, ncy),
                             stable=True)
    cell_start = torch.searchsorted(
        scid, torch.arange(ncells + 1, dtype=scid.dtype,
                           device=scid.device), out_int32=True)
    return order.to(torch.int32), scid, cell_start


def build_table(points: torch.Tensor, mask: torch.Tensor, min_cell: float,
                ncx: int, ncy: int, cap: int) -> ColumnTable:
    """Pack padded ``points`` (N, 3) into the column table: the sorted
    stream, then the fill kernel."""
    py = ncy + 2
    ncells = (ncx + 2) * py
    if ncells * cap >= 2 ** 31:
        raise ValueError(
            f"a column table of {ncx + 2} x {py} columns x {cap} slots has "
            f"{ncells * cap} slots, past the int32 slot index")
    order, scid, cell_start = sorted_stream(points, mask, min_cell, ncx, ncy)
    table, point_stream, stream_slot, overflow = columns.table_fill(
        points.contiguous(), order, scid, cell_start, ncells, cap)
    return ColumnTable(table=table, order=order, point_stream=point_stream,
                       stream_slot=stream_slot, cell_start=cell_start, py=py,
                       cap=cap, overflow=overflow)


def dense_ids(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels holding each cluster's smallest point index (-1 noise) ->
    (dense ids 0..C-1 ranked by that index, -1 noise; int32, C () int32).
    A cluster's representative is the one point whose label is its own
    index."""
    n = labels.shape[0]
    idx = torch.arange(n, dtype=labels.dtype, device=labels.device)
    is_rep = labels == idx
    dense_minus1 = torch.cumsum(is_rep.to(torch.int64), 0) - 1
    dense = torch.where(labels >= 0,
                        dense_minus1[labels.clamp(0, max(n - 1, 0))
                                     .to(torch.int64)], -1)
    return dense.to(torch.int32), is_rep.sum(dtype=torch.int32)


def dbscan_gs(points: torch.Tensor, mask: torch.Tensor, eps: float,
              min_samples: int, ncx: int, ncy: int, column_cap: int,
              max_iters: int = 40
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DBSCAN-equivalent clustering of padded ``points`` (N, 3) on a
    ``ncx`` x ``ncy`` column grid of ``column_cap`` slots: (dense labels
    (N,) int32 with -1 noise, n_clusters () int32, overflow () int32).
    On the CPU the propagation may take ``max_iters * SWEEPS_PER_CC_ITER``
    sweeps and raises if they do not reach its fixpoint; on the card it is
    one union-find pass with no read back to the host."""
    t = build_table(points, mask, eps, ncx, ncy, column_cap)
    nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
    counts = columns.column_counts(*nb)
    core = (t.stream_slot >= 0) & (counts >= min_samples)
    labels = torch.where(core, t.order, INT_MAX)
    columns.propagate(t.table, t.stream_slot, t.point_stream, t.py, t.cap,
                      eps, labels, max_iters * SWEEPS_PER_CC_ITER)
    # non-core points take their smallest core neighbour's label, if any
    labels = torch.where(core, labels, columns.border_min(*nb, labels))
    lab = columns.table_gather(labels, t.point_stream, INT_MAX)
    dense, n_clusters = dense_ids(torch.where(lab == INT_MAX, -1, lab))
    return dense, n_clusters, t.overflow
