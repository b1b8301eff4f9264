"""The five column-table kernels of the venue-scale clustering: wrappers
and plain PyTorch versions.

The counterparts of the JAX package's ``ops/pallas/fill.py``
(``fill_planes``, ``extract_stream``) and ``ops/ccl.py``
(``column_counts_planes``, ``border_min_planes``, ``gs_passes``). The
kernels are ``csrc/column_table.cu`` and ``csrc/column_neighbours.cu``;
``ops/ccl.py`` composes them into ``dbscan_gs``.

The stream: the points sorted stably by column id (``order`` (N,), the
point at each stream position; ``scid``, its column id, ``ncells`` for a
masked point; ``cell_start`` (ncells + 1,), the stream position of each
column's first point).

The table: ``ncells = (ncx + 2) * py`` columns (``py = ncy + 2``: one empty
border column on each side), each ``cap`` slots in a row, so slot ``s``
lies in column ``s // cap``. A slot is four float32 lanes, x, y, z and the
stream position as int32 bits; empty slots hold ``EMPTY_COORD`` and -1. A
column's occupied slots are a prefix. Two maps tie the stream to the
table: ``stream_slot`` (the slot of each stream position) and
``point_stream`` (the stream position of each point), -1 where a point has
no slot (masked, or past its column's cap).

Per-point values of the neighbourhood kernels (counts, labels, border
minimum) are (N,) arrays in stream order. The count and the border
minimum scan a tile of columns a block, by ``neighbour_plan``; they read a
column's occupancy from ``cell_start`` and its slots from the table.

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); each launch adds one to ``LAUNCHES``. The plain
versions work over the occupied slots only, in chunks, and compute the
same squared distances the kernels do (``dx = neighbour - centre``,
``(dx*dx + dy*dy) + dz*dz``, each operation rounded on its own).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, PAIRS_PER_CHUNK, SMEM_PER_BLOCK, _check, _cuda_device,
    _raise_on, _stream, load_library)

EMPTY_COORD = 1.0e18   # (1e18)^2 is finite in float32 and always > r^2
INT_MAX = 2 ** 31 - 1

# Candidate slots per chunk of a plain version: each carries a 16-byte slot
# and four float32 temporaries, twice the bytes of an all-pairs test.
_CANDIDATES_PER_CHUNK = PAIRS_PER_CHUNK // 2


def eps_sq(eps: float) -> np.float32:
    """float32(eps) squared in float32, as the JAX package's ccl kernels
    square it (``jnp.asarray([eps], f32) ** 2``). Not the float64 rounding
    of ``kernels._radius_sq``: at eps = 0.35 the two differ by an ulp."""
    e = np.float32(eps)
    return e * e


def slot_stream_pos(table: torch.Tensor) -> torch.Tensor:
    """(S,) int32 stream position held by each slot, -1 where empty."""
    return table.view(torch.int32)[:, 3]


# ---------------------------------------------------------------------------
# table_fill: cell-sorted stream -> table
# ---------------------------------------------------------------------------

def table_fill_reference(points: torch.Tensor, order: torch.Tensor,
                         scid: torch.Tensor, cell_start: torch.Tensor,
                         ncells: int, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Plain version of ``table_fill``."""
    n = points.shape[0]
    dev = points.device
    k = torch.arange(n, dtype=torch.int32, device=dev)
    valid = scid < ncells
    rank = k - cell_start[scid.clamp_max(ncells).to(torch.int64)]
    placed = valid & (rank < cap)
    stream_slot = torch.where(placed, scid * cap + rank, -1).to(torch.int32)
    point_stream = torch.empty(n, dtype=torch.int32, device=dev)
    point_stream[order.to(torch.int64)] = torch.where(placed, k, -1)
    table = torch.full((ncells * cap, 4), EMPTY_COORD, dtype=torch.float32,
                       device=dev)
    slot_stream_pos(table).fill_(-1)
    p = stream_slot[placed].to(torch.int64)
    table[p, :3] = points[order[placed].to(torch.int64)]
    slot_stream_pos(table)[p] = k[placed]
    overflow = (valid & ~placed).sum(dtype=torch.int32)
    return table, point_stream, stream_slot, overflow


def table_fill(points: torch.Tensor, order: torch.Tensor,
               scid: torch.Tensor, cell_start: torch.Tensor, ncells: int,
               cap: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Build the column table from the cell-sorted point stream.

    points (N, 3) float32 in point order; order, scid (N,) int32 and
    cell_start (ncells + 1,) int32, the stream. Returns (table
    (ncells * cap, 4) float32, point_stream (N,) int32, stream_slot (N,)
    int32, overflow () int32 = valid points at rank >= cap, which are not
    placed). The kernel writes every slot, empty ones included."""
    if points.device.type == "cpu":
        return table_fill_reference(points, order, scid, cell_start, ncells,
                                    cap)
    dev = _cuda_device(points, "table_fill")
    n = points.shape[0]
    _check("points", points, torch.float32, (n, 3), dev)
    for name, t in (("order", order), ("scid", scid)):
        _check(name, t, torch.int32, (n,), dev)
    _check("cell_start", cell_start, torch.int32, (ncells + 1,), dev)
    fn = load_library().table_fill_launch
    with torch.cuda.device(dev):
        table = torch.empty((ncells * cap, 4), dtype=torch.float32,
                            device=dev)
        point_stream = torch.empty(n, dtype=torch.int32, device=dev)
        stream_slot = torch.empty(n, dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
        err = fn(points.data_ptr(), order.data_ptr(), scid.data_ptr(),
                 cell_start.data_ptr(), n, ncells, cap, table.data_ptr(),
                 point_stream.data_ptr(), stream_slot.data_ptr(),
                 overflow.data_ptr(), _stream(dev))
        LAUNCHES["table_fill"] += 1
    _raise_on(err, "table_fill")
    return table, point_stream, stream_slot, overflow


# ---------------------------------------------------------------------------
# table_gather: stream-order values -> point order
# ---------------------------------------------------------------------------

def table_gather_reference(values: torch.Tensor, point_stream: torch.Tensor,
                           fill: int) -> torch.Tensor:
    """Plain version of ``table_gather``."""
    got = values[point_stream.clamp_min(0).to(torch.int64)]
    return torch.where(point_stream >= 0, got, fill).to(torch.int32)


def table_gather(values: torch.Tensor, point_stream: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """Read the table's per-point values, (N,) int32 in stream order, back
    into point order: (N,) int32, ``fill`` for points with no slot
    (masked or dropped)."""
    if values.device.type == "cpu":
        return table_gather_reference(values, point_stream, fill)
    dev = _cuda_device(values, "table_gather")
    n = point_stream.shape[0]
    _check("values", values, torch.int32, (n,), dev)
    _check("point_stream", point_stream, torch.int32, (n,), dev)
    fn = load_library().table_gather_launch
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        err = fn(values.data_ptr(), point_stream.data_ptr(), n, int(fill),
                 out.data_ptr(), _stream(dev))
        LAUNCHES["table_gather"] += 1
    _raise_on(err, "table_gather")
    return out


# ---------------------------------------------------------------------------
# eps-neighbourhoods: core counts, border minimum, propagation
# ---------------------------------------------------------------------------

def _neighbour_chunks(table: torch.Tensor, stream_slot: torch.Tensor,
                      py: int, cap: int, eps: float):
    """For chunks of placed stream positions: (their positions (M,), the
    stream positions of the slots in their 3x3 columns (M, 9 * cap), 0
    where empty, hit (M, 9 * cap) = occupied and within eps)."""
    dev = table.device
    centres = torch.nonzero(stream_slot >= 0).flatten()
    r2 = torch.tensor(eps_sq(eps), device=dev)
    offs = torch.tensor([(dx * py + dy) * cap + j for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for j in range(cap)],
                        dtype=torch.int64, device=dev)
    spos = slot_stream_pos(table)
    chunk = max(1, _CANDIDATES_PER_CHUNK // offs.numel())
    for s in range(0, centres.numel(), chunk):
        ks = centres[s:s + chunk]
        pos = stream_slot[ks].to(torch.int64)
        cand = (pos // cap * cap)[:, None] + offs[None, :]
        c = table[pos]
        q = table[cand]
        ex = q[..., 0] - c[:, None, 0]
        ey = q[..., 1] - c[:, None, 1]
        ez = q[..., 2] - c[:, None, 2]
        d2 = ex * ex + ey * ey
        d2 = d2 + ez * ez
        nk = spos[cand]
        yield ks, nk.clamp_min(0).to(torch.int64), (d2 <= r2) & (nk >= 0)


def column_counts_reference(table: torch.Tensor, stream_slot: torch.Tensor,
                            cell_start: torch.Tensor, py: int, cap: int,
                            eps: float) -> torch.Tensor:
    """Plain version of ``column_counts``. It finds the placed points and
    their neighbours from ``stream_slot`` and the table, and does not read
    ``cell_start``."""
    out = torch.zeros(stream_slot.shape[0], dtype=torch.int32,
                      device=table.device)
    for ks, _, hit in _neighbour_chunks(table, stream_slot, py, cap, eps):
        out[ks] = hit.sum(1, dtype=torch.int32)
    return out


def _neighbour_args(name, table, stream_slot, labels=None):
    dev = _cuda_device(table, name)
    s, n = table.shape[0], stream_slot.shape[0]
    _check("table", table, torch.float32, (s, 4), dev)
    _check("stream_slot", stream_slot, torch.int32, (n,), dev)
    if labels is not None:
        _check("labels", labels, torch.int32, (n,), dev)
    return dev, n


# The layout of the count and border-minimum scan in
# csrc/column_neighbours.cu, whose entry points derive the same plan from
# the shapes (and refuse a cap whose window cannot fit shared memory):
NEIGHBOUR_THREADS = 256
NEIGHBOUR_TILE_COLS = 256     # centre columns a block takes along y
NEIGHBOUR_WINDOW = 1024       # the least slots a block's window holds
# int32 words a block keeps beside the window: cell_start of the three
# rows and two prefix sums, each over the tile's staged columns and the end
# of the last, the prefix sums' warp totals, the masked tail's start
NEIGHBOUR_BLOCK_WORDS = 5 * (NEIGHBOUR_TILE_COLS + 3) + 2 * (
    NEIGHBOUR_THREADS // 32) + 1
NEIGHBOUR_SLOT_BYTES = 18     # a window slot's 16 bytes, a centre's column 2


@dataclasses.dataclass(frozen=True)
class NeighbourPlan:
    """How the scan covers a grid of ``ncx`` x ``ncy`` columns: block b
    takes padded x row ``1 + b // tiles_per_row`` and its columns of padded
    y ``1 + t * NEIGHBOUR_TILE_COLS`` up to ``NEIGHBOUR_TILE_COLS`` of them
    (``t = b % tiles_per_row``; fewer at the row's end), and stages the
    occupied slots of the three rows around it over those columns and one
    more on each side, as many sub-tiles of at most ``window`` slots as
    they need, in ``smem_bytes`` of shared memory."""

    tiles_per_row: int
    blocks: int
    window: int
    smem_bytes: int


def neighbour_plan(ncx: int, ncy: int, cap: int, n: int) -> NeighbourPlan:
    """The scan's launch plan as the kernel's entry points derive it, from
    the shapes alone: ``ncx`` x ``ncy`` interior columns of ``cap`` slots,
    ``n`` stream positions. No stream
    (``n`` 0): no block. Raises ValueError where the cap is too large for
    one column's nine neighbouring columns to fit a block's shared
    memory."""
    window = max(NEIGHBOUR_WINDOW, 9 * cap)
    smem = window * NEIGHBOUR_SLOT_BYTES + 4 * NEIGHBOUR_BLOCK_WORDS
    if smem > SMEM_PER_BLOCK:
        raise ValueError(
            f"a column cap of {cap} needs a window of {window} slots, "
            f"{smem} bytes of shared memory, past the {SMEM_PER_BLOCK} a "
            f"block may use")
    tiles = -(-ncy // NEIGHBOUR_TILE_COLS)
    return NeighbourPlan(tiles, ncx * tiles if n > 0 else 0, window, smem)


def _scan(name: str, table: torch.Tensor, stream_slot: torch.Tensor,
          cell_start: torch.Tensor, py: int, cap: int, eps: float,
          labels: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the scan of ``csrc/column_neighbours.cu`` as ``name``
    (``column_counts`` or ``border_min``)."""
    dev, n = _neighbour_args(name, table, stream_slot, labels)
    ncells = cell_start.shape[0] - 1
    _check("cell_start", cell_start, torch.int32, (ncells + 1,), dev)
    if ncells % py or table.shape[0] != ncells * cap:
        raise ValueError(
            f"cell_start's {ncells} columns and the table's "
            f"{table.shape[0]} slots are not a grid of rows of {py} columns "
            f"of {cap} slots")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 slots)")
    ncx = ncells // py - 2
    plan = neighbour_plan(ncx, py - 2, cap, n)
    fn = getattr(load_library(), f"{name}_launch")
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        err = fn(table.data_ptr(), cell_start.data_ptr(), n, ncx, py, cap,
                 float(eps_sq(eps)),
                 None if labels is None else labels.data_ptr(),
                 out.data_ptr(), _stream(dev))
        if plan.blocks:
            LAUNCHES[name] += 1
    _raise_on(err, name)
    return out


def column_counts(table: torch.Tensor, stream_slot: torch.Tensor,
                  cell_start: torch.Tensor, py: int, cap: int,
                  eps: float) -> torch.Tensor:
    """Per stream position, the number of points within ``eps`` over the
    3x3 neighbouring columns, self included: (N,) int32, 0 where the point
    has no slot. ``cell_start`` (ncells + 1,) int32: each column's first
    stream position."""
    if table.device.type == "cpu":
        return column_counts_reference(table, stream_slot, cell_start, py,
                                       cap, eps)
    return _scan("column_counts", table, stream_slot, cell_start, py, cap,
                 eps, None)


def border_min_reference(table: torch.Tensor, stream_slot: torch.Tensor,
                         cell_start: torch.Tensor, py: int, cap: int,
                         eps: float, labels: torch.Tensor) -> torch.Tensor:
    """Plain version of ``border_min``; like ``column_counts_reference``,
    it does not read ``cell_start``."""
    out = torch.full((stream_slot.shape[0],), INT_MAX, dtype=torch.int32,
                     device=table.device)
    for ks, nk, hit in _neighbour_chunks(table, stream_slot, py, cap, eps):
        out[ks] = torch.where(hit, labels[nk], INT_MAX).amin(1)
    return out


def border_min(table: torch.Tensor, stream_slot: torch.Tensor,
               cell_start: torch.Tensor, py: int, cap: int, eps: float,
               labels: torch.Tensor) -> torch.Tensor:
    """Per stream position, the smallest of ``labels`` (N,) int32 (stream
    order) over its eps-neighbours, self included: (N,) int32, INT_MAX
    where the point has no slot. With labels INT_MAX at non-core points, a
    border point's value is its smallest adjacent core label."""
    if table.device.type == "cpu":
        return border_min_reference(table, stream_slot, cell_start, py, cap,
                                    eps, labels)
    return _scan("border_min", table, stream_slot, cell_start, py, cap, eps,
                 labels)


def _not_converged(max_sweeps: int) -> RuntimeError:
    return RuntimeError(
        f"label propagation did not reach its fixpoint in {max_sweeps} "
        f"sweeps; the labels would be wrong")


def propagate_reference(table: torch.Tensor, stream_slot: torch.Tensor,
                        point_stream: torch.Tensor, py: int, cap: int,
                        eps: float, labels: torch.Tensor, max_sweeps: int
                        ) -> int:
    """Plain version of ``propagate``: Jacobi sweeps over the core-core
    eps edges, each followed by two pointer-jumping rounds, to the first
    sweep that changes nothing. The same fixpoint as the kernel's
    union-find."""
    rows, cols = [], []
    for ks, nk, hit in _neighbour_chunks(table, stream_slot, py, cap, eps):
        core = labels[ks] != INT_MAX
        hit = hit & core[:, None] & (labels[nk] != INT_MAX)
        r, c = hit.nonzero(as_tuple=True)
        rows.append(ks[r])
        cols.append(nk[r, c])
    if not rows:
        return 0
    rows, cols = torch.cat(rows), torch.cat(cols)
    core_k = torch.unique(rows)
    ps = point_stream.to(torch.int64)
    lab = labels.clone()
    for sweep in range(1, max_sweeps + 1):
        new = lab.scatter_reduce(0, rows, lab[cols], reduce="amin")
        for _ in range(2):  # pointer jumping
            cl = new[core_k]
            new[core_k] = torch.minimum(cl, new[ps[cl.to(torch.int64)]])
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            labels.copy_(lab)
            return sweep
    raise _not_converged(max_sweeps)


# kernels each propagation on the card launches: init, hook, compress
PROPAGATE_LAUNCHES = 3


def propagate(table: torch.Tensor, stream_slot: torch.Tensor,
              point_stream: torch.Tensor, py: int, cap: int, eps: float,
              labels: torch.Tensor, max_sweeps: int) -> int:
    """Min-label propagation over the core-core eps adjacency, IN PLACE
    on ``labels`` (N,) int32 in stream order (a core point's index,
    INT_MAX elsewhere), to the fixpoint where every core point holds the
    smallest point index of its component.

    On the card: one union-find pass (``csrc/column_neighbours.cu``),
    ``PROPAGATE_LAUNCHES`` launches on the current stream (none for an
    empty stream) and no read back to the host; it always reaches the
    fixpoint, so ``max_sweeps`` and ``point_stream`` are not read. Returns
    the launches made.
    On the CPU: ``propagate_reference``'s Jacobi sweeps; returns the
    number of sweeps run and raises if ``max_sweeps`` do not reach the
    fixpoint."""
    if table.device.type == "cpu":
        return propagate_reference(table, stream_slot, point_stream, py,
                                   cap, eps, labels, max_sweeps)
    dev, n = _neighbour_args("propagate", table, stream_slot, labels)
    fn = load_library().propagate_launch
    with torch.cuda.device(dev):
        parent = torch.empty(n, dtype=torch.int32, device=dev)
        err = fn(table.data_ptr(), stream_slot.data_ptr(), n, py, cap,
                 float(eps_sq(eps)), labels.data_ptr(), parent.data_ptr(),
                 _stream(dev))
        launched = PROPAGATE_LAUNCHES if n > 0 else 0
        LAUNCHES["propagate"] += launched
    _raise_on(err, "propagate")
    return launched
