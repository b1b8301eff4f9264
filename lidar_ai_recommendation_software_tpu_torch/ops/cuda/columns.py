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
minimum) are (N,) arrays in stream order.

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); each launch adds one to ``LAUNCHES``. The plain
versions work over the occupied slots only, in chunks, and compute the
same squared distances the kernels do (``dx = neighbour - centre``,
``(dx*dx + dy*dy) + dz*dz``, each operation rounded on its own).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, PAIRS_PER_CHUNK, _check, _cuda_device, _raise_on, _stream,
    load_library)

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
                            py: int, cap: int, eps: float) -> torch.Tensor:
    """Plain version of ``column_counts``."""
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


def column_counts(table: torch.Tensor, stream_slot: torch.Tensor, py: int,
                  cap: int, eps: float) -> torch.Tensor:
    """Per stream position, the number of points within ``eps`` over the
    3x3 neighbouring columns, self included: (N,) int32, 0 where the point
    has no slot."""
    if table.device.type == "cpu":
        return column_counts_reference(table, stream_slot, py, cap, eps)
    dev, n = _neighbour_args("column_counts", table, stream_slot)
    fn = load_library().column_counts_launch
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        err = fn(table.data_ptr(), stream_slot.data_ptr(), n, py, cap,
                 float(eps_sq(eps)), out.data_ptr(), _stream(dev))
        LAUNCHES["column_counts"] += 1
    _raise_on(err, "column_counts")
    return out


def border_min_reference(table: torch.Tensor, stream_slot: torch.Tensor,
                         py: int, cap: int, eps: float, labels: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of ``border_min``."""
    out = torch.full((stream_slot.shape[0],), INT_MAX, dtype=torch.int32,
                     device=table.device)
    for ks, nk, hit in _neighbour_chunks(table, stream_slot, py, cap, eps):
        out[ks] = torch.where(hit, labels[nk], INT_MAX).amin(1)
    return out


def border_min(table: torch.Tensor, stream_slot: torch.Tensor, py: int,
               cap: int, eps: float, labels: torch.Tensor) -> torch.Tensor:
    """Per stream position, the smallest of ``labels`` (N,) int32 (stream
    order) over its eps-neighbours, self included: (N,) int32, INT_MAX
    where the point has no slot. With labels INT_MAX at non-core points, a
    border point's value is its smallest adjacent core label."""
    if table.device.type == "cpu":
        return border_min_reference(table, stream_slot, py, cap, eps, labels)
    dev, n = _neighbour_args("border_min", table, stream_slot, labels)
    fn = load_library().border_min_launch
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.int32, device=dev)
        err = fn(table.data_ptr(), stream_slot.data_ptr(), n, py, cap,
                 float(eps_sq(eps)), labels.data_ptr(), out.data_ptr(),
                 _stream(dev))
        LAUNCHES["border_min"] += 1
    _raise_on(err, "border_min")
    return out


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
    sweep that changes nothing. The same fixpoint as the kernel's in-place
    sweeps; the number of sweeps may differ."""
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


def propagate(table: torch.Tensor, stream_slot: torch.Tensor,
              point_stream: torch.Tensor, py: int, cap: int, eps: float,
              labels: torch.Tensor, max_sweeps: int) -> int:
    """Min-label propagation over the core-core eps adjacency, IN PLACE
    on ``labels`` (N,) int32 in stream order (a core point's index,
    INT_MAX elsewhere), to the fixpoint where every core point holds the
    smallest point index of its component. One launch per sweep; returns
    the number of sweeps run, the last of which changed nothing. Raises
    if ``max_sweeps`` sweeps do not reach the fixpoint."""
    if table.device.type == "cpu":
        return propagate_reference(table, stream_slot, point_stream, py,
                                   cap, eps, labels, max_sweeps)
    dev, n = _neighbour_args("propagate", table, stream_slot, labels)
    _check("point_stream", point_stream, torch.int32, (n,), dev)
    fn = load_library().propagate_launch
    r2 = float(eps_sq(eps))
    with torch.cuda.device(dev):
        changed = torch.zeros((), dtype=torch.int32, device=dev)
        for sweep in range(1, max_sweeps + 1):
            changed.zero_()
            err = fn(table.data_ptr(), stream_slot.data_ptr(),
                     point_stream.data_ptr(), n, py, cap, r2,
                     labels.data_ptr(), changed.data_ptr(), _stream(dev))
            LAUNCHES["propagate"] += 1
            _raise_on(err, "propagate")
            if int(changed) == 0:  # one host read per sweep
                return sweep
    raise _not_converged(max_sweeps)
