"""Venue-scale DBSCAN with the venue cut into x-stripes, one a rank of an
``sp`` axis.

The counterpart of the JAX package's ``parallel/cluster.py``. Each rank
owns one x-stripe of the points and holds copies of the points within
eps of its edges (the halo), so the eps-ball of every owned point lies in
its buffer. A rank's step runs the column kernels of the single-card
clustering (``ops/ccl.py``) on its buffer:

    the column table of owned and halo points            (table_fill)
    the core test of the owned points                    (column_counts)
    the owners' verdicts for the halo copies             (one exchange)
    local components of the core points                  (propagate)
    one global label a component: its least global id
    rounds of boundary gather -> ppermute -> scatter-min
      until the psum of changes is 0
    border points: the least agreed label of a core      (border_min)
      eps-neighbour

A halo copy's own count is cut off at the buffer's edge, so its core flag
comes from its owner. Boundary slots are matched by index maps built on
the host (``boundary_maps``: both ranks of a boundary list its shared
points by global id), so the exchange is a gather and a scatter at fixed
indices. A component across k stripes agrees in at most k rounds.

The labels of owned points equal the single-card clustering's: every
core-core edge (p, q) lies in the buffer of p's owner (|pq| <= eps <=
halo), and the copies of a point are joined by the exchange.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.ops import ccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import columns
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.columns import (
    INT_MAX)
from lidar_ai_recommendation_software_tpu_torch.parallel.mesh import (
    Mesh, all_gather, ppermute, psum)


def _stripe_geometry(x: np.ndarray, n_shards: int
                     ) -> Tuple[float, float, np.ndarray]:
    """(lo, width, stripe_of) for equal-width x-stripes of the venue."""
    lo, hi = float(x.min()), float(x.max()) + 1e-6
    width = (hi - lo) / n_shards
    stripe_of = np.clip(((x - lo) / width).astype(np.int64), 0,
                        n_shards - 1)
    return lo, width, stripe_of


def partition_stripes(points: np.ndarray, n_shards: int, halo: float,
                      cap: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Host-side prep: split points into ``n_shards`` x-stripes of equal
    width, each padded buffer carrying its OWN points plus halo copies
    within ``halo`` of its stripe edges.

    Returns (buffers (S, CAP, 3), valid (S, CAP), owned (S, CAP),
    global_ids (S, CAP) int32). ``owned`` marks points whose stripe this
    is (each point owned exactly once); halo copies have owned=False.
    Buffer order is global-id-ascending own points, then global-id-
    ascending halo copies (boundary_maps relies on this being
    deterministic).
    """
    n = len(points)
    x = points[:, 0]
    lo, width, stripe_of = _stripe_geometry(x, n_shards)
    if width < halo:
        raise ValueError(
            f"stripe width {width:.3f} < halo {halo:.3f}: neighbor-only "
            "exchange would miss eps-balls spanning two boundaries — use "
            "fewer shards for this venue extent")

    members = []
    for s in range(n_shards):
        s_lo = lo + s * width
        s_hi = s_lo + width
        own = stripe_of == s
        in_halo = (~own) & (x >= s_lo - halo) & (x < s_hi + halo)
        ids = np.concatenate([np.nonzero(own)[0], np.nonzero(in_halo)[0]])
        members.append((ids, own[ids]))

    need = max(len(ids) for ids, _ in members)
    if cap <= 0:
        cap = max(128, 1 << int(np.ceil(np.log2(max(1, need)))))
    if need > cap:
        raise ValueError(f"stripe needs {need} slots > cap {cap}")

    bufs = np.zeros((n_shards, cap, 3), np.float32)
    valid = np.zeros((n_shards, cap), bool)
    owned = np.zeros((n_shards, cap), bool)
    gids = np.full((n_shards, cap), -1, np.int32)
    for s, (ids, own_flags) in enumerate(members):
        k = len(ids)
        bufs[s, :k] = points[ids]
        valid[s, :k] = True
        owned[s, :k] = own_flags
        gids[s, :k] = ids
    return bufs, valid, owned, gids


def boundary_maps(points: np.ndarray, n_shards: int, halo: float,
                  gids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, np.ndarray]:
    """Host-side matched slot maps for the boundary-zone exchange.

    For the boundary between stripes s and s+1 (at x_b), the SHARED set is
    every point with x in [x_b - halo, x_b + halo): by construction of
    ``partition_stripes`` each such point has a slot in BOTH shard s's
    buffer (own or halo copy) and shard s+1's. Sorting the shared set by
    global id gives positionally-aligned slot lists on both sides, so the
    on-device exchange is gather -> ppermute -> scatter with static
    indices.

    Returns (lmap, lval, rmap, rval), each (S, B): for shard s, ``rmap``
    indexes its slots for the boundary with s+1 (invalid on the last
    shard) and ``lmap`` for the boundary with s-1 (invalid on shard 0);
    shard s's rmap and shard s+1's lmap address the same points in the
    same order.
    """
    n_slots = gids.shape[1]
    x = points[:, 0]
    lo, width, _ = _stripe_geometry(x, n_shards)

    # gid -> slot per shard
    slot_of = np.full((n_shards, len(points)), -1, np.int64)
    for s in range(n_shards):
        live = gids[s] >= 0
        slot_of[s, gids[s, live]] = np.nonzero(live)[0]

    shared = []
    for b in range(n_shards - 1):
        x_b = lo + (b + 1) * width
        ids = np.nonzero((x >= x_b - halo) & (x < x_b + halo))[0]
        shared.append(ids)  # np.nonzero is ascending == gid-sorted

    bmax = max([1] + [len(s) for s in shared])
    lmap = np.full((n_shards, bmax), n_slots, np.int32)
    lval = np.zeros((n_shards, bmax), bool)
    rmap = np.full((n_shards, bmax), n_slots, np.int32)
    rval = np.zeros((n_shards, bmax), bool)
    for b, ids in enumerate(shared):
        k = len(ids)
        rs = slot_of[b, ids]
        ls = slot_of[b + 1, ids]
        assert (rs >= 0).all() and (ls >= 0).all(), \
            "shared boundary point missing from a shard buffer"
        rmap[b, :k] = rs
        rval[b, :k] = True
        lmap[b + 1, :k] = ls
        lval[b + 1, :k] = True
    return lmap, lval, rmap, rval


# the local propagation's budget on the CPU: the JAX package's 64
# iterations of its local components, in sweeps
LOCAL_SWEEPS = 64 * ccl.SWEEPS_PER_CC_ITER


def sharded_dbscan_labels(buf, valid, owned, gids, lmap, lval, rmap, rval,
                          eps: float, min_samples: int, mesh: Mesh,
                          axis: str, ncx: int, ncy: int, column_cap: int,
                          max_rounds: int = 32) -> Tuple[torch.Tensor, int]:
    """This rank's step of the sharded clustering, on its row of
    ``partition_stripes`` and ``boundary_maps`` (buf (CAP, 3), valid,
    owned, gids (CAP,), the maps (B,)) with a ``ncx`` x ``ncy`` column
    grid of ``column_cap`` slots.

    Returns (labels (CAP,) int32 on the mesh's device, overflow): owned
    slots hold the least global id of their cluster (or -1 for noise),
    halo and empty slots -1; overflow is the psum of the points the
    column tables dropped (nonzero: the labels are not exact, retry with a
    larger cap). Raises RuntimeError when ``max_rounds`` rounds of label
    agreement end with labels still changing (the JAX package stops
    there silently), and, on the CPU, when the local propagation does not
    reach its fixpoint in ``LOCAL_SWEEPS`` sweeps."""
    if max_rounds < 1:
        raise ValueError(f"max_rounds {max_rounds} < 1")
    dev = mesh.device
    pts = torch.as_tensor(buf, dtype=torch.float32, device=dev)
    val, own, lv, rv = (torch.as_tensor(a, dtype=torch.bool, device=dev)
                        for a in (valid, owned, lval, rval))
    gid, lm, rm = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                   for a in (gids, lmap, rmap))
    cap = pts.shape[0]
    n = mesh.shape[axis]
    right_perm = [(i, i + 1) for i in range(n - 1)]
    left_perm = [(i, i - 1) for i in range(1, n)]
    lm_safe = lm.clamp(0, cap - 1).to(torch.int64)
    rm_safe = rm.clamp(0, cap - 1).to(torch.int64)

    t = ccl.build_table(pts, val, eps, ncx, ncy, column_cap)
    nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
    order = t.order.to(torch.int64)
    placed = t.stream_slot >= 0

    def to_points(v_stream, fill):
        """Stream-order values in buffer order, ``fill`` off the table."""
        got = v_stream[t.point_stream.clamp_min(0).to(torch.int64)]
        return torch.where(t.point_stream >= 0, got, fill)

    def exchange(vals_pt, fill):
        """Boundary values both ways; returns what arrived, aligned with
        (lmap, rmap), ``fill`` where a map slot is unused."""
        send_r = torch.where(rv, vals_pt[rm_safe], fill)
        send_l = torch.where(lv, vals_pt[lm_safe], fill)
        from_left = ppermute(send_r, mesh, axis, right_perm)
        from_right = ppermute(send_l, mesh, axis, left_perm)
        return (torch.where(lv, from_left, fill),
                torch.where(rv, from_right, fill))

    # The core test of OWNED points (their eps-ball lies in this buffer);
    # halo copies take their owner's verdict.
    counts = columns.column_counts(*nb)
    core_own = to_points(placed & own[order] & (counts >= min_samples),
                         False)
    in_l, in_r = exchange(core_own.to(torch.int32), 0)
    core_ext = torch.cat([core_own.to(torch.int32),
                          torch.zeros(1, dtype=torch.int32, device=dev)])
    core_ext.scatter_reduce_(0, torch.where(lv, lm, cap).to(torch.int64),
                             in_l, "amax")
    core_ext.scatter_reduce_(0, torch.where(rv, rm, cap).to(torch.int64),
                             in_r, "amax")
    core_pt = core_ext[:cap] > 0
    core_s = placed & core_pt[order]

    # Local components: the propagation's labels are buffer indices (it
    # looks a label up as a point of this buffer), the least of each
    # component's.
    labels_s = torch.where(core_s, t.order, INT_MAX)
    columns.propagate(t.table, t.stream_slot, t.point_stream, t.py, t.cap,
                      eps, labels_s, LOCAL_SWEEPS)
    lab_pt = to_points(labels_s, INT_MAX)

    # One global label a component, its least global id; component ``cap``
    # takes the non-core slots.
    slot = torch.arange(cap, dtype=torch.int32, device=dev)
    is_rep = core_pt & (lab_pt == slot)
    dense_minus1 = torch.cumsum(is_rep.to(torch.int32), 0) - 1
    comp_of_pt = torch.where(
        core_pt, dense_minus1[lab_pt.clamp(0, cap - 1).to(torch.int64)],
        cap).to(torch.int64)
    cg = torch.full((cap + 1,), INT_MAX, dtype=torch.int32, device=dev)
    cg.scatter_reduce_(0, comp_of_pt, torch.where(core_pt, gid, INT_MAX),
                       "amin")
    comp_l = torch.where(lv, comp_of_pt[lm_safe], cap)
    comp_r = torch.where(rv, comp_of_pt[rm_safe], cap)
    for _ in range(max_rounds):
        in_l, in_r = exchange(cg[comp_of_pt], INT_MAX)
        cg2 = cg.scatter_reduce(0, comp_l, in_l, "amin")
        cg2.scatter_reduce_(0, comp_r, in_r, "amin")
        changed = int(psum((cg2 != cg).sum(dtype=torch.int32), mesh, axis))
        cg = cg2
        if changed == 0:
            break
    else:
        raise RuntimeError(
            f"sharded label agreement still changed {changed} labels "
            f"after {max_rounds} rounds; the labels would be wrong")
    gl_pt = cg[comp_of_pt]

    # Border points (owned, valid, not core): the least agreed label of a
    # core eps-neighbour, all of which lie in this buffer.
    border_min = to_points(columns.border_min(
        *nb, torch.where(core_s, gl_pt[order], INT_MAX)), INT_MAX)
    out = torch.where(core_pt, gl_pt, INT_MAX)
    border = val & own & ~core_pt & (border_min != INT_MAX)
    out = torch.where(border, border_min, out)
    out = torch.where((out == INT_MAX) | ~(val & own), -1, out)
    return out, int(psum(t.overflow, mesh, axis))


def column_grid(points: np.ndarray, n_shards: int, eps: float,
                buffer_cap: int, ncx: int = 0, ncy: int = 0,
                column_cap: int = 0) -> Tuple[int, int, int]:
    """(ncx, ncy, column_cap) of a rank's first try, each given value
    kept: eps-sized columns over the stripe and its halo (at most 1,280 a
    side) and a cap from the mean occupancy of a ``buffer_cap``-slot
    buffer, as the JAX package's."""
    def bucket32(v, lo=32):
        return max(lo, ((v + 31) // 32) * 32)

    x, y = points[:, 0], points[:, 1]
    _, width, _ = _stripe_geometry(x, n_shards)
    if ncx <= 0:
        ncx = bucket32(min(int((width + 2 * eps) / eps) + 2, 1280))
    if ncy <= 0:
        ncy = bucket32(min(int((y.max() - y.min()) / eps) + 2, 1280))
    if column_cap <= 0:
        # measured occupancy: points per eps-cell, padded 2x, min 8
        cells = max(1.0, ncx * ncy * 0.5)  # ~half the grid covers points
        column_cap = max(8, int(2 * buffer_cap / cells) + 4)
    return ncx, ncy, column_cap


def sharded_dbscan(points: np.ndarray, eps: float, min_samples: int,
                   mesh: Mesh, axis: str = "sp", ncx: int = 0, ncy: int = 0,
                   column_cap: int = 0) -> np.ndarray:
    """The whole cloud in, every point's label out on every rank: the
    least global id of its cluster, -1 for noise; the clusters of
    single-card DBSCAN. Every rank passes the same ``points`` (N, 3)
    (a memory map will do) and partitions them on the host with a halo of
    eps.

    The column grids default to ``column_grid``'s; when a column
    overflows, every rank retries with the cap doubled (the psum of the
    overflows is the same on every rank)."""
    nsh, sid = mesh.shape[axis], mesh.coords[axis]
    bufs, valid, owned, gids = partition_stripes(points, nsh, halo=eps)
    lmap, lval, rmap, rval = boundary_maps(points, nsh, halo=eps, gids=gids)
    ncx, ncy, column_cap = column_grid(points, nsh, eps, bufs.shape[1], ncx,
                                       ncy, column_cap)
    row = [a[sid] for a in (bufs, valid, owned, gids, lmap, lval, rmap,
                            rval)]
    while True:
        lab, overflow = sharded_dbscan_labels(
            *row, eps, min_samples, mesh, axis, ncx, ncy, column_cap)
        if overflow == 0:
            break
        column_cap *= 2  # exactness over speed: retry, never drop points
    lab = all_gather(lab[None], mesh, axis).cpu().numpy()
    out = np.full(len(points), -1, np.int32)
    out[gids[owned]] = lab[owned]
    return out
