"""``track_match`` and ``track_nodes``: the temporal tracking's all-pairs
tests, the nearest slot of the other frame and the kept velocities around
each lattice node. Launch plans, wrappers and plain PyTorch twins.

The JAX package has no kernel for them: its ``models/temporal.py`` tracks
in jnp. The kernel body is ``csrc/track_pairs.cu``; ``models/temporal.py``
calls ``nearest`` in ``match_people`` (one launch a pair of frames) and
``node_sums`` in ``accumulate_samples`` (one launch for every pair).

As in ``kernels.py``: a CPU tensor takes the plain twin, a CUDA tensor the
kernel (or an error); each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, PAIRS_PER_CHUNK, _check, _cuda_device, _raise_on, _stream,
    load_library)

# The layout of csrc/track_pairs.cu, which the plans mirror (its entry
# points refuse a grid that does not cover the slots or the nodes):
TRACK_THREADS = 128
TRACK_ROWS_PER_THREAD = 4        # rows a thread holds
TRACK_ROW_TILE = TRACK_THREADS * TRACK_ROWS_PER_THREAD
TRACK_COLS_PER_THREAD = 4        # columns a thread stages a tile
TRACK_COL_TILE = TRACK_THREADS * TRACK_COLS_PER_THREAD
# block rows of a match launch: each frame's slots against the other's
MATCH_DIRECTIONS = 2
# a pair with a masked end, in the plain version's distance matrix
FAR = 1e18


def match_plan(k: int) -> Tuple[int, int]:
    """The grid of a match of two frames of ``k`` slots: block (x, y) holds
    rows [x * TRACK_ROW_TILE, (x + 1) * TRACK_ROW_TILE) of direction y
    (0: the first frame's slots, 1: the second's), cut at ``k``, and walks
    every column tile of the other frame."""
    return -(-k // TRACK_ROW_TILE), MATCH_DIRECTIONS


def nodes_plan(nodes: int) -> Tuple[int, int]:
    """The grid of the node sums over ``nodes`` lattice nodes: a row tile
    of nodes a block, every pair walked inside it."""
    return -(-nodes // TRACK_ROW_TILE), 1


def squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(len(a), len(b)) squared xy distances, dx*dx + dy*dy with each
    operation rounded on its own, as the JAX package sums its squares."""
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    return dx * dx + dy * dy


# ---------------------------------------------------------------------------
# track_match
# ---------------------------------------------------------------------------

def nearest_reference(query: torch.Tensor, qmask: torch.Tensor,
                      other: torch.Tensor, omask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of ``nearest``: the (K, K) squared distances, a pair
    with a masked end at 1e18, and an ``argmin`` each way."""
    d2 = squared_distances(query, other)
    d2 = torch.where(qmask[:, None] & omask[None, :], d2,
                     torch.tensor(FAR, dtype=d2.dtype, device=d2.device))
    fwd = torch.argmin(d2, dim=1)                # query -> other
    bwd = torch.argmin(d2, dim=0)                # other -> query
    rows = torch.arange(query.shape[0], device=d2.device)
    return fwd.to(torch.int32), d2[rows, fwd], bwd.to(torch.int32)


def nearest(query: torch.Tensor, qmask: torch.Tensor, other: torch.Tensor,
            omask: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The nearest slot of each frame in the other: (fwd (K,) int32, the
    index into ``other`` of each query slot's nearest; dmin (K,) float32,
    that squared distance; bwd (K,) int32, the index into ``query`` of
    each other slot's nearest).

    Squared distances are dx*dx + dy*dy, a pair with a masked end counts
    as 1e18 and equal distances go to the first index, so a masked slot
    gets index 0 (and 1e18). query, other (K, 2) float32; qmask, omask
    (K,) bool. CPU tensors take ``nearest_reference``; CUDA tensors one
    launch of ``csrc/track_pairs.cu`` by ``match_plan(K)``, no read of
    the device."""
    if query.device.type == "cpu":
        return nearest_reference(query, qmask, other, omask)
    dev = _cuda_device(query, "track_match")
    k = query.shape[0]
    _check("query", query, torch.float32, (k, 2), dev)
    _check("qmask", qmask, torch.bool, (k,), dev)
    _check("other", other, torch.float32, (k, 2), dev)
    _check("omask", omask, torch.bool, (k,), dev)
    _aligned(query=query, other=other)
    grid = match_plan(k)
    with torch.cuda.device(dev):
        idx = torch.empty((MATCH_DIRECTIONS, k), dtype=torch.int32,
                          device=dev)
        dmin = torch.empty(k, dtype=torch.float32, device=dev)
        err = load_library().track_match_launch(
            query.data_ptr(), qmask.data_ptr(), other.data_ptr(),
            omask.data_ptr(), k, *grid, idx.data_ptr(),
            dmin.data_ptr(), _stream(dev))
        _raise_on(err, "track_match")
        LAUNCHES["track_match"] += 1
    return idx[0], dmin, idx[1]


# ---------------------------------------------------------------------------
# track_nodes
# ---------------------------------------------------------------------------

def node_sums_reference(nodes: torch.Tensor, g2: torch.Tensor,
                        positions: torch.Tensor, vel: torch.Tensor,
                        keep: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``node_sums``: the (nodes, K) tests of each pair
    in chunks of nodes of about ``PAIRS_PER_CHUNK`` pairs, each masked sum
    added to the nodes' totals."""
    k = positions.shape[1]
    wsum = torch.zeros((nodes.shape[0], 2), dtype=positions.dtype,
                       device=positions.device)
    cnt = torch.zeros(nodes.shape[0], dtype=torch.int32,
                      device=positions.device)
    chunk = max(1, PAIRS_PER_CHUNK // max(k, 1))
    for t in range(keep.shape[0]):
        curr_pos = positions[t + 1]
        for s in range(0, nodes.shape[0], chunk):
            near = ((squared_distances(nodes[s:s + chunk], curr_pos) <= g2)
                    & keep[t][None, :])
            wsum[s:s + chunk] += torch.where(near[..., None], vel[t][None],
                                             0.0).sum(1)
            cnt[s:s + chunk] += near.sum(1, dtype=torch.int32)
    return wsum, cnt


def node_sums(nodes: torch.Tensor, g2: torch.Tensor, positions: torch.Tensor,
              vel: torch.Tensor, keep: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every kept sample of every pair onto the ``nodes`` (G, 2) within
    ``g2`` (a float32 scalar tensor) of it: the velocity sums (G, 2) float32
    and the sample counts (G,) int32. Pair t's samples sit at frame t + 1
    of ``positions`` (P + 1, K, 2), with velocities ``vel`` (P, K, 2) and
    ``keep`` (P, K) bool.

    CPU tensors take ``node_sums_reference``; CUDA tensors one launch of
    ``csrc/track_pairs.cu`` by ``nodes_plan(G)``, which reads ``g2`` on
    the device (at least one pair, one node and one slot, or it raises).
    Counts are exact; each pair's sum runs in index order, so the float32
    sums differ from the plain version's by reassociation."""
    if nodes.device.type == "cpu":
        return node_sums_reference(nodes, g2, positions, vel, keep)
    dev = _cuda_device(nodes, "track_nodes")
    g = nodes.shape[0]
    p, k = keep.shape
    _check("nodes", nodes, torch.float32, (g, 2), dev)
    _check("g2", g2, torch.float32, (), dev)
    _check("positions", positions, torch.float32, (p + 1, k, 2), dev)
    _check("vel", vel, torch.float32, (p, k, 2), dev)
    _check("keep", keep, torch.bool, (p, k), dev)
    _aligned(nodes=nodes, positions=positions, vel=vel)
    grid = nodes_plan(g)
    with torch.cuda.device(dev):
        wsum = torch.empty((g, 2), dtype=torch.float32, device=dev)
        cnt = torch.empty(g, dtype=torch.int32, device=dev)
        err = load_library().track_nodes_launch(
            nodes.data_ptr(), g2.data_ptr(), positions.data_ptr(),
            keep.data_ptr(), vel.data_ptr(), g, k, p, *grid,
            wsum.data_ptr(), cnt.data_ptr(), _stream(dev))
        _raise_on(err, "track_nodes")
        LAUNCHES["track_nodes"] += 1
    return wsum, cnt


def _aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 8:
            raise ValueError(f"{name} must be 8-byte aligned (float2 rows)")
