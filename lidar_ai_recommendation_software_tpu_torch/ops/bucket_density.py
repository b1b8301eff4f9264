"""Coarse-bucketed radius count for the density grid, in plain PyTorch.

The counterpart of the JAX package's ``ops/bucket_density.py``, which is
plain jnp (no Pallas kernel). Above 2^32 cell x people pair tests the
density grid stops counting every person against every cell centre:
people are bucketed once into a coarse grid whose cell edge is
``s = ceil(radius / grid_size)`` density cells, sharing the density
grid's origin, so every person within ``radius`` of a cell centre lies in
the 3x3 coarse cells around that centre's coarse cell. The count is then
a dense 9 x ``bucket_cap`` masked-distance accumulation per cell.

Exactness: a person outside the 3x3 window is farther than ``radius``
from every point of the centre's cell, by at least one float32 ulp, so the
windowed count equals the all-pairs float32 count bit for bit, given the
same arithmetic: ``r2`` is float32(radius) squared in float32, the coarse
index divides by a device tensor, and the cell centres are
``origin + (idx + 0.5) * g`` in float32, as on the all-pairs path. People
dropped because a bucket held more than ``bucket_cap`` are counted in the
returned overflow; the pipeline doubles the capacity and re-runs.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.columns import (
    EMPTY_COORD)


def sort_ranks(keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stable sort of bucket ids (N,): (sorted ids, order = the index
    at each sorted position, rank of each sorted position within its run
    of equal ids), the ids' dtype, int64 and int64. Stable, so a bucket's
    entries keep index order and a full bucket keeps its lowest indices,
    as the JAX package's sorts do."""
    skeys, order = torch.sort(keys, stable=True)
    i = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    return skeys, order, i - torch.searchsorted(skeys, skeys)


def build_people_buckets(xy: torch.Tensor, mask: torch.Tensor,
                         origin: torch.Tensor, coarse_size: float,
                         cx_cells: int, cy_cells: int, cap: int
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Bucket people (K, 2) into (CAP, CX + 2, CY + 2) coordinate planes.

    Returns (tx, ty, overflow): EMPTY_COORD where a slot is empty (one
    border cell on each side, so 3x3 windows are plain slices), and the
    number of valid people dropped by the cap. The slot is the rank in a
    stable sort by bucket (``sort_ranks``), so a full bucket keeps its
    lowest-index people, as in the JAX package."""
    dev = xy.device
    cxp, cyp = cx_cells + 2, cy_cells + 2
    cs = torch.tensor(coarse_size, dtype=xy.dtype, device=dev)
    ci = torch.floor((xy[:, 0] - origin[0]) / cs).to(torch.int32).clamp(
        0, cx_cells - 1)
    cj = torch.floor((xy[:, 1] - origin[1]) / cs).to(torch.int32).clamp(
        0, cy_cells - 1)
    ncells = cxp * cyp
    cid = torch.where(mask, (ci + 1) * cyp + (cj + 1), ncells)

    scid, order, rank = sort_ranks(cid)
    keep = (scid < ncells) & (rank < cap)
    overflow = ((scid < ncells) & (rank >= cap)).sum(dtype=torch.int32)

    flat = (rank * ncells + scid)[keep]
    src = order[keep]
    tx = torch.full((cap * ncells,), EMPTY_COORD, dtype=torch.float32,
                    device=dev)
    ty = tx.clone()
    tx[flat] = xy[src, 0].to(torch.float32)
    ty[flat] = xy[src, 1].to(torch.float32)
    shape = (cap, cxp, cyp)
    return tx.reshape(shape), ty.reshape(shape), overflow


def radius_count_bucketed(xy: torch.Tensor, mask: torch.Tensor,
                          origin: torch.Tensor, gx_cap: int, gy_cap: int,
                          grid_size: float, radius: float, bucket_cap: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """People within ``radius`` of each density-cell centre, x-major.

    xy (K, 2) padded people, mask (K,), origin (2,) the density grid's
    lower corner. Returns (counts (GX, GY) int32, overflow () int32)."""
    s = max(1, -(-int(round(radius / grid_size * 1e6)) // 1_000_000))
    cxc = -(-gx_cap // s)
    cyc = -(-gy_cap // s)
    tx, ty, overflow = build_people_buckets(
        xy, mask, origin, s * grid_size, cxc, cyc, bucket_cap)

    dev = xy.device
    g = torch.tensor(grid_size, dtype=torch.float32, device=dev)
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    r2 = r * r
    # fine cell I * s + u has its centre at origin + (idx + 0.5) * g
    fxi = torch.arange(cxc * s, dtype=torch.float32, device=dev)
    fyi = torch.arange(cyc * s, dtype=torch.float32, device=dev)
    fx = (origin[0] + (fxi + 0.5) * g).reshape(cxc, s)
    fy = (origin[1] + (fyi + 0.5) * g).reshape(cyc, s)

    planes = []
    for u in range(s):
        for v in range(s):
            acc = torch.zeros((cxc, cyc), dtype=torch.int32, device=dev)
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    sx = tx[:, 1 + di:1 + di + cxc, 1 + dj:1 + dj + cyc]
                    sy = ty[:, 1 + di:1 + di + cxc, 1 + dj:1 + dj + cyc]
                    dx = sx - fx[None, :, u, None]
                    dy = sy - fy[None, None, :, v]
                    acc += (dx * dx + dy * dy <= r2).sum(0,
                                                         dtype=torch.int32)
            planes.append(acc)

    # (s * s, CXC, CYC) -> (CXC, s, CYC, s) -> the fine grid
    stack = torch.stack(planes).reshape(s, s, cxc, cyc)
    counts = stack.permute(2, 0, 3, 1).reshape(cxc * s, cyc * s)
    return counts[:gx_cap, :gy_cap].contiguous(), overflow
