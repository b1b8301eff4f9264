"""Venue analytics with the density and flow grids cut into x-stripes, one
a rank of an ``sp`` axis.

The counterpart of the JAX package's ``parallel/spatial.py``. People are
replicated (K cluster centroids, far fewer than the points); each rank
computes its own stripe of cells. The only exchange inside a stripe's
work is the flow stencil's x-halo of the speed field, sent to the stripe
neighbours with ``ppermute``, and the speed maximum, a ``pmax``. Each
function returns this rank's stripe; ``gather_stripes`` assembles the
whole grid.

The density counts with the ``radius_count`` kernel, as the single-card
density does below 2^32 pair tests, and not with the JAX shard's
all-pairs distance tensor (25,600 x 131,072 pairs a rank at the 1M venue,
26 GB). The JAX shard squares float32(radius) in float32, so the kernel
is handed that square.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.config import PipelineConfig
from lidar_ai_recommendation_software_tpu_torch.models.flow import _div, _shift
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.parallel.mesh import (
    Mesh, all_gather, pmax, ppermute)


def _stripe(gx: int, mesh: Mesh, axis: str) -> tuple:
    """(this rank's first cell column, columns a stripe)."""
    s = mesh.shape[axis]
    if gx % s:
        raise ValueError(f"grid_cells_x {gx} not divisible by {s} shards")
    local_gx = gx // s
    return mesh.coords[axis] * local_gx, local_gx


def _t(x, mesh: Mesh, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=mesh.device)


def sharded_radius_density(people_xy, people_mask, origin, nx, ny,
                           config: PipelineConfig, mesh: Mesh,
                           axis: str = "sp") -> torch.Tensor:
    """This rank's stripe (local_gx, GY) of the radius-count density grid:
    valid people within ``density.radius`` of each cell centre
    (app_simplified.py:269-281 semantics) over ``density.radius_area``,
    0 past (nx, ny). The people (K, 2), their mask, the origin (2,) and
    nx, ny are replicated: the same on every rank."""
    dc, cap = config.density, config.capacity
    gy = cap.grid_cells_y
    first, local_gx = _stripe(cap.grid_cells_x, mesh, axis)
    ppl = _t(people_xy, mesh, torch.float32)
    pm = _t(people_mask, mesh, torch.bool)
    org = _t(origin, mesh, torch.float32)
    dt = ppl.dtype
    g = _t(dc.grid_size, mesh, dt)
    ci = first + torch.arange(local_gx, device=mesh.device)
    cj = torch.arange(gy, device=mesh.device)
    cx = org[0] + (ci.to(dt) + 0.5) * g
    cy = org[1] + (cj.to(dt) + 0.5) * g
    centers = torch.stack([cx[:, None].expand(local_gx, gy),
                           cy[None, :].expand(local_gx, gy)], dim=-1)
    r = np.float32(dc.radius)
    cnt = kernels.radius_count(centers.reshape(-1, 2), ppl.contiguous(), pm,
                               dc.radius, r2=r * r).reshape(local_gx, gy)
    valid = (ci[:, None] < _t(nx, mesh)) & (cj[None, :] < _t(ny, mesh))
    return (torch.where(valid, cnt, 0).to(dt)
            / _t(dc.radius_area, mesh, dt))


def halo_exchange_x(local: torch.Tensor, halo: int, mesh: Mesh,
                    axis: str = "sp") -> torch.Tensor:
    """A stripe (LX, ...) with ``halo`` rows of each x-neighbour's stripe
    on either side, zeros at the venue's ends: (LX + 2 halo, ...)."""
    n = mesh.shape[axis]
    # the right edge goes to the right neighbour (its left halo), the left
    # edge to the left one; unpaired destinations receive zeros
    from_left = ppermute(local[-halo:], mesh, axis,
                         [(i, i + 1) for i in range(n - 1)])
    from_right = ppermute(local[:halo], mesh, axis,
                          [(i + 1, i) for i in range(n - 1)])
    return torch.cat([from_left, local, from_right], dim=0)


def sharded_flow_and_bottlenecks(mins, maxs, uniforms,
                                 config: PipelineConfig, mesh: Mesh,
                                 axis: str = "sp") -> tuple:
    """Flow synthesis and the monolith bottleneck stencil on this rank's
    stripe: (vectors (LX, GY, 2), mags (LX, GY), valid, sev int32, ok),
    as the JAX package's shard computes them: the synthesis is pointwise
    (crowd_flow_model.py:107-175), the speed scale reads the ``pmax`` of
    the stripes' maxima, and the (2 span + 1)^2 box rule
    (app_simplified.py:432-446) reads a ``span``-row halo of the speeds.
    Every division is by a device tensor (one rounding, as JAX's)."""
    fc, cap = config.flow, config.capacity
    gx, gy = cap.grid_cells_x, cap.grid_cells_y
    first, local_gx = _stripe(gx, mesh, axis)
    span = int(np.ceil(fc.mono_box_halfwidth / fc.grid_size)) - 1
    mn = _t(mins, mesh, torch.float32)
    mx = _t(maxs, mesh, torch.float32)
    u = _t(uniforms, mesh, torch.float32)
    dt, dev = mn.dtype, mesh.device
    g = _t(fc.grid_size, mesh, dt)
    x0, x1, y0, y1 = mn[0], mx[0], mn[1], mx[1]
    nx = torch.ceil((x1 + g - x0) / g).to(torch.int32).clamp(1, gx)
    ny = torch.ceil((y1 + g - y0) / g).to(torch.int32).clamp(1, gy)

    gi = first + torch.arange(local_gx, device=dev)
    jj = torch.arange(gy, dtype=dt, device=dev)
    px = (x0 + gi.to(dt) * g)[:, None].expand(local_gx, gy)
    py = (y0 + jj * g)[None, :].expand(local_gx, gy)
    valid = (gi[:, None] < nx) & (torch.arange(gy, device=dev)[None, :]
                                  < ny)

    dx = x1 - px
    dy = (y0 + y1) / 2 - py
    dist = torch.sqrt(dx * dx + dy * dy)
    nz = dist > 0
    ux = torch.where(nz, dx / torch.where(nz, dist, 1.0), 0.0)
    uy = torch.where(nz, dy / torch.where(nz, dist, 1.0), 0.0)
    ang = (torch.sin(px * fc.swirl_complexity)
           * torch.cos(py * fc.swirl_complexity) * fc.swirl_amplitude)
    ca, sa = torch.cos(ang), torch.sin(ang)
    vx = ux * ca - uy * sa
    vy = ux * sa + uy * ca
    radius = _t(fc.bottleneck_radius, mesh, dt)
    for b in range(u.shape[0]):
        bx = x0 + 1 + u[b, 0] * (x1 - x0 - 2)
        by = y0 + 1 + u[b, 1] * (y1 - y0 - 2)
        ex, ey = px - bx, py - by
        d = torch.sqrt(ex * ex + ey * ey)
        damp = torch.where(d < fc.bottleneck_radius, d / radius, 1.0)
        vx, vy = vx * damp, vy * damp
    mags = torch.sqrt(vx * vx + vy * vy)

    # the global maximum is the pmax of the stripes' maxima
    mmax = pmax(torch.where(valid, mags, 0.0).max(), mesh, axis)
    scale = torch.where(mmax > 0, _div(fc.monolith_max_speed, mmax), 1.0)
    vx, vy, mags = vx * scale, vy * scale, mags * scale

    mags_h = halo_exchange_x(torch.where(valid, mags, 0.0), span, mesh, axis)
    valid_h = halo_exchange_x(valid, span, mesh, axis)
    box_max = torch.zeros_like(mags)
    for ddx in range(-span, span + 1):
        seg = mags_h[span + ddx:span + ddx + local_gx]
        vseg = valid_h[span + ddx:span + ddx + local_gx]
        for ddy in range(-span, span + 1):
            box_max = torch.maximum(box_max, torch.where(
                _shift(vseg, 0, ddy, False), _shift(seg, 0, ddy, 0.0), 0.0))

    slow = valid & (mags < fc.mono_slow_speed)
    fast_near = box_max > fc.mono_fast_speed
    sev = torch.floor(10.0 * (box_max - mags)
                      / box_max.clamp_min(1e-12)).clamp_max(10).to(
                          torch.int32)
    ok = slow & fast_near & (sev >= fc.mono_min_severity)
    vectors = torch.where(valid[..., None], torch.stack([vx, vy], dim=-1),
                          0.0)
    return vectors, torch.where(valid, mags, 0.0), valid, sev, ok


def gather_stripes(local: torch.Tensor, mesh: Mesh,
                   axis: str = "sp") -> torch.Tensor:
    """The whole grid from every rank's stripe, on every rank."""
    return all_gather(local, mesh, axis)
