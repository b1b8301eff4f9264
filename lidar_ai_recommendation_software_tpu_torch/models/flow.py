"""Crowd-flow analytics: the synthesised flow field over the venue lattice
and its bottlenecks.

The PyTorch counterpart of the JAX package's ``models/flow.py``. The flow
field is the reference's deterministic synthesis: unit vectors toward an
exit at the right-edge midpoint, a sinusoidal swirl, and three seeded
bottleneck discs that damp speed. Bottleneck detection runs as masked
shift stencils over the regular 1 m lattice.

The disc centres come from six np.random.uniform draws after seeding with
the configured seed; they are drawn on the host (``bottleneck_uniforms``)
and mapped to venue coordinates on the device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lidar_ai_recommendation_software_tpu_torch.config import PipelineConfig
from lidar_ai_recommendation_software_tpu_torch.types import (
    FlowResults, People, ProcessedCloud)
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage


def bottleneck_uniforms(seed: int = 42, count: int = 3) -> np.ndarray:
    """The (count, 2) raw U(0,1) draws the reference consumes for
    bottleneck centres (x then y per bottleneck, in order)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(size=(count, 2))


def _shift(a: torch.Tensor, dx: int, dy: int, fill=0.0) -> torch.Tensor:
    """out[i, j] = a[i + dx, j + dy], ``fill`` outside the array."""
    gx, gy = a.shape[:2]
    if a.dtype == torch.bool:
        return _shift(a.to(torch.uint8), dx, dy, int(fill)).to(torch.bool)
    trailing = a.ndim - 2
    # F.pad lists (before, after) pairs from the last dimension backwards
    pad = [0, 0] * trailing + [max(0, -dy), max(0, dy),
                               max(0, -dx), max(0, dx)]
    ap = F.pad(a, pad, value=fill)
    return ap[max(0, dx):max(0, dx) + gx, max(0, dy):max(0, dy) + gy]


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den rounded once. ``float / tensor`` in PyTorch computes
    den.reciprocal() * num, which rounds twice. (Likewise, on CUDA
    ``tensor / float`` multiplies by the float's reciprocal, so divisors
    below are device tensors.)"""
    return torch.div(torch.full_like(den, num), den)


def _disc_offsets(r2_min: float, r2_max: float,
                  rmax: int) -> List[Tuple[int, int]]:
    """Offsets (dx, dy) with r2_min < dx^2 + dy^2 <= r2_max."""
    out = []
    for dx in range(-rmax, rmax + 1):
        for dy in range(-rmax, rmax + 1):
            d2 = dx * dx + dy * dy
            if r2_min < d2 <= r2_max:
                out.append((dx, dy))
    return out


def synthesize_flow(processed: ProcessedCloud, uniforms: torch.Tensor,
                    config: PipelineConfig):
    """Deterministic flow field over the venue lattice.

    Returns (vectors (GX, GY, 2), mags (GX, GY), node_valid (GX, GY), nx,
    ny), x-major; node (i, j) sits at (x0 + i*g, y0 + j*g)."""
    fc = config.flow
    cap = config.capacity
    dt = processed.points.dtype
    dev = processed.points.device
    g = torch.tensor(fc.grid_size, dtype=dt, device=dev)
    x0, x1 = processed.mins[0], processed.maxs[0]
    y0, y1 = processed.mins[1], processed.maxs[1]
    gx_cap, gy_cap = cap.grid_cells_x, cap.grid_cells_y

    nx = torch.ceil((x1 + g - x0) / g).to(torch.int32).clamp(1, gx_cap)
    ny = torch.ceil((y1 + g - y0) / g).to(torch.int32).clamp(1, gy_cap)

    ii = torch.arange(gx_cap, dtype=dt, device=dev)
    jj = torch.arange(gy_cap, dtype=dt, device=dev)
    px = (x0 + ii[:, None] * g).expand(gx_cap, gy_cap)
    py = (y0 + jj[None, :] * g).expand(gx_cap, gy_cap)
    valid = ((torch.arange(gx_cap, device=dev)[:, None] < nx)
             & (torch.arange(gy_cap, device=dev)[None, :] < ny))

    # Base field toward the exit at the right-edge midpoint.
    dx = x1 - px
    dy = (y0 + y1) / 2 - py
    dist = torch.sqrt(dx * dx + dy * dy)
    nzero = dist > 0
    safe = torch.where(nzero, dist, 1.0)
    ux = torch.where(nzero, dx / safe, 0.0)
    uy = torch.where(nzero, dy / safe, 0.0)

    # Swirl rotation.
    ang = (torch.sin(px * fc.swirl_complexity)
           * torch.cos(py * fc.swirl_complexity) * fc.swirl_amplitude)
    ca, sa = torch.cos(ang), torch.sin(ang)
    vx = ux * ca - uy * sa
    vy = ux * sa + uy * ca

    # Bottleneck discs damp speed; centres lie in [lo + 1, hi - 1].
    u = uniforms.to(dt)
    for b in range(u.shape[0]):
        bx = x0 + 1 + u[b, 0] * (x1 - x0 - 2)
        by = y0 + 1 + u[b, 1] * (y1 - y0 - 2)
        ex, ey = px - bx, py - by
        d = torch.sqrt(ex * ex + ey * ey)
        damp = torch.where(d < fc.bottleneck_radius,
                           d / d.new_tensor(fc.bottleneck_radius), 1.0)
        vx = vx * damp
        vy = vy * damp

    mags = torch.sqrt(vx * vx + vy * vy)
    mmax = torch.where(valid, mags, 0.0).max()

    if fc.scale_mode == "monolith":
        # scale so the fastest node moves at monolith_max_speed
        scale = torch.where(mmax > 0, _div(fc.monolith_max_speed, mmax),
                            1.0)
        vx, vy = vx * scale, vy * scale
        mags = torch.sqrt(vx * vx + vy * vy)
    else:
        # scale by (max - min) / mmax, then clip the magnitudes only; the
        # vectors keep the unclipped scaling, as in the reference
        scale = torch.where(mmax > 0,
                            _div(fc.speed_max - fc.speed_min, mmax), 1.0)
        vx, vy = vx * scale, vy * scale
        mags = torch.sqrt(vx * vx + vy * vy).clamp(fc.speed_min,
                                                   fc.speed_max)

    vectors = torch.where(valid[..., None], torch.stack([vx, vy], dim=-1),
                          0.0)
    mags = torch.where(valid, mags, 0.0)
    return vectors, mags, valid, nx, ny


def _bottlenecks_monolith(mags: torch.Tensor, valid: torch.Tensor,
                          config: PipelineConfig):
    """Nodes slower than mono_slow_speed whose box (|offset| < halfwidth
    on the lattice) holds a node faster than mono_fast_speed; severity
    int(10 * (max - mag) / max), kept from mono_min_severity up."""
    fc = config.flow
    span = int(np.ceil(fc.mono_box_halfwidth / fc.grid_size)) - 1
    box_max = torch.zeros_like(mags)
    for dx in range(-span, span + 1):
        for dy in range(-span, span + 1):
            shifted = torch.where(_shift(valid, dx, dy, False),
                                  _shift(mags, dx, dy, 0.0), 0.0)
            box_max = torch.maximum(box_max, shifted)
    slow = valid & (mags < fc.mono_slow_speed)
    fast_near = box_max > fc.mono_fast_speed
    sev = torch.floor(10.0 * (box_max - mags)
                      / box_max.clamp_min(1e-12)).to(torch.int32)
    sev = sev.clamp_max(10)
    ok = slow & fast_near & (sev >= fc.mono_min_severity)
    return sev, ok


def _bottlenecks_modular(vectors: torch.Tensor, mags: torch.Tensor,
                         valid: torch.Tensor, config: PipelineConfig):
    """Near disc (r <= 3, centre included) and far ring (3 < r <= 5) on
    the lattice; severity ((mean_far - mean_near) * 5 + convergence * 5)
    / 2, kept above mod_min_severity. The unit direction from a neighbour
    to the centre is the constant -offset/|offset|."""
    fc = config.flow
    near_offs = _disc_offsets(-1.0, fc.mod_near_radius ** 2,
                              int(fc.mod_near_radius))
    far_offs = _disc_offsets(fc.mod_near_radius ** 2,
                             fc.mod_far_radius ** 2, int(fc.mod_far_radius))
    dt = mags.dtype

    n_near = torch.zeros_like(mags)
    s_near = torch.zeros_like(mags)
    conv = torch.zeros_like(mags)
    for dx, dy in near_offs:
        v = _shift(valid, dx, dy, False)
        n_near = n_near + v.to(dt)
        s_near = s_near + torch.where(v, _shift(mags, dx, dy), 0.0)
        if dx or dy:
            norm = float(np.sqrt(dx * dx + dy * dy))
            ux, uy = -dx / norm, -dy / norm
            nv = _shift(vectors, dx, dy)
            dot = ux * nv[..., 0] + uy * nv[..., 1]
            conv = conv + torch.where(v, dot.clamp_min(0.0), 0.0)

    n_far = torch.zeros_like(mags)
    s_far = torch.zeros_like(mags)
    for dx, dy in far_offs:
        v = _shift(valid, dx, dy, False)
        n_far = n_far + v.to(dt)
        s_far = s_far + torch.where(v, _shift(mags, dx, dy), 0.0)

    mean_near = s_near / n_near.clamp_min(1.0)
    mean_far = s_far / n_far.clamp_min(1.0)
    conv = conv / n_near.clamp_min(1.0)
    sev_f = ((mean_far - mean_near) * 5.0 + conv * 5.0) / 2.0
    sev = torch.round(sev_f).clamp_max(10).to(torch.int32)
    ok = (valid & (mags <= fc.mod_slow_speed)
          & (n_near >= fc.mod_min_near) & (n_far >= fc.mod_min_far)
          & (sev_f > fc.mod_min_severity))
    return sev, ok


@stage("flow.field")
def analyze_flow(processed: ProcessedCloud, people: People,
                 uniforms: torch.Tensor,
                 config: PipelineConfig) -> FlowResults:
    fc = config.flow
    cap = config.capacity
    dt = processed.points.dtype
    dev = processed.points.device

    vectors, mags, valid, _, _ = synthesize_flow(processed, uniforms,
                                                 config)
    vcount = valid.to(dt).sum().clamp_min(1.0)
    avg_speed = torch.where(valid, mags, 0.0).sum() / vcount
    mean_vec = torch.where(valid[..., None], vectors, 0.0).sum(
        dim=(0, 1)) / vcount

    if fc.variant == "monolith":
        sev, ok = _bottlenecks_monolith(mags, valid, config)
    else:
        sev, ok = _bottlenecks_modular(vectors, mags, valid, config)

    # The reference visits nodes y-outer and sorts stably by severity,
    # descending: transpose, then a stable sort (ties keep scan order).
    sev_flat = sev.T.reshape(-1)
    ok_flat = ok.T.reshape(-1)
    g = torch.tensor(fc.grid_size, dtype=dt, device=dev)
    x0, y0 = processed.mins[0], processed.mins[1]
    ii = torch.arange(cap.grid_cells_x, dtype=dt, device=dev)
    jj = torch.arange(cap.grid_cells_y, dtype=dt, device=dev)
    fx = (x0 + ii * g)[None, :].expand(cap.grid_cells_y,
                                       cap.grid_cells_x).reshape(-1)
    fy = (y0 + jj * g)[:, None].expand(cap.grid_cells_y,
                                       cap.grid_cells_x).reshape(-1)

    scores = torch.where(ok_flat, sev_flat, -1)
    top_v, top_i = torch.sort(scores, descending=True, stable=True)
    top_v = top_v[:fc.max_bottlenecks]
    top_i = top_i[:fc.max_bottlenecks]

    # No people: no flow nodes and no bottlenecks.
    empty = people.count == 0
    bmask = (top_v >= 0) & ~empty
    zero = torch.zeros((), dtype=dt, device=dev)
    return FlowResults(
        positions=torch.stack([fx, fy], dim=1),
        vectors=vectors.transpose(0, 1).reshape(-1, 2),
        magnitudes=mags.T.reshape(-1),
        node_mask=valid.T.reshape(-1) & ~empty,
        avg_speed=torch.where(empty, zero, avg_speed),
        mean_vector=torch.where(empty, zero, mean_vec),
        bottleneck_xy=torch.stack([fx[top_i], fy[top_i]], dim=1),
        bottleneck_severity=torch.where(bmask, top_v, 0),
        bottleneck_mask=bmask)
