"""Crowd-density analytics: people extraction, the density grid and its
hotspots.

The PyTorch counterpart of the JAX package's ``models/density.py``. Two
density modes:

  - "radius" (monolith): people within ``radius`` of each cell centre,
    divided by the reference's 4 m^2; the count is the ``radius_count``
    kernel (``ops/cuda/kernels.py``), or above ``BUCKETED_MIN_PAIRS``
    cell x people pair tests the bucketed count
    (``ops/bucket_density.py``).
  - "histogram" (modular): np.histogram2d semantics with a 2-cell margin.

Hotspots are a top-k over the flattened grid in the reference's scan
order, ties going to the earlier cell (a stable descending sort, as
``jax.lax.top_k`` orders ties).
"""

from __future__ import annotations

from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.config import PipelineConfig
from lidar_ai_recommendation_software_tpu_torch.ops import (
    bucket_density, clustering)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.types import (
    DensityResults, People, ProcessedCloud)
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage

# Above this many cell x people pair tests people are bucketed into a
# radius-sized coarse grid (ops/bucket_density.py), as in the JAX package.
BUCKETED_MIN_PAIRS = 1 << 32


@stage("density.people")
def extract_people(processed: ProcessedCloud,
                   config: PipelineConfig) -> People:
    """Cluster centroids -> xy positions (and heights)."""
    cents, valid, overflow = clustering.cluster_centroids(
        processed.points, processed.labels, config.capacity.max_people)
    return People(positions=cents[:, :2].contiguous(), mask=valid,
                  z=cents[:, 2].contiguous(), overflow=overflow)


def _arange_len(start, stop, step) -> torch.Tensor:
    """Length of np.arange(start, stop, step)."""
    return torch.ceil((stop - start) / step).clamp_min(0.0).to(torch.int32)


def radius_count_grid(people: People, origin: torch.Tensor,
                      nx: torch.Tensor, ny: torch.Tensor, gx_cap: int,
                      gy_cap: int, grid_size: float, radius: float,
                      bucket_cap: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """People within ``radius`` of each cell centre, x-major (GX, GY)
    int32, and the number of people dropped by a full coarse bucket (0 on
    the all-pairs path, which is always exact).

    Cell (i, j) has its centre at origin + (i + 0.5, j + 0.5) * grid_size;
    cells past (nx, ny) count 0. With ``bucket_cap`` > 0 and at least
    ``BUCKETED_MIN_PAIRS`` pair tests, people are bucketed
    (``ops/bucket_density.py``); the counts are the same."""
    k = people.positions.shape[0]
    dt = people.positions.dtype
    dev = people.positions.device
    flat = torch.arange(gx_cap * gy_cap, dtype=torch.int32, device=dev)
    ci = flat // gy_cap
    cj = flat % gy_cap
    if bucket_cap > 0 and gx_cap * gy_cap * k >= BUCKETED_MIN_PAIRS:
        counts, overflow = bucket_density.radius_count_bucketed(
            people.positions, people.mask, origin, gx_cap, gy_cap,
            grid_size, radius, bucket_cap)
        cell_valid = ((ci < nx) & (cj < ny)).reshape(gx_cap, gy_cap)
        return torch.where(cell_valid, counts, 0), overflow
    g = torch.tensor(grid_size, dtype=dt, device=dev)
    centers = torch.stack([origin[0] + (ci.to(dt) + 0.5) * g,
                           origin[1] + (cj.to(dt) + 0.5) * g], dim=1)
    cell_valid = (ci < nx) & (cj < ny)
    counts = kernels.radius_count(centers, people.positions, people.mask,
                                  radius)
    counts = torch.where(cell_valid, counts, 0)
    return (counts.reshape(gx_cap, gy_cap),
            torch.zeros((), dtype=torch.int32, device=dev))


def histogram_grid(people: People, origin: torch.Tensor, nx: torch.Tensor,
                   ny: torch.Tensor, gx_cap: int, gy_cap: int,
                   grid_size: float) -> torch.Tensor:
    """Histogram of people positions, x-major (GX, GY) float.

    np.histogram2d puts values on the last edge into the final bin; people
    lie within the margin-padded extent, so clamping to the valid bins
    gives that rule. Integer counts (bincount), so the sums do not depend
    on the order of accumulation."""
    dt = people.positions.dtype
    g = torch.tensor(grid_size, dtype=dt, device=people.positions.device)
    rel = (people.positions - origin[None, :]) / g
    bi = torch.minimum(torch.floor(rel[:, 0]).to(torch.int32).clamp_min(0),
                       nx - 1)
    bj = torch.minimum(torch.floor(rel[:, 1]).to(torch.int32).clamp_min(0),
                       ny - 1)
    total = gx_cap * gy_cap
    flat = torch.where(people.mask, bi * gy_cap + bj, total)  # spill slot
    hist = torch.bincount(flat.to(torch.int64), minlength=total + 1)[:total]
    return hist.to(dt).reshape(gx_cap, gy_cap)


def top_hotspots(grid: torch.Tensor, cell_valid: torch.Tensor,
                 centers_x: torch.Tensor, centers_y: torch.Tensor,
                 threshold: torch.Tensor, max_hotspots: int, y_major: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-capacity top-k hotspot cells >= threshold, in the reference
    variant's scan order (``y_major``) so ties resolve as it resolves
    them."""
    if y_major:
        flat = grid.T.reshape(-1)
        fv = cell_valid.T.reshape(-1)
        fx = centers_x[None, :].expand(grid.T.shape).reshape(-1)
        fy = centers_y[:, None].expand(grid.T.shape).reshape(-1)
    else:
        flat = grid.reshape(-1)
        fv = cell_valid.reshape(-1)
        fx = centers_x[:, None].expand(grid.shape).reshape(-1)
        fy = centers_y[None, :].expand(grid.shape).reshape(-1)

    eligible = fv & (flat >= threshold)
    scores = torch.where(eligible, flat, float("-inf"))
    top_v, top_i = torch.sort(scores, descending=True, stable=True)
    top_v, top_i = top_v[:max_hotspots], top_i[:max_hotspots]
    hmask = top_v > float("-inf")
    return (torch.stack([fx[top_i], fy[top_i]], dim=1),
            torch.where(hmask, top_v, 0.0), hmask)


@stage("density.grid")
def analyze_density(processed: ProcessedCloud, people: People,
                    config: PipelineConfig) -> DensityResults:
    cap = config.capacity
    dc = config.density
    dt = processed.points.dtype
    dev = processed.points.device
    g = torch.tensor(dc.grid_size, dtype=dt, device=dev)
    x0, x1 = processed.mins[0], processed.maxs[0]
    y0, y1 = processed.mins[1], processed.maxs[1]
    total_people = people.count

    if dc.mode == "radius":
        # average over max(1, bbox area), the reference's rule
        area = (x1 - x0) * (y1 - y0)
        avg_density = total_people.to(dt) / area.clamp_min(1.0)
        # grid edges arange(x0, x1 + g, g) -> nx = len - 1
        nx = (_arange_len(x0, x1 + g, g) - 1).clamp(1, cap.grid_cells_x)
        ny = (_arange_len(y0, y1 + g, g) - 1).clamp(1, cap.grid_cells_y)
        origin = torch.stack([x0, y0])
        counts, radius_overflow = radius_count_grid(
            people, origin, nx, ny, cap.grid_cells_x, cap.grid_cells_y,
            dc.grid_size, dc.radius, bucket_cap=cap.density_bucket_cap)
        grid = counts.to(dt) / dc.radius_area
        y_major = True
    else:
        margin = dc.margin_cells * g
        ox, oy = x0 - margin, y0 - margin
        nx = (_arange_len(ox, x1 + margin + g, g) - 1).clamp(
            1, cap.grid_cells_x)
        ny = (_arange_len(oy, y1 + margin + g, g) - 1).clamp(
            1, cap.grid_cells_y)
        origin = torch.stack([ox, oy])
        grid = histogram_grid(people, origin, nx, ny, cap.grid_cells_x,
                              cap.grid_cells_y, dc.grid_size) / (g * g)
        radius_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        y_major = False

    ci = torch.arange(cap.grid_cells_x, device=dev)
    cj = torch.arange(cap.grid_cells_y, device=dev)
    cell_valid = (ci[:, None] < nx) & (cj[None, :] < ny)
    grid = torch.where(cell_valid, grid, 0.0)

    max_density = grid.max()
    if dc.mode == "histogram":
        # average over the nonzero cells
        pos = cell_valid & (grid > 0)
        s = torch.where(pos, grid, 0.0).sum()
        c = pos.to(dt).sum()
        avg_density = torch.where(c > 0, s / c.clamp_min(1.0), 0.0)

    threshold = (avg_density * dc.hotspot_avg_multiplier).clamp_min(
        dc.hotspot_min_threshold)
    centers_x = origin[0] + (ci.to(dt) + 0.5) * g
    centers_y = origin[1] + (cj.to(dt) + 0.5) * g
    hxy, hdens, hmask = top_hotspots(grid, cell_valid, centers_x, centers_y,
                                     threshold, dc.max_hotspots, y_major)

    # No people: zero statistics and no hotspots.
    empty = total_people == 0
    if dc.mode == "histogram":
        avg_density = torch.where(empty, 0.0, avg_density)
    hmask = hmask & ~empty
    return DensityResults(
        total_people=total_people,
        avg_density=avg_density,
        max_density=torch.where(empty, 0.0, max_density),
        density_grid=torch.where(empty, 0.0, grid),
        origin=origin, nx=nx, ny=ny,
        hotspot_xy=hxy, hotspot_density=torch.where(hmask, hdens, 0.0),
        hotspot_mask=hmask, radius_overflow=radius_overflow,
        grid_size=float(dc.grid_size))
