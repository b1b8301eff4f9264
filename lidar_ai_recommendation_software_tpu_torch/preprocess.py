"""Preprocessing: height-ramp colours, 3-sigma outlier rejection,
percentile ground split, least-squares ground plane and person
clustering, on fixed-capacity tensors.

The PyTorch counterpart of the JAX package's ``preprocess.py``. Rejected
points are masked, not removed, so shapes depend only on the capacities
and every reduction downstream is mask-aware.
"""

from __future__ import annotations

import torch

from lidar_ai_recommendation_software_tpu_torch.config import PipelineConfig
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.types import (
    PointCloud, ProcessedCloud)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = 0
                 ) -> torch.Tensor:
    m = mask.to(x.dtype)
    if x.ndim > mask.ndim:
        m = m[..., None]
    cnt = m.sum(axis).clamp_min(1.0)
    return (x * m).sum(axis) / cnt


def _masked_std(x: torch.Tensor, mask: torch.Tensor, axis: int = 0
                ) -> torch.Tensor:
    dev = x - _masked_mean(x, mask, axis)
    return torch.sqrt(_masked_mean(dev * dev, mask, axis))


def masked_percentile(x: torch.Tensor, mask: torch.Tensor,
                      q: float) -> torch.Tensor:
    """np.percentile(x[mask], q) with linear interpolation, on padded
    data: invalid entries sort to the float maximum at the tail, and the
    index is taken against the valid count. A full sort, because
    ``torch.quantile`` refuses inputs above 2^24 elements."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, big)).values
    n = mask.sum(dtype=torch.int32)
    pos = (n - 1).to(x.dtype) * (q / 100.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo.to(x.dtype)
    last = x.shape[0] - 1
    lo_v = xs[lo.clamp(0, last)]
    hi_v = xs[hi.clamp(0, last)]
    return lo_v + (hi_v - lo_v) * frac


def fit_ground_plane(points: torch.Tensor, ground_mask: torch.Tensor,
                     all_mask: torch.Tensor) -> torch.Tensor:
    """Least-squares z = ax + by + c over ground points, as [a, b, -1, c],
    from the 3x3 normal equations; a horizontal plane at the lowest point
    when there are 10 ground points or fewer.

    The normal equations are summed elementwise, not with a matmul, so
    their precision does not hang on the process's TF32 setting."""
    m = ground_mask.to(points.dtype)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    cols = torch.stack([x, y, torch.ones_like(x)], dim=1) * m[:, None]
    ata = (cols[:, :, None] * cols[:, None, :]).sum(0)
    atb = (cols * (z * m)[:, None]).sum(0)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    # solve_ex: no device-to-host check of the factorisation; the
    # regularised system is never singular, and degenerate inputs take the
    # fallback below.
    sol = torch.linalg.solve_ex(ata + 1e-6 * eye, atb).result
    minus_one = torch.full_like(sol[:1], -1.0)
    plane = torch.cat([sol[:2], minus_one, sol[2:]])

    n_ground = ground_mask.sum(dtype=torch.int32)
    zmin = torch.where(all_mask, z, torch.finfo(points.dtype).max).min()
    fallback = torch.stack([torch.zeros_like(zmin), torch.zeros_like(zmin),
                            torch.ones_like(zmin), -zmin])
    return torch.where(n_ground > 10, plane, fallback)


def preprocess(cloud: PointCloud, config: PipelineConfig) -> ProcessedCloud:
    pc = config.preprocess
    cap = config.capacity
    pts = cloud.points
    mask = cloud.mask
    n_pts = pts.shape[0]

    # Height-ramp colours over the raw cloud.
    z = pts[:, 2]
    big = torch.finfo(pts.dtype).max
    zmin = torch.where(mask, z, big).min()
    zmax = torch.where(mask, z, -big).max()
    nh = (z - zmin) / (zmax - zmin + 1e-10)
    colors = torch.stack([nh, 0.5 * (1.0 - nh), torch.full_like(nh, 0.5)],
                         dim=1)

    # 3-sigma outlier mask with the population std.
    mean = _masked_mean(pts, mask)
    std = _masked_std(pts, mask)
    inlier = mask & ((pts - mean).abs() < pc.outlier_sigma * std).all(dim=1)

    normals = torch.zeros_like(pts)
    normals[:, 2] = 1.0

    # Ground split at the z percentile.
    z_thresh = masked_percentile(z, inlier, pc.ground_percentile)
    ground = inlier & (z <= z_thresh)
    non_ground = inlier & ~ground

    plane = fit_ground_plane(pts, ground, inlier)

    n_ng = non_ground.sum(dtype=torch.int32)
    if pc.variant == "modular":
        # StandardScaler over the non-ground subset; every scaled axis has
        # std 1, so the adaptive eps clip(0.5 * 1, 0.2, 0.5) is 0.5.
        mu = _masked_mean(pts, non_ground)
        sd = _masked_std(pts, non_ground).clamp_min(1e-12)
        cluster_pts = (pts - mu) / sd
        eps = min(max(0.5 * 1.0, 0.2), 0.5)
    else:
        cluster_pts = pts
        eps = pc.dbscan_eps

    # Compact the non-ground points to the front of the clustering buffer
    # (the all-pairs pass is quadratic in its size). The stable sort keeps
    # point order, so clusters keep their smallest-index representatives.
    ccap = min(cap.cluster_capacity or n_pts, n_pts)
    if pc.variant == "modular":
        ccap = min(ccap, clustering.BRUTEFORCE_HARD_CAP)
    if ccap < n_pts:
        order = torch.argsort((~non_ground).to(torch.int8), stable=True)
        inv_order = torch.empty_like(order)
        inv_order[order] = torch.arange(n_pts, device=pts.device)
        compact_pts = cluster_pts[order[:ccap]]
        compact_mask = non_ground[order[:ccap]]
        compact_overflow = (n_ng - ccap).clamp_min(0)
    else:
        inv_order = None
        compact_pts = cluster_pts
        compact_mask = non_ground
        compact_overflow = torch.zeros((), dtype=torch.int32,
                                       device=pts.device)

    labels_c, n_clusters, overflow = clustering.dbscan_labels(
        compact_pts, compact_mask, eps, pc.dbscan_min_samples,
        ncx=cap.cluster_cells_x, ncy=cap.cluster_cells_y,
        column_cap=cap.cluster_column_cap, max_iters=cap.max_cc_iters,
        brute_cap=(clustering.BRUTEFORCE_HARD_CAP
                   if pc.variant == "modular"
                   else clustering.BRUTEFORCE_MAX_POINTS))
    overflow = overflow + compact_overflow

    if inv_order is None:
        labels = labels_c
    else:
        labels = torch.nn.functional.pad(labels_c, (0, n_pts - ccap),
                                         value=-1)[inv_order]

    # Too few non-ground points: the reference skips clustering and puts
    # them all in cluster 0.
    few = n_ng <= pc.min_cluster_points
    labels = torch.where(few & non_ground, 0, labels)
    labels = torch.where(ground | ~inlier, -1, labels)
    n_clusters = torch.where(few, (n_ng > 0).to(torch.int32), n_clusters)

    mins = torch.where(inlier[:, None], pts, big).amin(dim=0)
    maxs = torch.where(inlier[:, None], pts, -big).amax(dim=0)

    return ProcessedCloud(
        points=pts, mask=inlier, colors=colors, normals=normals,
        labels=labels.to(torch.int32), ground_mask=ground,
        ground_plane=plane, mins=mins, maxs=maxs,
        n_clusters=n_clusters.to(torch.int32),
        cluster_overflow=overflow.to(torch.int32))
