"""End-to-end analytics pipeline on one device.

``analyze_cloud`` runs preprocess -> people extraction -> density -> flow
on the device; the host sizes the static capacities, re-runs with larger
ones when a capacity overflowed, converts the device results into
reference-shaped dicts and runs the rule-based recommendation engine.

Usage:
    pipe = Pipeline(MONOLITH_CONFIG, device="cuda")
    results = pipe.analyze(points_np)        # host-facing dicts
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_ai_recommendation_software_tpu_torch.utils.recommendations import (
    generate_recommendations)
from lidar_ai_recommendation_software_tpu_torch.models import (
    density as density_mod)
from lidar_ai_recommendation_software_tpu_torch.models import flow as flow_mod
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.preprocess import preprocess
from lidar_ai_recommendation_software_tpu_torch.types import (
    AnalysisResults, PointCloud)


def analyze_cloud(cloud: PointCloud, uniforms: torch.Tensor,
                  config: PipelineConfig) -> tuple:
    """The device program: (processed, people, AnalysisResults)."""
    processed = preprocess(cloud, config)
    people = density_mod.extract_people(processed, config)
    dres = density_mod.analyze_density(processed, people, config)
    fres = flow_mod.analyze_flow(processed, people, uniforms, config)
    return processed, people, AnalysisResults(density=dres, flow=fres)


def _bucket_eighth_octave(n: int, floor: int = 64) -> int:
    """Smallest multiple of 2^(k-3) >= n, where 2^(k-1) < n <= 2^k: caps
    padding at 12.5% while keeping capacities multiples of a large power
    of two."""
    n = max(int(n), floor)
    k = (n - 1).bit_length()
    step = 1 << max(k - 3, 3)
    return -(-n // step) * step


class Pipeline:
    """Host-facing orchestrator with reference-shaped outputs.

    ``device`` is explicit: "cuda" (the default) raises when no CUDA
    device is present; the CPU runs only when asked for by name."""

    def __init__(self, config: PipelineConfig = MONOLITH_CONFIG,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Pipeline(device='cuda') needs a CUDA device and none "
                    "is available; pass device='cpu' to run on the CPU")
        self.config = config
        self._uniforms = torch.as_tensor(
            flow_mod.bottleneck_uniforms(config.flow.random_seed,
                                         config.flow.bottleneck_count),
            dtype=torch.float32, device=self.device)

    def fit_capacity(self, points: np.ndarray) -> PipelineConfig:
        """Size static capacities to the input, as the JAX package does,
        so both packages pick the same ones: point and people capacities
        bucketed to eighths of an octave, the density/flow grid covering
        the venue extent, the clustering buffer the next power of two of
        0.8 n, and the clustering column grid (eps-sized columns, at most
        1,280 a side) with a column cap measured from the points."""
        cap = self.config.capacity
        n = len(points)
        max_points = max(cap.max_points, _bucket_eighth_octave(n))

        mins = points.min(axis=0)
        maxs = points.max(axis=0)
        g = self.config.density.grid_size
        margin = 2 * self.config.density.margin_cells + 2
        need_x = int(np.ceil((maxs[0] - mins[0]) / g)) + margin
        need_y = int(np.ceil((maxs[1] - mins[1]) / g)) + margin

        def bucket32(v, lo):
            return max(lo, ((v + 31) // 32) * 32)

        gx = bucket32(need_x, cap.grid_cells_x)
        gy = bucket32(need_y, cap.grid_cells_y)
        max_people = max(cap.max_people,
                         _bucket_eighth_octave(max(1, n // 8), floor=32))

        # Cluster column grid: eps-sized columns, bounded so the table
        # stays within device memory. Pair tests per sweep are
        # ncells * 9 * column_cap^2 at worst, so columns are fine and the
        # cap is sized to the measured occupancy (the overflow retry
        # doubles it on adversarial scenes).
        eps = self.config.preprocess.dbscan_eps
        ccx = bucket32(min(int((maxs[0] - mins[0]) / eps) + 2, 1280),
                       cap.cluster_cells_x)
        ccy = bucket32(min(int((maxs[1] - mins[1]) / eps) + 2, 1280),
                       cap.cluster_cells_y)

        # ~70% of points are non-ground; the next power of two of 0.8 n
        # leaves headroom, and the overflow retry covers the rest.
        ccap = 1 << max(10, (max(1, int(0.8 * n)) - 1).bit_length())
        ccap = min(ccap, max_points)

        def ceil8(v):
            return ((int(v) + 7) // 8) * 8

        # Column cap from the measured occupancy: one host bincount of the
        # columns the device will use gives the largest column; +3 covers
        # the slightly different extent of the non-ground subset that is
        # clustered (the overflow retry guards exactness).
        if n > 32768:  # column path only (small sets take the all-pairs)
            cell = max(eps, (maxs[:2] - mins[:2]).max() / (min(ccx, ccy)
                                                           - 1e-3))
            cxi = np.clip(((points[:, 0] - mins[0]) / cell).astype(
                np.int64), 0, ccx - 1)
            cyi = np.clip(((points[:, 1] - mins[1]) / cell).astype(
                np.int64), 0, ccy - 1)
            max_occ = int(np.bincount(cxi * ccy + cyi).max())
            ccol = min(64, max(8, ceil8(max_occ + 3)))
        else:
            occ = 0.8 * n / float(ccx * ccy)
            ccol = min(64, max(16, ceil8(8.0 * occ + 8.0)))
            ccol = max(ccol, cap.cluster_column_cap)

        if (max_points == cap.max_points and gx == cap.grid_cells_x
                and gy == cap.grid_cells_y
                and max_people == cap.max_people
                and ccx == cap.cluster_cells_x
                and ccy == cap.cluster_cells_y
                and ccap == cap.cluster_capacity
                and ccol == cap.cluster_column_cap):
            return self.config
        return self.config.with_capacity(
            max_points=max_points, grid_cells_x=gx, grid_cells_y=gy,
            max_people=max_people, cluster_cells_x=ccx,
            cluster_cells_y=ccy, cluster_capacity=ccap,
            cluster_column_cap=ccol)

    def analyze_device(self, cloud: PointCloud,
                       config: Optional[PipelineConfig] = None):
        return analyze_cloud(cloud, self._uniforms, config or self.config)

    # Beyond this coordinate magnitude float32 cell and cluster math loses
    # the sub-metre resolution the analytics need (LAS files often carry
    # UTM offsets of 1e5-1e7): recentre on ingest, shift reported
    # coordinates back on the host.
    RECENTER_THRESHOLD = 4096.0

    def _grown_cluster_cfg(self, cfg: PipelineConfig
                           ) -> Optional[PipelineConfig]:
        """Double the clustering capacities after an overflow: the column
        cap up to 512 and the buffer up to max_points (BRUTEFORCE_HARD_CAP
        for the modular variant). None when both sit at their ceiling."""
        cap_limit = cfg.capacity.max_points
        if self.config.preprocess.variant == "modular":
            cap_limit = min(cap_limit, clustering.BRUTEFORCE_HARD_CAP)
        if (cfg.capacity.cluster_column_cap >= 512
                and cfg.capacity.cluster_capacity >= cap_limit):
            return None
        return cfg.with_capacity(
            cluster_column_cap=min(512,
                                   cfg.capacity.cluster_column_cap * 2),
            cluster_capacity=min(cap_limit,
                                 max(1, cfg.capacity.cluster_capacity)
                                 * 2))

    _OVERFLOW_MSG = (
        "clustering overflowed its exact-capacity ceiling ({n} points "
        "dropped). The modular variant clusters StandardScaler-warped "
        "space where eps=0.5 is macroscopic, so only the O(n^2) brute "
        "force is exact, and it is bounded at 131072 non-ground points. "
        "Downsample first or use the monolith variant.")

    def analyze(self, points: np.ndarray) -> Dict:
        """NumPy points in, reference-shaped result dicts out."""
        points = np.asarray(points, dtype=np.float64)[:, :3]
        offset = np.zeros(3)
        if np.abs(points[:, :2]).max() > self.RECENTER_THRESHOLD:
            offset[:2] = np.round(points[:, :2].mean(axis=0))
            points = points - offset

        cfg = self.fit_capacity(points)
        cloud = PointCloud.from_numpy(points, cfg.capacity.max_points,
                                      device=self.device)
        processed, people, res = self.analyze_device(cloud, cfg)
        # Clustering overflowed a capacity (a full column or the buffer):
        # grow and re-run.
        while int(processed.cluster_overflow) > 0:
            grown = self._grown_cluster_cfg(cfg)
            if grown is None:
                raise RuntimeError(self._OVERFLOW_MSG.format(
                    n=int(processed.cluster_overflow)))
            cfg = grown
            processed, people, res = self.analyze_device(cloud, cfg)
        # More clusters than the people capacity: grow to the next power
        # of two that holds them all and re-run (the reference never drops
        # a cluster).
        while int(people.overflow) > 0:
            need = cfg.capacity.max_people + int(people.overflow)
            cfg = cfg.with_capacity(
                max_people=1 << max(1, (need - 1).bit_length()))
            processed, people, res = self.analyze_device(cloud, cfg)
        # A coarse bucket of the bucketed density count overflowed: double
        # its cap and re-run (it ends: a cap of max_people holds everyone).
        while int(res.density.radius_overflow) > 0:
            cfg = cfg.with_capacity(density_bucket_cap=min(
                cfg.capacity.max_people,
                cfg.capacity.density_bucket_cap * 2))
            processed, people, res = self.analyze_device(cloud, cfg)
        density_results = res.density.to_host_dict()
        flow_results = res.flow.to_host_dict()
        if offset.any():
            ox, oy = float(offset[0]), float(offset[1])
            density_results["origin"] = (
                density_results["origin"][0] + ox,
                density_results["origin"][1] + oy)
            for h in density_results["hotspots"]:
                h["x"] += ox
                h["y"] += oy
            for b in flow_results["bottlenecks"]:
                b["x"] += ox
                b["y"] += oy
            flow_results["flow_vectors"]["positions"] = (
                flow_results["flow_vectors"]["positions"]
                + np.array([ox, oy]))
        recommendations = generate_recommendations(
            density_results, flow_results, self.config.recommend)
        return {
            "processed": processed,
            "people": people,
            "coordinate_offset": offset,
            "density": density_results,
            "flow": flow_results,
            "recommendations": recommendations,
        }
