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

from lidar_ai_recommendation_software_tpu.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_ai_recommendation_software_tpu.utils.recommendations import (
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
        """Size static capacities to the input, bucketed to eighths of an
        octave: point capacity covers n, the density/flow grid covers the
        venue extent, the people capacity scales with the point count,
        and the clustering buffer is the next power of two of 0.8 n."""
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

        # ~70% of points are non-ground; the next power of two of 0.8 n
        # leaves headroom, and the overflow retry covers the rest.
        ccap = 1 << max(10, (max(1, int(0.8 * n)) - 1).bit_length())
        ccap = min(ccap, max_points)

        if (max_points == cap.max_points and gx == cap.grid_cells_x
                and gy == cap.grid_cells_y
                and max_people == cap.max_people
                and ccap == cap.cluster_capacity):
            return self.config
        return self.config.with_capacity(
            max_points=max_points, grid_cells_x=gx, grid_cells_y=gy,
            max_people=max_people, cluster_capacity=ccap)

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
        """Double the clustering buffer after an overflow; None when it
        sits at its ceiling (max_points, or BRUTEFORCE_HARD_CAP for the
        modular variant)."""
        cap_limit = cfg.capacity.max_points
        if self.config.preprocess.variant == "modular":
            cap_limit = min(cap_limit, clustering.BRUTEFORCE_HARD_CAP)
        if cfg.capacity.cluster_capacity >= cap_limit:
            return None
        return cfg.with_capacity(cluster_capacity=min(
            cap_limit, max(1, cfg.capacity.cluster_capacity) * 2))

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
        # Clustering overflowed its buffer: grow and re-run.
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
