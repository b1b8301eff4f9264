"""Reference-compatible API façade.

Users of FortuneMU2025/LIDAR_AI_Recommendation_Software can switch to the
PyTorch/CUDA engine with their existing call sites: every public symbol of
the reference's analytics core exists here with the same name, signature
and result shapes, backed by the port's pipeline on the card
(``device="cuda"``, the default, raises without one; pass ``device="cpu"``
to run on the CPU).

Reference surface covered (file:line -> here):
  utils/data_processing.py:8    load_lidar_data
  utils/data_processing.py:127  preprocess_lidar_data
  utils/data_processing.py:231  downsample_point_cloud
  utils/data_processing.py:251  extract_people_positions
  utils/data_processing.py:282  calculate_grid_density
  models/crowd_density_model.py CrowdDensityModel (.analyze,
                                .calculate_risk_level)
  models/crowd_flow_model.py    CrowdFlowModel (.analyze)
  utils/recommendations.py:1    generate_recommendations
  utils/report_generator.py:12  generate_report
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from lidar_ai_recommendation_software_tpu_torch.config import (
    MODULAR_CONFIG, PipelineConfig)
from lidar_ai_recommendation_software_tpu_torch.utils.recommendations import (
    generate_recommendations as _generate_recommendations)


def load_lidar_data(file_path: str) -> np.ndarray:
    """Load a point cloud file -> (n, 3) array
    (utils/data_processing.py:8-125 semantics, all formats + LAS)."""
    from lidar_ai_recommendation_software_tpu_torch.utils.io import load_points
    return load_points(file_path)


def preprocess_lidar_data(points: np.ndarray,
                          config: Optional[PipelineConfig] = None,
                          device: str = "cuda") -> Dict:
    """points -> processed_data dict with the reference's keys
    (utils/data_processing.py:220-227): points / colors / normals /
    clusters / ground_plane / dimensions — computed on ``device``."""
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

    pipe = Pipeline(config or MODULAR_CONFIG, device=device)
    scan = pipe._upload(points)  # not recentred, as the JAX package's is not
    cfg = pipe.fit_capacity(scan)
    cloud = PointCloud.from_tensor(scan, cfg.capacity.max_points)
    processed, people, res = pipe.analyze_device(cloud, cfg)

    mask = processed.mask.cpu().numpy()
    out = {
        "points": processed.points.cpu().numpy()[mask],
        "colors": processed.colors.cpu().numpy()[mask],
        "normals": processed.normals.cpu().numpy()[mask],
        "clusters": processed.labels.cpu().numpy()[mask],
        "ground_plane": processed.ground_plane.cpu().numpy(),
        "dimensions": processed.dimensions,
        # carried so the model façades can reuse the device results
        "_device": (pipe, cfg, processed, people, res),
    }
    return out


def downsample_point_cloud(points: np.ndarray,
                           factor: float = 0.1) -> np.ndarray:
    """Random downsample (utils/data_processing.py:231-249 — NumPy host
    semantics preserved, including np.random state consumption)."""
    if factor >= 1.0:
        return points
    num_keep = max(1, int(len(points) * factor))
    idx = np.random.choice(len(points), num_keep, replace=False)
    return points[idx]


def extract_people_positions(processed_data: Dict) -> np.ndarray:
    """Cluster centroids -> (k, 2) xy (utils/data_processing.py:251-280)."""
    dev = processed_data.get("_device")
    if dev is not None:
        _, _, _, people, _ = dev
        return people.positions.cpu().numpy()[people.mask.cpu().numpy()]
    pts = processed_data["points"]
    labels = processed_data["clusters"]
    out = []
    for cid in np.unique(labels[labels >= 0]):
        out.append(pts[labels == cid].mean(axis=0)[:2])
    return np.array(out) if out else np.zeros((0, 2))


def calculate_grid_density(people_positions: np.ndarray,
                           x_range: Tuple[float, float],
                           y_range: Tuple[float, float],
                           grid_size: float = 1.0):
    """Histogram grid density (utils/data_processing.py:282-328)."""
    if len(people_positions) == 0:
        return None, None, None
    margin = grid_size * 2
    xe = np.arange(x_range[0] - margin, x_range[1] + margin + grid_size,
                   grid_size)
    ye = np.arange(y_range[0] - margin, y_range[1] + margin + grid_size,
                   grid_size)
    hist, xe, ye = np.histogram2d(people_positions[:, 0],
                                  people_positions[:, 1], bins=[xe, ye])
    grid = hist / (grid_size * grid_size)
    return (xe[:-1] + xe[1:]) / 2, (ye[:-1] + ye[1:]) / 2, grid


class CrowdDensityModel:
    """models/crowd_density_model.py façade over the device pipeline."""

    def __init__(self, grid_size: float = 1.0,
                 config: Optional[PipelineConfig] = None):
        self.grid_size = grid_size
        self.config = config or MODULAR_CONFIG

    def analyze(self, processed_data: Dict) -> Dict:
        dev = processed_data.get("_device")
        if dev is not None:
            _, _, _, _, res = dev
            return res.density.to_host_dict()
        # host fallback (processed dict from another source)
        pos = extract_people_positions(processed_data)
        dims = processed_data["dimensions"]
        gx, gy, grid = calculate_grid_density(
            pos, dims["x_range"], dims["y_range"], self.grid_size)
        if grid is None:
            return {"total_people": 0, "avg_density": 0.0,
                    "max_density": 0.0, "density_map": np.zeros((1, 1)),
                    "hotspots": []}
        flat = grid.flatten()
        avg = flat[flat > 0].mean() if np.any(flat > 0) else 0.0
        thr = max(0.5, avg * 1.5)
        fx = np.repeat(gx, len(gy))
        fy = np.tile(gy, len(gx))
        hs = sorted(
            [{"x": fx[i], "y": fy[i], "density": flat[i]}
             for i in np.where(flat >= thr)[0]],
            key=lambda h: h["density"], reverse=True)[:5]
        return {"total_people": len(pos), "avg_density": float(avg),
                "max_density": float(flat.max()), "density_map": grid,
                "hotspots": hs}

    @staticmethod
    def calculate_risk_level(density: float) -> str:
        from lidar_ai_recommendation_software_tpu_torch.utils.report import (
            risk_level)
        return risk_level(density)


class CrowdFlowModel:
    """models/crowd_flow_model.py façade over the device pipeline."""

    def __init__(self, config: Optional[PipelineConfig] = None):
        self.config = config or MODULAR_CONFIG
        self.simulation_params = {
            "flow_field_complexity": 2,
            "bottleneck_count": self.config.flow.bottleneck_count,
            "flow_speed_range": (self.config.flow.speed_min,
                                 self.config.flow.speed_max),
            "random_seed": self.config.flow.random_seed,
        }

    def analyze(self, processed_data: Dict) -> Dict:
        dev = processed_data.get("_device")
        if dev is None:
            raise ValueError(
                "CrowdFlowModel requires processed_data from "
                "preprocess_lidar_data")
        _, _, _, _, res = dev
        return res.flow.to_host_dict()


def generate_recommendations(density_results: Dict,
                             flow_results: Dict) -> Dict:
    """utils/recommendations.py:1-190."""
    return _generate_recommendations(density_results, flow_results)


def generate_report(density_results: Dict, flow_results: Dict,
                    recommendations: Dict, **kwargs) -> str:
    """utils/report_generator.py:12-496 (matplotlib-rendered figures)."""
    from lidar_ai_recommendation_software_tpu_torch.utils.report import (
        generate_report as _gr)
    return _gr(density_results, flow_results, recommendations, **kwargs)
