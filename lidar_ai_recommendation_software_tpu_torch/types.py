"""Containers passed between the pipeline's stages.

The same fixed-capacity layout as the JAX package's ``types.py``: every
stage exchanges padded tensors plus validity masks, so a result's shapes
depend only on the capacities in ``PipelineConfig``. Here they are plain
dataclasses of ``torch.Tensor``s on one device.

``to_host_dict`` turns device results into the reference-shaped dicts the
recommendation engine and the front-ends read; it gives the same dicts as
the JAX package's counterparts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor on any device."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class PointCloud:
    """A fixed-capacity padded point cloud.

    points: (N, 3) float32, rows past the count are padding.
    mask:   (N,)   bool, True for valid points.
    """

    points: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_numpy(cls, pts: np.ndarray, capacity: Optional[int] = None,
                   device: torch.device | str = "cpu") -> "PointCloud":
        pts = np.asarray(pts, dtype=np.float32)[:, :3]
        n = pts.shape[0]
        cap = capacity or n
        if n > cap:
            raise ValueError(f"point count {n} exceeds capacity {cap}")
        buf = np.zeros((cap, 3), dtype=np.float32)
        buf[:n] = pts
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        return cls(points=torch.from_numpy(buf).to(device),
                   mask=torch.from_numpy(mask).to(device))


@dataclasses.dataclass
class ProcessedCloud:
    """Output of preprocessing.

    ``labels``: -1 for ground/noise, otherwise a dense person-cluster id
    0..n_clusters-1 in first-point order.
    """

    points: torch.Tensor        # (N, 3)  inlier points (padded)
    mask: torch.Tensor          # (N,)    valid & inlier
    colors: torch.Tensor        # (N, 3)  height-ramp RGB
    normals: torch.Tensor       # (N, 3)  synthetic up normals
    labels: torch.Tensor        # (N,)    int32 cluster labels
    ground_mask: torch.Tensor   # (N,)    True where classified as ground
    ground_plane: torch.Tensor  # (4,)    [a, b, c, d] for ax+by+cz+d=0
    mins: torch.Tensor          # (3,)    inlier bbox minimum
    maxs: torch.Tensor          # (3,)    inlier bbox maximum
    n_clusters: torch.Tensor    # ()      int32 number of person clusters
    cluster_overflow: torch.Tensor  # ()  int32 points the clustering
                                    #     buffer dropped (0 = exact)

    @property
    def dimensions(self) -> Dict[str, Any]:
        mins = _np(self.mins)
        maxs = _np(self.maxs)
        return {
            "x_range": (float(mins[0]), float(maxs[0])),
            "y_range": (float(mins[1]), float(maxs[1])),
            "z_range": (float(mins[2]), float(maxs[2])),
            "width": float(maxs[0] - mins[0]),
            "length": float(maxs[1] - mins[1]),
            "height": float(maxs[2] - mins[2]),
        }


@dataclasses.dataclass
class People:
    """Per-cluster centroids padded to capacity K.

    ``overflow`` counts clusters dropped because their dense id exceeded
    K; nonzero means ``count`` undercounts and the pipeline regrows
    ``max_people``."""

    positions: torch.Tensor  # (K, 2) xy centroids
    mask: torch.Tensor       # (K,)   valid people
    z: torch.Tensor          # (K,)   centroid heights
    overflow: torch.Tensor   # ()     int32 clusters dropped

    @property
    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)


@dataclasses.dataclass
class DensityResults:
    """Density analysis. The grid has static capacity (GX, GY); ``nx`` and
    ``ny`` give the number of valid cells, x-major."""

    total_people: torch.Tensor     # ()     int32
    avg_density: torch.Tensor      # ()     float
    max_density: torch.Tensor      # ()     float
    density_grid: torch.Tensor     # (GX, GY) people/m^2
    origin: torch.Tensor           # (2,)   xy of cell (0, 0) lower corner
    nx: torch.Tensor               # ()     int32
    ny: torch.Tensor               # ()     int32
    hotspot_xy: torch.Tensor       # (H, 2) hotspot cell-centre xy
    hotspot_density: torch.Tensor  # (H,)   descending
    hotspot_mask: torch.Tensor     # (H,)   valid hotspots
    radius_overflow: torch.Tensor  # ()     int32 people a bucketed radius
    #                                       count dropped (0 = grid exact)

    def to_host_dict(self) -> Dict[str, Any]:
        nx = int(self.nx)
        ny = int(self.ny)
        grid = _np(self.density_grid)[:nx, :ny]
        hmask = _np(self.hotspot_mask)
        hxy = _np(self.hotspot_xy)
        hd = _np(self.hotspot_density)
        hotspots = [
            {"x": float(hxy[i, 0]), "y": float(hxy[i, 1]),
             "density": float(hd[i])}
            for i in range(len(hmask)) if hmask[i]
        ]
        origin = _np(self.origin)
        return {
            "total_people": int(self.total_people),
            "avg_density": float(self.avg_density),
            "max_density": float(self.max_density),
            "density_map": grid,
            "density_grid": grid.T,  # the monolith stores [j, i]
            "origin": (float(origin[0]), float(origin[1])),
            "hotspots": hotspots,
        }


@dataclasses.dataclass
class FlowResults:
    """Flow analysis over the venue lattice (flat, y-major node order)."""

    positions: torch.Tensor            # (G, 2) node xy
    vectors: torch.Tensor              # (G, 2) flow vectors (m/s)
    magnitudes: torch.Tensor           # (G,)   speeds
    node_mask: torch.Tensor            # (G,)   valid nodes
    avg_speed: torch.Tensor            # ()
    mean_vector: torch.Tensor          # (2,)
    bottleneck_xy: torch.Tensor        # (B, 2)
    bottleneck_severity: torch.Tensor  # (B,)   int32
    bottleneck_mask: torch.Tensor      # (B,)

    def dominant_direction(self) -> str:
        """8-way compass of the mean flow vector."""
        v = _np(self.mean_vector)
        if not np.any(_np(self.node_mask)):
            return "N/A"
        angle = float(np.arctan2(v[1], v[0]) * 180.0 / np.pi)
        directions = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]
        idx = int((angle + 22.5) % 360 / 45)
        return directions[idx]

    def to_host_dict(self) -> Dict[str, Any]:
        m = _np(self.node_mask)
        bm = _np(self.bottleneck_mask)
        bxy = _np(self.bottleneck_xy)
        bs = _np(self.bottleneck_severity)
        return {
            "avg_speed": float(self.avg_speed),
            "dominant_direction": self.dominant_direction(),
            "bottlenecks": [
                {"x": float(bxy[i, 0]), "y": float(bxy[i, 1]),
                 "severity": int(bs[i])}
                for i in range(len(bm)) if bm[i]
            ],
            "flow_vectors": {
                "positions": _np(self.positions)[m],
                "vectors": _np(self.vectors)[m],
                "magnitudes": _np(self.magnitudes)[m],
            },
        }


@dataclasses.dataclass
class AnalysisResults:
    """Full pipeline output (device side)."""

    density: DensityResults
    flow: FlowResults
