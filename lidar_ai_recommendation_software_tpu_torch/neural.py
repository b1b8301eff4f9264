"""Neural serving path: CrowdNet inference with reference-shaped outputs.

``NeuralPipeline(checkpoint).analyze(points)`` serves density, flow and
congestion from raw points in one forward pass of CrowdNet
(``models/crowdnet.py``): no clustering and no grid statistics at
inference time. On a card both set-abstraction layers run through the
``fps_batched`` and ``sa_mlp_pool`` CUDA kernels. The counterpart of the
JAX package's ``neural.py``; the host side (downsampling, hotspots,
bottlenecks, compass, recommendations) is numpy and is the same code.

Output contract: the density and flow dicts ``Pipeline.analyze`` emits, so
reports, stores and the recommendation engine are shared.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_ai_recommendation_software_tpu_torch.models.train import (
    BATCHED_SCOPE, expected_flax_shapes, flax_leaves, load_params_npz,
    make_model, params_from_flax)
from lidar_ai_recommendation_software_tpu_torch.utils.recommendations import (
    generate_recommendations)

# The packaged tiny checkpoint, a byte-identical copy of the JAX package's
# (distilled there on synthetic venues).
DEFAULT_CHECKPOINT = "crowdnet_tiny.npz"


def default_checkpoint_path() -> str:
    return os.path.join(os.path.dirname(__file__), "assets",
                        DEFAULT_CHECKPOINT)


def _compass(vx: float, vy: float) -> str:
    """8-way compass of a mean vector."""
    angle = float(np.arctan2(vy, vx) * 180.0 / np.pi)
    directions = ["E", "NE", "N", "NW", "W", "SW", "S", "SE", "E"]
    return directions[int((angle + 22.5) % 360 / 45)]


def _keystr(path) -> str:
    return "".join(f"[{name!r}]" for name in path)


class NeuralPipeline:
    """Host-facing CrowdNet inference with reference-shaped outputs.

    ``checkpoint``: path to a serving ``.npz`` (default: the packaged tiny
    checkpoint). ``device`` is explicit: "cuda" (the default) raises when no
    CUDA device is present; the CPU runs only when asked for by name."""

    def __init__(self, checkpoint: Optional[str] = None,
                 config: PipelineConfig = MONOLITH_CONFIG,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "NeuralPipeline(device='cuda') needs a CUDA device and none "
                "is available; pass device='cpu' to run on the CPU")
        self.config = config
        path = checkpoint or default_checkpoint_path()
        self.params, self.train_config = load_params_npz(path)
        # Checkpoints trained before the dedicated count head lack its
        # parameters. Graft zeros (the two count convolutions mirror the
        # density head's shapes) and count by the density integral in
        # analyze(): degraded but serving.
        self._legacy_count = False
        net = self.params.get(BATCHED_SCOPE, self.params)
        if "density_head" in net and "count_head" not in net:
            logging.getLogger("lidar_tpu.neural").warning(
                "checkpoint %s predates the count head; people counts "
                "fall back to the density integral — retrain with "
                "`lidar-crowd train` for calibrated counts", path)
            for head in ("_hidden", ""):
                net[f"count_head{head}"] = {
                    k: np.zeros_like(v)
                    for k, v in net[f"density_head{head}"].items()}
            self._legacy_count = True
        self.model = make_model(self.train_config)
        self._validate_params(path)
        self.model.load_state_dict(params_from_flax(self.params))
        self.model.to(self.device).eval()
        self._rng = np.random.RandomState(0)

    def _validate_params(self, path: str) -> None:
        """Check the (possibly migrated) checkpoint tree against the
        model's expected shapes, so a format mismatch fails here with a
        named error and not while the weights are loaded."""
        exp_paths = {_keystr((BATCHED_SCOPE, *p)): s for p, s in
                     expected_flax_shapes(self.model).items()}
        got_paths = {_keystr(p): np.shape(v)
                     for p, v in flax_leaves(self.params).items()}
        if exp_paths != got_paths:
            missing = sorted(set(exp_paths) - set(got_paths))[:5]
            extra = sorted(set(got_paths) - set(exp_paths))[:5]
            wrong = sorted(
                k for k in set(exp_paths) & set(got_paths)
                if exp_paths[k] != got_paths[k])[:5]
            raise ValueError(
                f"checkpoint {path!r} does not match the CrowdNet "
                f"parameter tree (format mismatch): "
                f"missing={missing} unexpected={extra} "
                f"wrong_shape={wrong}. Retrain with `lidar-crowd train` "
                f"or pass a compatible checkpoint.")

    # -- device step --------------------------------------------------------

    def padded_cloud(self, points: np.ndarray):
        """The model's input for a cloud: (points (n_cap, 3) float32, mask
        (n_cap,)). Clouds above the model's capacity are cut to a uniform
        random subset without replacement (a numpy stream seeded once, the
        JAX package's); smaller ones are padded with masked zeros."""
        n_cap = self.train_config.n_points
        pts = np.asarray(points, np.float32)
        n = len(pts)
        if n > n_cap:
            keep = self._rng.choice(n, n_cap, replace=False)
            pts = pts[keep]
            n = n_cap
        pad = n_cap - n
        mask = np.zeros(n_cap, bool)
        mask[:n] = True
        if pad:
            pts = np.concatenate(
                [pts, np.zeros((pad, 3), np.float32)], axis=0)
        return pts, mask

    def forward(self, points: np.ndarray, venue_min: np.ndarray,
                venue_size: float) -> Dict[str, np.ndarray]:
        """One forward pass on a batch of one; returns host arrays
        {density (G, G) people/m^2, flow (G, G, 2) m/s, congestion (G, G),
        count ()}."""
        pts, mask = self.padded_cloud(points)
        dev = self.device
        with torch.no_grad():
            out = self.model(
                torch.from_numpy(pts).to(dev)[None],
                torch.from_numpy(mask).to(dev)[None],
                torch.as_tensor(np.asarray(venue_min, np.float32),
                                device=dev)[None],
                torch.as_tensor(np.float32(venue_size), device=dev)[None])
        return {k: v[0].cpu().numpy() for k, v in out.items()}

    # -- host-facing analysis ------------------------------------------------

    def analyze(self, points: np.ndarray) -> Dict:
        """NumPy points in, reference-shaped result dicts out (the contract
        of ``Pipeline.analyze``, minus the per-point tensors the neural
        path never builds)."""
        points = np.asarray(points, dtype=np.float64)[:, :3]
        offset = np.zeros(3)
        if np.abs(points[:, :2]).max() > 4096.0:  # Pipeline.RECENTER_THRESHOLD
            offset[:2] = np.round(points[:, :2].mean(axis=0))
            points = points - offset

        vmin = points[:, :2].min(axis=0)
        vmax = points[:, :2].max(axis=0)
        vsize = float(max(vmax[0] - vmin[0], vmax[1] - vmin[1])) + 1e-6
        out = self.forward(points, vmin.astype(np.float32), vsize)

        g = self.train_config.grid
        cell = vsize / g
        cell_area = cell ** 2
        density = out["density"]
        flow = out["flow"]
        congestion = out["congestion"]

        dc = self.config.density
        # The count comes from the dedicated count head: the density map is
        # trained towards the conditional median and its integral
        # undercounts. Legacy checkpoints (no count head) use that integral
        # anyway.
        if self._legacy_count:
            total_people = int(round(float(density.sum()) * cell_area))
        else:
            total_people = int(round(float(out["count"])))
        venue_area = max(1.0, float((vmax[0] - vmin[0])
                                    * (vmax[1] - vmin[1])))
        avg_density = total_people / venue_area  # monolith semantics
        max_density = float(density.max())

        # the analytic path's hotspot rule: cells >= max(0.5, 1.5 * avg),
        # top 5 by density, x-major tie order
        threshold = max(dc.hotspot_min_threshold,
                        dc.hotspot_avg_multiplier * avg_density)
        flat = density.reshape(-1)
        idx = np.argsort(-flat, kind="stable")[:64]
        hotspots = []
        for i in idx:
            if flat[i] < threshold or len(hotspots) >= dc.max_hotspots:
                break
            ci, cj = divmod(int(i), g)
            hotspots.append({
                "x": float(vmin[0] + (ci + 0.5) * cell + offset[0]),
                "y": float(vmin[1] + (cj + 0.5) * cell + offset[1]),
                "density": float(flat[i])})

        density_results = {
            "total_people": total_people,
            "avg_density": float(avg_density),
            "max_density": max_density,
            "density_map": density,
            "density_grid": density.T,
            "origin": (float(vmin[0] + offset[0]),
                       float(vmin[1] + offset[1])),
            "hotspots": hotspots,
        }

        mags = np.sqrt((flow ** 2).sum(-1))
        mean_vec = flow.mean(axis=(0, 1))
        ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        px = vmin[0] + (ii + 0.5) * cell + offset[0]
        py = vmin[1] + (jj + 0.5) * cell + offset[1]

        flow_results = {
            "avg_speed": float(mags.mean()),
            "dominant_direction": _compass(*mean_vec),
            "bottlenecks": self._bottlenecks(mags, px, py, cell),
            "flow_vectors": {
                "positions": np.stack([px.reshape(-1), py.reshape(-1)],
                                      axis=1),
                "vectors": flow.reshape(-1, 2),
                "magnitudes": mags.reshape(-1),
            },
            "congestion_map": congestion,
        }

        recommendations = generate_recommendations(
            density_results, flow_results, self.config.recommend)
        return {
            "density": density_results,
            "flow": flow_results,
            "congestion": {"map": congestion,
                           "max": float(congestion.max())},
            "coordinate_offset": offset,
            "recommendations": recommendations,
        }

    def _bottlenecks(self, mags: np.ndarray, px, py, cell: float):
        """The monolith's bottleneck rule on the BEV lattice: slow nodes
        (< 0.3 m/s) within a 3 m box of a fast (> 0.5 m/s) node; severity =
        int(10 * (box_max - mag) / box_max)."""
        fc = self.config.flow
        g = mags.shape[0]
        span = max(1, int(np.ceil(fc.mono_box_halfwidth / cell)) - 1)
        box_max = np.zeros_like(mags)
        for dx in range(-span, span + 1):
            for dy in range(-span, span + 1):
                sl = np.zeros_like(mags)
                xs0, xs1 = max(0, -dx), min(g, g - dx)
                ys0, ys1 = max(0, -dy), min(g, g - dy)
                sl[xs0:xs1, ys0:ys1] = mags[xs0 + dx:xs1 + dx,
                                            ys0 + dy:ys1 + dy]
                box_max = np.maximum(box_max, sl)
        sev = np.floor(10.0 * (box_max - mags)
                       / np.maximum(box_max, 1e-12)).astype(int)
        sev = np.minimum(10, sev)
        ok = ((mags < fc.mono_slow_speed) & (box_max > fc.mono_fast_speed)
              & (sev >= fc.mono_min_severity))
        flat_sev = np.where(ok.T.reshape(-1), sev.T.reshape(-1), -1)
        order = np.argsort(-flat_sev, kind="stable")[:fc.max_bottlenecks]
        fx = px.T.reshape(-1)
        fy = py.T.reshape(-1)
        return [{"x": float(fx[i]), "y": float(fy[i]),
                 "severity": int(flat_sev[i])}
                for i in order if flat_sev[i] >= 0]
