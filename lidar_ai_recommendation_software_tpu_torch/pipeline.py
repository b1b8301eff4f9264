"""End-to-end analytics pipeline on one device.

``analyze_cloud`` runs preprocess -> people extraction -> density -> flow
on the device; the host sizes the static capacities, re-runs with larger
ones when a capacity overflowed, converts the device results into
reference-shaped dicts and runs the rule-based recommendation engine.
Each call records its stages as ``utils.profiling`` spans (``pipeline.*``),
which a ``profiling.tracing()`` session keeps as one scan.
``analyze_sequence`` does the same for the last of a sequence of frames
and measures the flow by tracking people over all of them
(``models/temporal.py``).

Usage:
    pipe = Pipeline(MONOLITH_CONFIG, device="cuda")
    results = pipe.analyze(points_np)        # host-facing dicts
    results = pipe.analyze_sequence([frame0, frame1, frame2], dt=0.5)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.config import (
    MONOLITH_CONFIG, PipelineConfig)
from lidar_ai_recommendation_software_tpu_torch.utils import profiling
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage
from lidar_ai_recommendation_software_tpu_torch.utils.recommendations import (
    generate_recommendations)
from lidar_ai_recommendation_software_tpu_torch.models import (
    density as density_mod)
from lidar_ai_recommendation_software_tpu_torch.models import flow as flow_mod
from lidar_ai_recommendation_software_tpu_torch.models import (
    temporal as temporal_mod)
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.preprocess import preprocess
from lidar_ai_recommendation_software_tpu_torch.types import (
    AnalysisResults, People, PointCloud)


def analyze_cloud(cloud: PointCloud, uniforms: torch.Tensor,
                  config: PipelineConfig) -> tuple:
    """The device program: (processed, people, AnalysisResults)."""
    processed = preprocess(cloud, config)
    people = density_mod.extract_people(processed, config)
    dres = density_mod.analyze_density(processed, people, config)
    fres = flow_mod.analyze_flow(processed, people, uniforms, config)
    return processed, people, AnalysisResults(density=dres, flow=fres)


def people_of_cloud(cloud: PointCloud, config: PipelineConfig) -> tuple:
    """The tracking program: preprocess and people extraction, no density
    or flow: (processed, people). What each earlier frame of a sequence
    needs."""
    processed = preprocess(cloud, config)
    return processed, density_mod.extract_people(processed, config)


def restore_offset(offset: np.ndarray, *results: Dict) -> None:
    """Add the recentring ``offset`` back to the coordinates of each
    density or flow dict of ``results``, in place: the origin, hotspots,
    bottlenecks and flow-vector positions it holds. Nothing where the
    offset is zero, so the positions stay the float32 arrays the device
    results give."""
    if not offset.any():
        return
    ox, oy = float(offset[0]), float(offset[1])
    for res in results:
        if "origin" in res:
            res["origin"] = (res["origin"][0] + ox, res["origin"][1] + oy)
        for spot in res.get("hotspots", []) + res.get("bottlenecks", []):
            spot["x"] += ox
            spot["y"] += oy
        if "flow_vectors" in res:
            vectors = res["flow_vectors"]
            vectors["positions"] = vectors["positions"] + np.array([ox, oy])


def _recentre(scan: torch.Tensor, offset: np.ndarray) -> torch.Tensor:
    """``scan`` less ``offset``, on the scan's device; ``scan`` itself
    where the offset is zero."""
    if not offset.any():
        return scan
    return scan - torch.tensor(offset, device=scan.device)


@dataclasses.dataclass(frozen=True)
class MeasuredScan:
    """A scan with its extent: ``points`` (N, 3) on some device,
    ``extent`` (2, 3) on the same device, the x, y, z minima over the
    maxima, and ``host``, its NumPy copy."""

    points: torch.Tensor
    extent: torch.Tensor
    host: np.ndarray

    def __len__(self) -> int:
        return self.points.shape[0]


def measure_scan(points) -> MeasuredScan:
    """The extent of ``points`` (a NumPy array, taken by torch on the CPU,
    or a float tensor) in one reduction on the points' device and one
    host read; a ``MeasuredScan`` is returned as it is. Minima and maxima
    are exact, in the points' own dtype (float32 or float64; other NumPy
    dtypes become float64)."""
    if isinstance(points, MeasuredScan):
        return points
    if not isinstance(points, torch.Tensor):
        points = np.asarray(points)
        if points.dtype not in (np.float32, np.float64):
            points = points.astype(np.float64)
        points = torch.from_numpy(np.ascontiguousarray(points))
    extent = torch.stack(torch.aminmax(points, dim=0))
    return MeasuredScan(points, extent, extent.cpu().numpy())


def column_keys(points: torch.Tensor, mins: torch.Tensor, cell: float,
                ccx: int, ccy: int) -> torch.Tensor:
    """(N, 2) int64 clustering columns of ``points``, computed on their
    device bit for bit as NumPy's ``clip(((xy - mins) / cell).astype(
    int64), 0, (ccx, ccy) - 1)`` in the points' dtype: ``mins`` a tensor
    on that device, and ``cell`` divided as a tensor there too (CUDA
    divides by a host scalar as a multiply by its reciprocal, which moves
    the last bit of a quotient, and a point on a column edge to the next
    column)."""
    cell_t = torch.full((), float(cell), dtype=points.dtype,
                        device=points.device)
    keys = ((points[:, :2] - mins[:2]) / cell_t).to(torch.int64)
    keys[:, 0].clamp_(0, ccx - 1)
    keys[:, 1].clamp_(0, ccy - 1)
    return keys


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

    @stage("setup.pipeline")
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
        self._analyzed = False

    def fit_capacity(self, points) -> PipelineConfig:
        """Size static capacities to the input, as the JAX package does,
        so both packages pick the same ones: point and people capacities
        bucketed to eighths of an octave, the density/flow grid covering
        the venue extent, the clustering buffer the next power of two of
        0.8 n, and the clustering column grid (eps-sized columns, at most
        1,280 a side) with a column cap measured from the points.

        ``points``: a NumPy array (measured by torch on the CPU), a float
        tensor (measured on its own device) or a ``MeasuredScan``. The
        formulas run on the host from the extent; the column occupancy
        is counted where the points are."""
        scan = measure_scan(points)
        cap = self.config.capacity
        n = len(scan)
        max_points = max(cap.max_points, _bucket_eighth_octave(n))

        mins, maxs = scan.host
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

        # Column cap from the measured occupancy: one count of the columns
        # the device will use gives the largest column; +3 covers the
        # slightly different extent of the non-ground subset that is
        # clustered (the overflow retry guards exactness).
        if n > 32768:  # column path only (small sets take the all-pairs)
            cell = max(eps, (maxs[:2] - mins[:2]).max() / (min(ccx, ccy)
                                                           - 1e-3))
            keys = column_keys(scan.points, scan.extent[0], cell, ccx, ccy)
            counts = torch.zeros(ccx * ccy, dtype=torch.int32,
                                 device=keys.device)
            # not bincount: on the card it reads the keys' range to the host
            counts.index_add_(0, keys[:, 0] * ccy + keys[:, 1],
                              counts.new_ones(1).expand(n))
            max_occ = int(counts.max())
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

    @classmethod
    def recentring_offset(cls, points: np.ndarray,
                          extent: Optional[np.ndarray] = None
                          ) -> np.ndarray:
        """The (3,) offset that recentring subtracts from ``points``: their
        xy mean in float64, rounded to whole metres, where some |x| or |y|
        exceeds ``RECENTER_THRESHOLD``; zeros elsewhere. ``extent``, the
        minima over the maxima where they are measured already, holds the
        largest magnitudes at its ends."""
        ends = np.asarray(points if extent is None else extent)
        offset = np.zeros(3)
        if np.abs(ends[:, :2]).max() > cls.RECENTER_THRESHOLD:
            offset[:2] = np.round(
                np.asarray(points, dtype=np.float64)[:, :2].mean(axis=0))
        return offset

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

    @staticmethod
    def _device_run(run, cloud: PointCloud, cfg: PipelineConfig,
                    reason: str) -> tuple:
        """``run(cloud, cfg)`` in a ``pipeline.device`` span; ``reason``
        is "first" or the overflow that made this run a re-run, counted as
        ``pipeline.reruns.<reason>``."""
        with stage("pipeline.device", reason=reason):
            if reason != "first":
                profiling.count("pipeline.reruns." + reason)
            return run(cloud, cfg)

    @staticmethod
    def _guard(overflow: torch.Tensor) -> int:
        """An overflow count on the host: the read waits for the device
        work queued before it."""
        with stage("pipeline.guard"):
            return int(overflow)

    def _run_exact(self, run, cloud: PointCloud, cfg: PipelineConfig
                   ) -> tuple:
        """``run(cloud, cfg)``, a tuple that starts (processed, people),
        re-run under grown capacities until nothing overflows: the
        clustering's doubled while it overflows a capacity (a full column
        or the buffer), then the people capacity grown to the next power
        of two that holds every cluster (the reference never drops one).
        Returns the last run's output and its config."""
        out = self._device_run(run, cloud, cfg, "first")
        while (dropped := self._guard(out[0].cluster_overflow)) > 0:
            grown = self._grown_cluster_cfg(cfg)
            if grown is None:
                raise RuntimeError(self._OVERFLOW_MSG.format(n=dropped))
            cfg = grown
            out = self._device_run(run, cloud, cfg, "cluster_overflow")
        while (dropped := self._guard(out[1].overflow)) > 0:
            need = cfg.capacity.max_people + dropped
            cfg = cfg.with_capacity(
                max_people=1 << max(1, (need - 1).bit_length()))
            out = self._device_run(run, cloud, cfg, "people_overflow")
        return out, cfg

    def analyze(self, points: np.ndarray) -> Dict:
        """NumPy points in, reference-shaped result dicts out."""
        with stage("pipeline.analyze", points=len(points),
                   first=not self._analyzed):
            self._analyzed = True
            return self._analyze(points)

    def _upload(self, points: np.ndarray) -> torch.Tensor:
        """A scan's one copy to the pipeline's device, for every entry
        point: the first three columns of ``points`` as float64, in a
        ``pipeline.upload`` span (``bytes``, ``pinned``)."""
        with stage("pipeline.prepare"):
            points = np.ascontiguousarray(
                np.asarray(points, dtype=np.float64)[:, :3])
        with stage("pipeline.upload", pinned=False, bytes=points.nbytes):
            return torch.from_numpy(points).to(self.device)

    def _ingest(self, points: np.ndarray
                ) -> Tuple[PointCloud, PipelineConfig, np.ndarray]:
        """The scan crosses to the device once (``_upload``), and
        everything sized from it is measured there: (cloud, config,
        offset), the offset the recentring subtracted (zeros when it did
        not engage). Host reads: the extent, and above 32,768 points the
        largest column count; a recentred scan adds the offset's copy and
        a second extent."""
        scan = self._upload(points)
        with stage("pipeline.fit", device=scan.device.type):
            measured = measure_scan(scan)
            offset = self.recentring_offset(points, measured.host)
            if offset.any():
                profiling.count("pipeline.recentred")
                measured = measure_scan(_recentre(scan, offset))
            cfg = self.fit_capacity(measured)
            cloud = PointCloud.from_tensor(measured.points,
                                           cfg.capacity.max_points)
        return cloud, cfg, offset

    def _analyze(self, points: np.ndarray) -> Dict:
        cloud, cfg, offset = self._ingest(points)
        (processed, people, res), cfg = self._run_exact(
            self.analyze_device, cloud, cfg)
        # A coarse bucket of the bucketed density count overflowed: double
        # its cap and re-run (it ends: a cap of max_people holds everyone).
        while self._guard(res.density.radius_overflow) > 0:
            cfg = cfg.with_capacity(density_bucket_cap=min(
                cfg.capacity.max_people,
                cfg.capacity.density_bucket_cap * 2))
            processed, people, res = self._device_run(
                self.analyze_device, cloud, cfg, "density_bucket")
        with stage("pipeline.readback"):
            density_results = res.density.to_host_dict()
            flow_results = res.flow.to_host_dict()
            restore_offset(offset, density_results, flow_results)
        with stage("pipeline.recommend"):
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

    def analyze_sequence(self, frames: Sequence[np.ndarray],
                         dt: float = 1.0) -> Dict:
        """Frames in time order in, ``analyze``'s dicts out: density and
        people from the last frame, flow measured by tracking people over
        every consecutive pair of frames (``models/temporal.py``) in place
        of the synthesised field.

        The last frame takes the one full ``analyze``; every frame takes
        ``people_of_cloud`` under one capacity config fitted to the
        largest frame on the pipeline's device (the last frame's people
        from its ``analyze`` when their capacity is that config's), with
        ``analyze``'s overflow guards. Only person-like clusters
        (``flow.track_min_height`` above the floor) are tracked.
        ``tracked_people`` in the result holds them, (T, K, ...).

        Where a frame's clusters outgrow the config's people capacity,
        every frame is extracted again under the grown config: all frames'
        people have one capacity, and the flow is what the JAX package
        computes when it fits that config first (its own
        ``analyze_sequence`` fails to stack frames of two capacities).

        One call is one ``pipeline.sequence`` span (``frames``,
        ``points``), the root of its scan in a ``profiling.tracing()``
        session: the last frame's ``pipeline.analyze`` inside it, then
        ``sequence.fit`` (``device``: the largest frame's fit), a
        ``sequence.frame`` (``t``) for each earlier frame's extraction,
        with the counter ``sequence.restarts`` where a frame's people
        outgrow the capacity, and ``temporal.flow``. Each frame crosses
        to the device once a call, recentred as the last frame was, in a
        ``pipeline.upload`` span under the span that first needs it."""
        with stage("pipeline.sequence", frames=len(frames),
                   points=sum(len(f) for f in frames)):
            return self._analyze_sequence(frames, dt)

    def _analyze_sequence(self, frames: Sequence[np.ndarray],
                          dt: float) -> Dict:
        if len(frames) < 2:
            return self.analyze(frames[0])
        out = self.analyze(frames[-1])
        processed = out["processed"]
        offset = out["coordinate_offset"]
        min_h = self.config.flow.track_min_height

        scans: Dict[int, torch.Tensor] = {}  # the frames on the device

        def scan_of(t: int) -> torch.Tensor:
            if t not in scans:
                scans[t] = _recentre(self._upload(frames[t]), offset)
            return scans[t]

        # the largest frame is measured where the points go, as ``_ingest``
        # measures a scan: torch's CPU operators stall on a busy host
        largest = int(np.argmax([len(f) for f in frames]))
        with stage("sequence.fit", device=self.device.type):
            cfg = self.fit_capacity(scan_of(largest))
        tracked: List[People] = []
        t = 0
        while t < len(frames):
            if (t == len(frames) - 1 and out["people"].positions.shape[0]
                    == cfg.capacity.max_people):
                proc, ppl = processed, out["people"]
            else:
                with stage("sequence.frame", t=t):
                    cloud = PointCloud.from_tensor(
                        scan_of(t), cfg.capacity.max_points)
                    (proc, ppl), grown = self._run_exact(
                        people_of_cloud, cloud, cfg)
                    restart = (grown.capacity.max_people
                               != cfg.capacity.max_people)
                    if restart:
                        profiling.count("sequence.restarts")
                cfg = grown
                if restart:  # every frame again, under the grown config
                    tracked, t = [], 0
                    continue
            tracked.append(ppl.person_like(min_h, proc.mins[2]))
            t += 1

        seq = temporal_mod.stack_people(tracked)
        res = temporal_mod.temporal_flow_multi(
            seq, dt, processed.mins[:2], processed.maxs[:2], cfg)
        flow_results = res.to_host_dict()
        restore_offset(offset, flow_results)
        out["flow"] = flow_results
        out["tracked_people"] = seq
        out["recommendations"] = generate_recommendations(
            out["density"], flow_results, self.config.recommend)
        return out
