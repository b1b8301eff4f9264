"""Typed configuration of the PyTorch port of the LiDAR crowd-analytics
engine.

The port's own copy of the JAX package's ``config.py``: the same frozen
dataclasses with the same fields and defaults, so ``dataclasses.asdict``
of a configuration is equal in both packages (the tests hold it). Every
"magic number" scattered through the reference implementation is lifted
into one place here, so the whole pipeline is driven by a single frozen
dataclass tree.

Reference provenance (file:line into the reference implementation):
  - outlier_sigma=3.0            utils/data_processing.py:155
  - ground_percentile=30.0       utils/data_processing.py:164
  - dbscan eps=0.3, min_samples=5  app_simplified.py:107  (monolith variant,
    the reproducible seed-42 configuration; the modular variant instead uses
    an adaptive eps on standardised points, utils/data_processing.py:188-198)
  - grid_size=1.0                models/crowd_density_model.py:14
  - density radius=2.0 m, cell area 4 m^2   app_simplified.py:279-281
  - hotspot threshold max(0.5, 1.5*avg), top 5   models/crowd_density_model.py:67-82
  - risk bands 1.0/2.5/4.0       models/crowd_density_model.py:110-117
  - flow speed band (0.2, 1.5)   models/crowd_flow_model.py:24
  - flow swirl complexity: 2 (modular, crowd_flow_model.py:22) /
    0.3 (monolith, app_simplified.py:380)
  - bottleneck_count=3, seed=42  models/crowd_flow_model.py:21-26
  - bottleneck radius 3.0 m damping   models/crowd_flow_model.py:162-165
  - bottleneck rules (modular): speed<=0.5, r=3/r=5 rings, severity
    (grad*5+conv*5)/2 > 1, top 5    models/crowd_flow_model.py:210-277
  - bottleneck rules (monolith): speed<0.3, 3x3 m box, severity
    10*(max-mag)/max >= 3, top 5    app_simplified.py:432-446
  - recommendations thresholds    utils/recommendations.py:22,45,69,94,116,139
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Controls outlier rejection, ground split and person clustering."""

    outlier_sigma: float = 3.0
    ground_percentile: float = 30.0
    # Clustering (DBSCAN-equivalent connected components).
    dbscan_eps: float = 0.3
    dbscan_min_samples: int = 5
    # "modular" scales points with StandardScaler and derives eps adaptively
    # (utils/data_processing.py:188-198); "monolith" clusters raw coordinates
    # with the fixed eps above (app_simplified.py:107).
    variant: str = "monolith"
    min_cluster_points: int = 10  # below this, skip clustering entirely


@dataclasses.dataclass(frozen=True)
class DensityConfig:
    """Crowd-density analysis parameters."""

    grid_size: float = 1.0
    # "histogram": np.histogram2d semantics with 2-cell margin
    #   (utils/data_processing.py:282-328, modular path)
    # "radius": count people within `radius` of each cell centre and divide
    #   by radius-disc bounding area (app_simplified.py:269-281, monolith)
    mode: str = "radius"
    radius: float = 2.0
    radius_area: float = 4.0  # reference divides count by 4 m^2
    margin_cells: int = 2  # histogram mode margin (data_processing.py:305-309)
    hotspot_min_threshold: float = 0.5
    hotspot_avg_multiplier: float = 1.5
    max_hotspots: int = 5
    # LOS risk bands, people/m^2 (crowd_density_model.py:110-117)
    risk_moderate: float = 1.0
    risk_high: float = 2.5
    risk_critical: float = 4.0


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Crowd-flow synthesis + bottleneck detection parameters."""

    grid_size: float = 1.0
    # swirl complexity: monolith uses 0.3 (app_simplified.py:380), modular 2.0
    swirl_complexity: float = 0.3
    swirl_amplitude: float = 0.5
    bottleneck_count: int = 3
    bottleneck_radius: float = 3.0
    speed_min: float = 0.2
    speed_max: float = 1.5
    # monolith scales so max speed == 1.3 (app_simplified.py:409); modular
    # scales by (speed_max-speed_min)/max then clips (crowd_flow_model.py:171-175)
    scale_mode: str = "monolith"  # "monolith" | "modular"
    monolith_max_speed: float = 1.3
    random_seed: int = 42
    # bottleneck detection variant
    variant: str = "monolith"  # "monolith" | "modular"
    # monolith rule (app_simplified.py:432-446)
    mono_slow_speed: float = 0.3
    mono_box_halfwidth: float = 3.0
    mono_fast_speed: float = 0.5
    mono_min_severity: int = 3
    # modular rule (crowd_flow_model.py:210-277)
    mod_slow_speed: float = 0.5
    mod_near_radius: float = 3.0
    mod_far_radius: float = 5.0
    mod_min_near: int = 5
    mod_min_far: int = 3
    mod_min_severity: float = 1.0
    max_bottlenecks: int = 5
    # temporal tracking (models/temporal.py — no reference counterpart):
    # clusters whose centroid sits below this height over the venue floor
    # are terrain speckle, excluded from NN tracking
    track_min_height: float = 0.3
    track_max_speed: float = 3.0
    # multi-frame sequences only: a per-pair velocity sample survives iff
    # it agrees (L2) with the same person's estimate from an adjacent
    # frame pair within this tolerance — pedestrians accelerate ~1 m/s^2,
    # so genuine frame-to-frame change is small while cluster merge/split
    # identity swaps produce O(1 m/s) jumps
    track_consistency_tol: float = 0.75


@dataclasses.dataclass(frozen=True)
class RecommendationConfig:
    """Rule thresholds for the recommendations engine
    (utils/recommendations.py)."""

    hotspot_critical_density: float = 3.0
    hotspot_high_density: float = 2.0
    venue_avg_density: float = 2.5
    bottleneck_critical_severity: int = 7
    bottleneck_significant_severity: int = 4
    slow_flow_speed: float = 0.5


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static capacities: XLA needs static shapes, so every dynamically-sized
    collection in the reference (people, grid cells, neighbors, clusters)
    becomes a fixed-capacity padded tensor with a validity mask."""

    max_points: int = 16384          # padded point capacity (pow2-friendly)
    max_people: int = 512            # padded people/cluster capacity
    grid_cells_x: int = 64           # density/flow grid static capacity
    grid_cells_y: int = 64
    # hash-grid neighbor search (generic ball query path)
    bucket_capacity: int = 32        # max points scanned per voxel bucket
    # clustering buffer: non-ground points are compacted into a buffer of
    # this capacity before DBSCAN (0 = same as max_points). The all-pairs
    # path is quadratic in this, and ~30% of points are ground.
    cluster_capacity: int = 0
    # dense 2.5D column grid (clustering hot path, ops/columns.py)
    cluster_cells_x: int = 128       # xy columns (static)
    cluster_cells_y: int = 128
    cluster_column_cap: int = 32     # max points per xy column (the
                                     # pipeline auto-doubles on overflow)
    # label propagation
    max_cc_iters: int = 40           # connected-components sweep cap
    # coarse-bucketed people-radius count (ops/bucket_density.py): max
    # people per radius-sized coarse cell. Engaged when cells x people
    # pair-tests pass BUCKETED_MIN_PAIRS; the pipeline auto-doubles on
    # overflow (exactness guard, same contract as cluster_column_cap).
    density_bucket_cap: int = 32


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration for one analytics pipeline instance."""

    preprocess: PreprocessConfig = PreprocessConfig()
    density: DensityConfig = DensityConfig()
    flow: FlowConfig = FlowConfig()
    recommend: RecommendationConfig = RecommendationConfig()
    capacity: CapacityConfig = CapacityConfig()
    # compute dtype for point math; density MAE parity is asserted in tests
    dtype: str = "float32"

    def with_capacity(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(
            self, capacity=dataclasses.replace(self.capacity, **kw)
        )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# The configuration matching the reference's reproducible seed-42 monolith
# path (app_simplified.py) — used by the golden-pipeline tests.
MONOLITH_CONFIG = PipelineConfig()

# The modular (utils/ + models/) configuration.
MODULAR_CONFIG = PipelineConfig(
    preprocess=PreprocessConfig(variant="modular"),
    density=DensityConfig(mode="histogram"),
    flow=FlowConfig(swirl_complexity=2.0, scale_mode="modular", variant="modular"),
)
