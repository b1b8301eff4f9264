"""LiDAR crowd analytics in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

The port of the JAX package ``lidar_ai_recommendation_software_tpu``,
which stays the reference it is tested against. This package imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its
own copies of the JAX package's jax-free host modules, ``config``
(``PipelineConfig``, ``MONOLITH_CONFIG``, ``MODULAR_CONFIG``),
``synthetic`` and ``utils.recommendations``.

It covers ``Pipeline.analyze`` under both configurations: preprocess,
DBSCAN-equivalent clustering (all-pairs up to a 32,768-point buffer, the
column-grid connected components above it, carried by five CUDA kernels),
people extraction, the density grid (the ``radius_count`` CUDA kernel, or
the bucketed count above 2^32 cell x people pair tests) and the flow field
with its bottlenecks. The monolith variant has no size limit of its own
below the column table's device memory (16 bytes per slot of a
(ncx + 2) x (ncy + 2) x column-cap table).

On the centroid route of buffers above 2,097,152 rows the segment ends
are packed by the ``place_dense`` CUDA kernel.

It also covers neural serving, ``NeuralPipeline.analyze``: CrowdNet
(``models/crowdnet.py``), whose set-abstraction layers run farthest-point
sampling and the fused shared MLP with its max-pool as CUDA kernels
(``fps``, ``sa_mlp_pool``), with dense ball grouping in PyTorch between
them.

The CPU oracle, ``oracle.reference``, is the reference's algorithms on
NumPy and SciPy (scikit-learn's DBSCAN, KD-tree and scaler written out):
the yardstick the card's path is held to and the CPU baseline it is
measured against, on any host.

State shared with the JAX package: the analytic pipeline has no learned
parameters. What it shares is the frozen ``PipelineConfig``, copied field
for field, and the bottleneck uniforms, drawn with the same
``np.random.RandomState(seed)``. The neural path shares the serving
checkpoint (``assets/crowdnet_tiny.npz``, a byte-identical copy), whose
flax parameter tree ``models/train.py::params_from_flax`` maps onto the
torch modules.
"""

__version__ = "0.1.0"

from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
    stage as _stage)

with _stage("setup.import"):
    from lidar_ai_recommendation_software_tpu_torch.config import (  # noqa: F401
        MODULAR_CONFIG,
        MONOLITH_CONFIG,
        PipelineConfig,
    )
    from lidar_ai_recommendation_software_tpu_torch.neural import (  # noqa: F401
        NeuralPipeline,
    )
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (  # noqa: F401
        sample_venue,
        scaled_venue,
    )
