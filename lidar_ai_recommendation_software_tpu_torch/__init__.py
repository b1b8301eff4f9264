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

State shared with the JAX package: the pipeline has no learned
parameters. What it shares is the frozen ``PipelineConfig``, copied field
for field, and the bottleneck uniforms, drawn with the same
``np.random.RandomState(seed)``. Mapping the CrowdNet parameter tree
(``assets/crowdnet_tiny.npz``) onto torch modules comes with the neural
path.
"""

__version__ = "0.1.0"

from lidar_ai_recommendation_software_tpu_torch.config import (  # noqa: F401
    MODULAR_CONFIG,
    MONOLITH_CONFIG,
    PipelineConfig,
)
from lidar_ai_recommendation_software_tpu_torch.synthetic import (  # noqa: F401
    sample_venue,
    scaled_venue,
)
