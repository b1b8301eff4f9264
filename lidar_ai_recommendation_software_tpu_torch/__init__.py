"""LiDAR crowd analytics in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

The port of the JAX package ``lidar_ai_recommendation_software_tpu``,
which stays the reference it is tested against. This package imports
``torch`` and never ``jax``. It reuses the JAX package's jax-free host
modules by importing them: ``config`` (``PipelineConfig``,
``MONOLITH_CONFIG``, ``MODULAR_CONFIG``), ``synthetic`` and
``utils.recommendations``.

It covers ``Pipeline.analyze`` under both configurations for clouds whose
clustering buffer holds at most 32,768 points (clouds of up to 40,960
points): preprocess, all-pairs DBSCAN-equivalent clustering, people
extraction, the density grid (the ``radius_count`` CUDA kernel) and the
flow field with its bottlenecks.

State shared with the JAX package: the pipeline has no learned
parameters. What it shares is the frozen ``PipelineConfig``, imported as
it is, and the bottleneck uniforms, drawn with the same
``np.random.RandomState(seed)``. Mapping the CrowdNet parameter tree
(``assets/crowdnet_tiny.npz``) onto torch modules comes with the neural
path.
"""

__version__ = "0.1.0"

from lidar_ai_recommendation_software_tpu.config import (  # noqa: F401
    MODULAR_CONFIG,
    MONOLITH_CONFIG,
    PipelineConfig,
)
from lidar_ai_recommendation_software_tpu.synthetic import (  # noqa: F401
    sample_venue,
    scaled_venue,
)
