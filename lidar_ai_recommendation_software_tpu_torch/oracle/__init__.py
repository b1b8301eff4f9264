"""CPU NumPy/SciPy oracle (reference-faithful) implementations."""

from lidar_ai_recommendation_software_tpu_torch.oracle import (  # noqa: F401
    reference)
