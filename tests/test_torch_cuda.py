"""The PyTorch port on an NVIDIA GPU: the pipeline through the CUDA kernel
against the port's own CPU run. Skipped without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: integers and density grids exact; flow vectors, speeds and
centroids within 1e-5 (sums and sin/cos round differently on the card).
"""

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch import (
    MODULAR_CONFIG, MONOLITH_CONFIG, sample_venue)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture(scope="module")
def venue():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return sample_venue()


@pytest.mark.parametrize("config", [MONOLITH_CONFIG, MODULAR_CONFIG],
                         ids=["monolith", "modular"])
def test_card_matches_cpu(venue, config):
    kernels.reset_launch_counts()
    card = Pipeline(config, device="cuda").analyze(venue)
    torch.cuda.synchronize()
    if config.density.mode == "radius":
        assert kernels.LAUNCHES["radius_count"] > 0
    cpu = Pipeline(config, device="cpu").analyze(venue)
    np.testing.assert_array_equal(card["processed"].labels.cpu().numpy(),
                                  cpu["processed"].labels.numpy())
    for key in ("total_people", "hotspots", "origin"):
        assert card["density"][key] == cpu["density"][key], key
    np.testing.assert_array_equal(card["density"]["density_grid"],
                                  cpu["density"]["density_grid"])
    assert card["flow"]["bottlenecks"] == cpu["flow"]["bottlenecks"]
    assert card["flow"]["dominant_direction"] == \
        cpu["flow"]["dominant_direction"]
    assert abs(card["flow"]["avg_speed"] - cpu["flow"]["avg_speed"]) < TOL
    np.testing.assert_allclose(card["flow"]["flow_vectors"]["vectors"],
                               cpu["flow"]["flow_vectors"]["vectors"],
                               atol=TOL)
    np.testing.assert_allclose(card["people"].positions.cpu().numpy(),
                               cpu["people"].positions.numpy(), atol=TOL)


def test_golden_values_on_card(venue):
    out = Pipeline(device="cuda").analyze(venue)
    d, f = out["density"], out["flow"]
    assert d["total_people"] == 446
    assert d["max_density"] == 3.5
    assert f["dominant_direction"] == "E"
    assert [b["severity"] for b in f["bottlenecks"]] == [8, 8, 8, 7, 7]
