"""The centroid routes of ``ops/clustering.py::cluster_centroids`` inside
``Pipeline.analyze`` on the card: a scan whose buffer is above
``SEGSUM_MAX_POINTS`` packs its segment ends with one ``place_dense``
launch, one below it reads them by index, and neither route reads the
device inside its ``density.centroids`` span. Skipped without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_place_dense_card.py -q
"""

import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch reports host reads only "
                    "for CUDA tensors, and place_dense has no CPU kernel")
    return Pipeline(device="cuda")


@pytest.mark.parametrize("points, route", [(3_000_000, "place_dense"),
                                           (100_000, "indexed")])
def test_one_analyze_records_its_route_and_no_host_read(card, points, route):
    scan = scaled_venue(points)
    cap = card.fit_capacity(scan).capacity
    assert (cap.max_points > clustering.SEGSUM_MAX_POINTS) == (
        route == "place_dense")
    card.analyze(scan)  # each shape's first call
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profiling.tracing() as rec:
        card.analyze(scan)
    torch.cuda.synchronize()
    (one,) = rec.scans
    (cents,) = [sp for sp in one.spans if sp.name == "density.centroids"]
    assert cents.attrs == {"route": route, "rows": cap.max_points,
                           "slots": cap.max_people}
    # the route's counter alone: no host read inside the span
    assert cents.counters == {"density.routes." + route: 1}
    assert kernels.LAUNCHES["place_dense"] == (route == "place_dense")
