"""The capacity fit measured where the points are (``pipeline.py``:
``measure_scan``, ``column_keys``, ``Pipeline._ingest``) and the cloud
built on the device (``PointCloud.from_tensor``): bit for bit NumPy's
column keys and the padded cloud NumPy builds, on the CPU and on the
card, and the card's capacities equal to the CPU's. The CPU's capacities
are held to the JAX package's in tests/test_torch_venue.py.

This file imports no JAX, so its card cases also run where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_fit.py -q
"""

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.pipeline import (
    Pipeline, column_keys, measure_scan)
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.types import PointCloud
from port_helpers import (FIT_CLOUDS, FIT_EDGE_CELL, UTM_SHIFT,
                          column_edge_cloud, fit_cloud)

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _on(device: str) -> torch.device:
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the case holds the card's "
                    "division and cast to the CPU's")
    return torch.device(device)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().view(torch.int32).numpy()


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("cell", [FIT_EDGE_CELL, 300 / 1023.999],
                         ids=["fit_cell", "venue_1m_columns"])
def test_column_keys_are_numpys(device, cell):
    """Points on column edges and one ulp either side fall in NumPy's
    columns. A division by a host scalar, which CUDA turns into a multiply
    by its reciprocal, moves hundreds of these keys."""
    points = column_edge_cloud(cell)
    mins = points.min(axis=0)
    ccx = ccy = 1280
    want = np.stack([
        np.clip(((points[:, 0] - mins[0]) / cell).astype(np.int64), 0,
                ccx - 1),
        np.clip(((points[:, 1] - mins[1]) / cell).astype(np.int64), 0,
                ccy - 1)], axis=1)
    dev = _on(device)
    got = column_keys(torch.from_numpy(points).to(dev),
                      torch.from_numpy(mins).to(dev), cell, ccx, ccy)
    assert got.device.type == dev.type
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_the_extent_is_numpys(device, dtype):
    points = fit_cloud("utm_shifted").astype(dtype)
    scan = measure_scan(torch.from_numpy(points).to(_on(device)))
    assert scan.host.dtype == dtype and len(scan) == len(points)
    np.testing.assert_array_equal(scan.host, np.stack(
        [points.min(axis=0), points.max(axis=0)]))
    assert measure_scan(scan) is scan


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("points", [1_000, 45_000, "recentred"])
def test_the_device_cloud_is_from_numpys(device, points):
    """``analyze``'s cloud, cast and padded on the device by
    ``PointCloud.from_tensor``, is the cloud NumPy builds on its own (a
    float32 cast, zero padding, the mask of the first N) bit for bit, for
    a recentred scan too; ``from_numpy`` builds the same."""
    venue = scaled_venue(45_000)
    pts = {1_000: venue[:1_000], 45_000: venue,
           "recentred": venue[:1_000] + UTM_SHIFT}[points]
    cloud, cfg, offset = Pipeline(device=_on(device))._ingest(pts)
    cap = cfg.capacity.max_points
    assert cap > len(pts)
    assert offset.any() == (points == "recentred")
    want = np.zeros((cap, 3), dtype=np.float32)
    want[:len(pts)] = (pts - offset).astype(np.float32)
    want_mask = np.arange(cap) < len(pts)
    assert cloud.points.device.type == device
    assert (cloud.points.dtype, cloud.mask.dtype) == (torch.float32,
                                                      torch.bool)
    np.testing.assert_array_equal(_bits(cloud.points), want.view(np.int32))
    np.testing.assert_array_equal(cloud.mask.cpu().numpy(), want_mask)
    direct = PointCloud.from_tensor(torch.from_numpy(pts - offset).to(
        cloud.points.device), cap)
    np.testing.assert_array_equal(_bits(direct.points), want.view(np.int32))
    host = PointCloud.from_numpy(pts - offset, cap, device=cloud.points.device)
    np.testing.assert_array_equal(_bits(host.points), want.view(np.int32))
    np.testing.assert_array_equal(host.mask.cpu().numpy(), want_mask)
    with pytest.raises(ValueError, match="exceeds capacity"):
        PointCloud.from_tensor(torch.from_numpy(pts), len(pts) - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", FIT_CLOUDS)
def test_the_cards_capacities_are_the_cpus(name):
    """The fit on the card, given the points there or as NumPy, and on
    ``analyze``'s path, picks what the CPU picks."""
    dev = _on("cuda")
    points = fit_cloud(name)
    cpu, card = Pipeline(device="cpu"), Pipeline(device=dev)
    want = cpu.fit_capacity(points)
    assert card.fit_capacity(torch.from_numpy(points).to(dev)) == want
    assert card.fit_capacity(points) == want
    assert card._ingest(points)[1] == cpu._ingest(points)[1]
