"""The PyTorch port on an NVIDIA GPU: the column-table kernels against
their plain versions, and the pipeline through the CUDA kernels against
the port's own CPU run. Skipped without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: integers and density grids exact; flow vectors, speeds and
centroids within 1e-5 (sums and sin/cos round differently on the card).
"""

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch import (
    MODULAR_CONFIG, MONOLITH_CONFIG, sample_venue, scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.ops import ccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import columns as C
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


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _blobs(seed, n, extent, spread, valid_share):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-extent, extent, (max(1, n // 40), 2))
    pts = np.zeros((n, 3), np.float32)
    pts[:, :2] = centers[rng.randint(0, len(centers), n)] + rng.normal(
        0, spread, (n, 2))
    pts[:, 2] = rng.uniform(0, 1.8, n)
    return pts, rng.rand(n) < valid_share


# name -> (points, mask, eps, min_samples, ncx, ncy, column cap)
COLUMN_CASES = {
    "blobs": lambda: (*_blobs(0, 20000, 20.0, 0.15, 0.9), 0.3, 5, 128, 128,
                      64),
    "column_overflow": lambda: (*_blobs(1, 8000, 5.0, 0.1, 1.0), 0.35, 5,
                                32, 32, 8),
    "empty": lambda: (*_blobs(2, 1024, 5.0, 0.1, 0.0), 0.3, 5, 16, 16, 8),
}


@pytest.mark.parametrize("name", sorted(COLUMN_CASES))
def test_column_kernels_match_plain_versions(cuda_device, name):
    pts, mask, eps, ms, ncx, ncy, cap = COLUMN_CASES[name]()
    p = torch.from_numpy(pts).to(cuda_device)
    m = torch.from_numpy(mask).to(cuda_device)
    py, ncells = ncy + 2, (ncx + 2) * (ncy + 2)
    order, scid, cell_start = ccl.sorted_stream(p, m, eps, ncx, ncy)
    kernels.reset_launch_counts()
    fill_args = (p, order, scid, cell_start, ncells, cap)
    tab, pst, ss, ov = C.table_fill(*fill_args)
    want = C.table_fill_reference(*fill_args)
    assert torch.equal(tab.view(torch.int32), want[0].view(torch.int32))
    for got, ref in zip((pst, ss, ov), want[1:]):
        assert torch.equal(got, ref)
    nb = (tab, ss, py, cap, eps)
    counts = C.column_counts(*nb)
    assert torch.equal(counts, C.column_counts_reference(*nb))
    core = (ss >= 0) & (counts >= ms)
    labels0 = torch.where(core, order, C.INT_MAX)
    lab, lab_ref = labels0.clone(), labels0.clone()
    sweeps = C.propagate(tab, ss, pst, py, cap, eps, lab, 320)
    C.propagate_reference(tab, ss, pst, py, cap, eps, lab_ref, 320)
    assert torch.equal(lab, lab_ref)
    bmin = C.border_min(*nb, lab)
    assert torch.equal(bmin, C.border_min_reference(*nb, lab))
    got = C.table_gather(bmin, pst, -1)
    assert torch.equal(got, C.table_gather_reference(bmin, pst, -1))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["propagate"] == sweeps
    for k in ("table_fill", "column_counts", "border_min", "table_gather"):
        assert kernels.LAUNCHES[k] == 1, k
    assert (int(ov) > 0) == (name == "column_overflow")


def test_venue_scale_card_matches_cpu(cuda_device):
    """A 50,000-point venue: the column-grid clustering through the five
    kernels on the card gives the port's CPU result."""
    pts = scaled_venue(50_000)
    kernels.reset_launch_counts()
    card = Pipeline(device="cuda").analyze(pts)
    torch.cuda.synchronize()
    for k in ("table_fill", "table_gather", "column_counts", "border_min",
              "propagate", "radius_count"):
        assert kernels.LAUNCHES[k] > 0, k
    cpu = Pipeline(device="cpu").analyze(pts)
    np.testing.assert_array_equal(card["processed"].labels.cpu().numpy(),
                                  cpu["processed"].labels.numpy())
    assert card["density"]["total_people"] == 2236
    np.testing.assert_array_equal(card["density"]["density_grid"],
                                  cpu["density"]["density_grid"])
    assert card["flow"]["bottlenecks"] == cpu["flow"]["bottlenecks"]
