"""The PyTorch port on an NVIDIA GPU: the column-table kernels,
``place_dense``, ``fps`` and ``sa_mlp_pool`` against their plain versions,
and the analytic and the neural pipeline through the CUDA kernels against
the port's own CPU run. Skipped without a card.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: integers and density grids exact; flow vectors, speeds and
centroids within 1e-5 (sums and sin/cos round differently on the card).
``place_dense`` and ``fps`` are bit-equal to their plain versions;
``sa_mlp_pool`` agrees within 2e-5 of 1 + |value| in float32 and 2e-2 with
bfloat16 operands (the sums run in another order, and an operand rounded to
bfloat16 can fall the other way); CrowdNet's maps within 1e-4.
"""

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch import (
    MODULAR_CONFIG, MONOLITH_CONFIG, NeuralPipeline, sample_venue,
    scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.ops import ccl, clustering
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import columns as C
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as P)
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


def test_place_dense_matches_plain_version(cuda_device):
    rng = np.random.RandomState(3)
    n, k = 200_000, 9000
    ids = np.sort(rng.randint(-2, k + 700, n)).astype(np.int32)
    clipped = np.clip(ids, 0, place.padded_slots(k) - 1)
    valid = np.concatenate([clipped[1:] != clipped[:-1], [True]])
    chans = rng.uniform(-1e4, 1e4, (7, n)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (ids, valid, chans)]
    kernels.reset_launch_counts()
    for v in (args[1], torch.zeros_like(args[1])):
        got = place.place_dense(args[0], v, args[2], k)
        want = place.place_dense_reference(args[0], v, args[2], k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert kernels.LAUNCHES["place_dense"] == 2
    assert got[0].shape == (7, 9216) and not got[1].any()


def test_centroid_routes_agree_on_card(cuda_device, monkeypatch):
    rng = np.random.RandomState(7)
    pts = torch.from_numpy(rng.uniform(-30, 30, (50_000, 3)).astype(
        np.float32)).to(cuda_device)
    labels = torch.from_numpy(rng.randint(-1, 900, 50_000).astype(
        np.int32)).to(cuda_device)
    want = clustering.cluster_centroids(pts, labels, 1024)
    monkeypatch.setattr(clustering, "SEGSUM_MAX_POINTS", 1000)
    kernels.reset_launch_counts()
    got = clustering.cluster_centroids(pts, labels, 1024)
    assert kernels.LAUNCHES["place_dense"] == 1
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])
    assert float((got[0] - want[0]).abs().max()) <= TOL


@pytest.mark.parametrize("n,m", [(3000, 300), (20_000, 64), (60_000, 32)],
                         ids=["cloud_in_shared_memory", "cache_in_shared",
                              "cache_in_device_memory"])
def test_fps_matches_plain_version(cuda_device, n, m):
    rng = np.random.RandomState(n)
    pts = torch.from_numpy(rng.uniform(-20, 20, (2, n, 3)).astype(
        np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(2, n) > 0.2).to(cuda_device)
    kernels.reset_launch_counts()
    got = P.fps(pts, mask, m)
    assert torch.equal(got, P.fps_reference(pts, mask, m))
    one = P.fps(pts[1], mask[1], m, start_index=5)
    assert torch.equal(one, P.fps_reference(pts[1], mask[1], m, 5))
    assert kernels.LAUNCHES["fps_batched"] == 1
    assert kernels.LAUNCHES["fps_single"] == 1
    with pytest.raises(TypeError):
        P.fps_single(pts[0].double(), mask[0], m)
    with pytest.raises(ValueError):
        P.fps_single(pts[0], mask[0], m, start_index=n)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
def test_sa_mlp_pool_matches_plain_version(cuda_device, dtype, tol):
    rng = np.random.RandomState(1)
    for m, k, cin, hidden in ((510, 32, 3, (32, 32, 64)),
                              (128, 32, 67, (64, 64, 128)),
                              (37, 20, 6, (16, 8, 24))):
        g = torch.from_numpy(rng.randn(m, k, cin).astype(np.float32) * 0.5
                             ).to(cuda_device)
        v = torch.from_numpy(rng.rand(m, k) > 0.3).to(cuda_device)
        v[0] = False
        dims = [cin] + list(hidden)
        w = [(torch.from_numpy((rng.randn(a, b) * 0.2).astype(np.float32)
                               ).to(cuda_device),
              torch.from_numpy((rng.randn(b) * 0.1).astype(np.float32)
                               ).to(cuda_device))
             for a, b in zip(dims[:-1], dims[1:])]
        kernels.reset_launch_counts()
        got = P.sa_mlp_pool(g, v, w, compute_dtype=dtype)
        want = P.sa_mlp_pool_reference(g, v, w, dtype)
        assert kernels.LAUNCHES["sa_mlp_pool"] == 1
        assert got.shape == (m, hidden[-1]) and not got[0].any()
        assert float(((got - want).abs() / (1 + want.abs())).max()) <= tol
    with pytest.raises(ValueError, match="multiples of 8"):
        P.sa_mlp_pool(g, v, [(w[0][0][:, :12].contiguous(), w[0][1][:12]),
                             (w[1][0][:12].contiguous(), w[1][1]), w[2]])


def test_neural_card_matches_cpu(cuda_device):
    cloud = sample_venue(n_points=4096, n_people=50, seed=42)
    kernels.reset_launch_counts()
    card = NeuralPipeline(device="cuda").analyze(cloud)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fps_batched"] == 2
    assert kernels.LAUNCHES["sa_mlp_pool"] == 2
    cpu = NeuralPipeline(device="cpu").analyze(cloud)
    assert card["density"]["total_people"] == cpu["density"]["total_people"]
    assert card["density"]["total_people"] == 24
    for key in ("density_map",):
        np.testing.assert_allclose(card["density"][key], cpu["density"][key],
                                   atol=1e-4)
    np.testing.assert_allclose(card["flow"]["flow_vectors"]["vectors"],
                               cpu["flow"]["flow_vectors"]["vectors"],
                               atol=1e-4)
    assert card["flow"]["bottlenecks"] == cpu["flow"]["bottlenecks"]
