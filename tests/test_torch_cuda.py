"""The PyTorch port on an NVIDIA GPU: the column-table kernels,
``place_dense``, ``fps`` and ``sa_mlp_pool`` against their plain versions,
the analytic and the neural pipeline through the CUDA kernels against the
port's own CPU run, CrowdNet's convolution backward and training step, and
the hash grid. Skipped without a card. (``radius_count``'s edge
cases on the card: ``tests/test_torch_radius_count.py`` and
``chip_smoke.py``.)

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Training (``test_training_is_deterministic_and_matches_cpu``) is
bit-identical run to run on the card and within 1e-5 of the CPU's first
gradients; the hash grid is bit-equal to the CPU's.

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
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import eps, kernels
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as P)
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    column_occupancy_cases, dense_tail_cases, dense_tail_label_cases,
    eps_edges_cases, place_dense_cases, sa_mlp_pool_cases, table_fill_cases)

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
    assert kernels.LAUNCHES["eps_edges"] == eps.EPS_LAUNCHES
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


def test_cli_analyze_sample_on_card(venue, tmp_path, capsys):
    """``lidar-crowd-torch analyze sample --device cuda``: the golden
    values in the JSON, ``radius_count`` launched once."""
    import json

    from lidar_ai_recommendation_software_tpu_torch import cli
    kernels.reset_launch_counts()
    out = tmp_path / "out.json"
    assert cli.main(["analyze", "sample", "--device", "cuda", "--json",
                     str(out)]) == 0
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["radius_count"] == 1
    assert "people detected : 446" in capsys.readouterr().out
    got = json.loads(out.read_text())
    d, f = got["density"], got["flow"]
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
# the occupancies that stress the tiled scan: runs across x rows, a sparse
# row between full rows, every column full, the largest cap
COLUMN_CASES.update({case[0].replace(" ", "_"): lambda case=case: case[1:]
                     for case in column_occupancy_cases()})
# the clusterings that stress the tail: labels pointing forward, dropped and
# masked points, an empty stream, N not a multiple of the tile
COLUMN_CASES.update({case[0].replace(" ", "_"): lambda case=case: case[1:]
                     for case in dense_tail_cases()})
# the clouds that stress the fill: every column at or past its cap, every
# point masked, one point, runs across the fill's tiles, a cap of 512
COLUMN_CASES.update({case[0].replace(" ", "_"): lambda case=case: case[1:]
                     for case in table_fill_cases()})


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
    nb = (tab, ss, cell_start, py, cap, eps)
    counts = C.column_counts(*nb)
    assert torch.equal(counts, C.column_counts_reference(*nb))
    core = (ss >= 0) & (counts >= ms)
    labels0 = torch.where(core, order, C.INT_MAX)
    lab, lab_ref = labels0.clone(), labels0.clone()
    launched = C.propagate(tab, ss, pst, py, cap, eps, lab, 320)
    C.propagate_reference(tab, ss, pst, py, cap, eps, lab_ref, 320)
    assert torch.equal(lab, lab_ref)
    bmin = C.border_min(*nb, lab)
    assert torch.equal(bmin, C.border_min_reference(*nb, lab))
    final = torch.where(core, lab, bmin)
    dense, n_clusters = C.dense_tail(final, pst)
    want_dense, want_n = C.dense_tail_reference(final, pst)
    assert torch.equal(dense, want_dense) and torch.equal(n_clusters, want_n)
    torch.cuda.synchronize()
    # one union-find pass: the same launches in every clustering
    assert kernels.LAUNCHES["propagate"] == launched == C.PROPAGATE_LAUNCHES
    for k in ("table_fill", "column_counts", "border_min"):
        assert kernels.LAUNCHES[k] == 1, k
    assert kernels.LAUNCHES["dense_tail"] == C.TAIL_LAUNCHES
    assert (int(ov) > 0) == (name in (
        "column_overflow", "dropped_and_masked_points",
        "every_column_past_its_cap",
        "runs_of_columns_across_the_fill's_tiles", "a_fill_cap_of_512"))
    if name == "every_column_full":
        occ = torch.bincount(ss.long() // cap, minlength=ncells)
        assert int((occ == cap).sum()) == ncx * ncy


def test_venue_scale_card_matches_cpu(cuda_device):
    """A 50,000-point venue: the column-grid clustering through the five
    kernels on the card gives the port's CPU result."""
    pts = scaled_venue(50_000)
    kernels.reset_launch_counts()
    card = Pipeline(device="cuda").analyze(pts)
    torch.cuda.synchronize()
    for k in ("table_fill", "dense_tail", "column_counts", "border_min",
              "propagate", "radius_count"):
        assert kernels.LAUNCHES[k] > 0, k
    assert kernels.LAUNCHES["eps_edges"] == 0  # not the all-pairs backend
    assert set(kernels.LAUNCHES) == {
        "radius_count", "table_fill", "dense_tail", "column_counts",
        "border_min", "propagate", "place_dense", "fps_single",
        "fps_batched", "sa_mlp_pool", "eps_edges"}
    cpu = Pipeline(device="cpu").analyze(pts)
    np.testing.assert_array_equal(card["processed"].labels.cpu().numpy(),
                                  cpu["processed"].labels.numpy())
    assert card["density"]["total_people"] == 2236
    np.testing.assert_array_equal(card["density"]["density_grid"],
                                  cpu["density"]["density_grid"])
    assert card["flow"]["bottlenecks"] == cpu["flow"]["bottlenecks"]


@pytest.mark.parametrize("name", [c[0] for c in table_fill_cases()])
def test_table_fill_matches_plain_version(cuda_device, name):
    """The fill's edge clouds (every column at or past its cap, every
    point masked, one point, runs of columns across the fill's tiles, a
    cap of 512): all four outputs bit-equal to the plain version, one
    launch, and a capture in a CUDA graph whose replay gives the same."""
    pts, mask, eps, _, ncx, ncy, cap = {
        c[0]: c[1:] for c in table_fill_cases()}[name]
    p = torch.from_numpy(pts).to(cuda_device)
    m = torch.from_numpy(mask).to(cuda_device)
    order, scid, cell_start = ccl.sorted_stream(p, m, eps, ncx, ncy)
    args = (p, order, scid, cell_start, (ncx + 2) * (ncy + 2), cap)
    want = C.table_fill_reference(*args)
    kernels.reset_launch_counts()
    got = C.table_fill(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        again = C.table_fill(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["table_fill"] == 2
    for out in (got, again):
        assert torch.equal(out[0].view(torch.int32), want[0].view(torch.int32))
        for g, w in zip(out[1:], want[1:]):
            assert torch.equal(g, w)
    assert (int(want[3]) > 0) == ("past" in name or "512" in name
                                  or "runs" in name)


@pytest.mark.parametrize("name", [c[0] for c in dense_tail_label_cases()])
def test_dense_tail_matches_plain_version(cuda_device, name):
    """Labels fed to the tail as they are (forward and back, at points
    that are not representatives, past N - 1, negative), and a capture in
    a CUDA graph, whose replay gives the same ids."""
    labels, stream = {c[0]: c[1:] for c in dense_tail_label_cases()}[name]
    lab = torch.from_numpy(labels).to(cuda_device)
    pst = torch.from_numpy(stream).to(cuda_device)
    want, want_n = C.dense_tail_reference(lab, pst)
    got, got_n = C.dense_tail(lab, pst)
    assert torch.equal(got, want) and torch.equal(got_n, want_n)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        again, again_n = C.dense_tail(lab, pst)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, want) and torch.equal(again_n, want_n)


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
    # a run of 1,000,000 invalid rows, valid rows first and last in runs
    # that cross every tile, n = 0, C = 1 and 9
    for name, *arrays, kk in place_dense_cases():
        args = [torch.from_numpy(x).to(cuda_device) for x in arrays]
        got = place.place_dense(*args, kk)
        want = place.place_dense_reference(*args, kk)
        for g, w in zip(got, want):
            assert torch.equal(g.contiguous().view(torch.int32),
                               w.contiguous().view(torch.int32)), name


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


@pytest.mark.parametrize("n,m,route",
                         [(3000, 300, "registers"), (13_000, 64, "block"),
                          (20_000, 64, "cluster"), (60_000, 32, "cluster"),
                          (120_000, 16, "stream")],
                         ids=["cloud_in_registers", "cloud_in_shared_memory",
                              "cluster_of_2", "cluster_of_5", "streaming"])
def test_fps_matches_plain_version(cuda_device, n, m, route):
    rng = np.random.RandomState(n)
    pts = torch.from_numpy(rng.uniform(-20, 20, (2, n, 3)).astype(
        np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(2, n) > 0.2).to(cuda_device)
    assert P.fps_plan(n).route == route
    kernels.reset_launch_counts()
    got = P.fps(pts, mask, m)
    assert torch.equal(got, P.fps_reference(pts, mask, m))
    one = P.fps(pts[1], mask[1], m, start_index=n - 5)
    assert torch.equal(one, P.fps_reference(pts[1], mask[1], m, n - 5))
    assert kernels.LAUNCHES["fps_batched"] == 1
    assert kernels.LAUNCHES["fps_single"] == 1
    assert kernels.FPS_ROUTES[route] == 2
    with pytest.raises(TypeError):
        P.fps_single(pts[0].double(), mask[0], m)
    with pytest.raises(ValueError):
        P.fps_single(pts[0], mask[0], m, start_index=n)


REGISTER_EDGES = [1, 31, 33, 100] + [
    t * q + e for t, q in P.REGISTER_SHAPES for e in (0, 1)]


@pytest.mark.parametrize("n", REGISTER_EDGES)
def test_fps_register_route_edges(cuda_device, n):
    """Both sides of every register instantiation's capacity, with a start
    owned by the last thread, a mask, and every point masked."""
    rng = np.random.RandomState(n)
    plan = P.fps_plan(n)
    pts = torch.from_numpy(rng.uniform(-20, 20, (2, n, 3)).astype(
        np.float32)).to(cuda_device)
    mask = torch.from_numpy(rng.rand(2, n) > 0.3).to(cuda_device)
    m, start = min(n, 48) + 2, min(plan.threads, n) - 1
    kernels.reset_launch_counts()
    for msk in (mask, torch.zeros_like(mask)):
        got = P.fps_batched(pts, msk, m, start)
        assert torch.equal(got, P.fps_reference(pts, msk, m, start))
    assert kernels.FPS_ROUTES[plan.route] == 2


def test_fps_one_warp_lattice_ties(cuda_device):
    """Exact ties on a 16 x 32 lattice through the one-warp body."""
    i, j = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    lattice = torch.from_numpy(np.stack(
        [i.ravel(), j.ravel(), np.zeros(512)], 1).astype(np.float32)
    ).to(cuda_device)[None]
    ones = torch.ones(1, 512, dtype=torch.bool, device=cuda_device)
    assert P.fps_plan(512).threads == 32
    got = P.fps_batched(lattice, ones, 256)
    assert torch.equal(got, P.fps_reference(lattice, ones, 256))


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
    # the tiling's edges: K 16, 48 and 128, M = 1, M not a multiple of the
    # tile, Cin = 67; row 0 has only its last neighbour valid, row M // 2
    # none; two runs bit-identical
    with pytest.raises(ValueError, match="multiples of 8"):
        P.sa_mlp_pool(g, v, [(w[0][0][:, :12].contiguous(), w[0][1][:12]),
                             (w[1][0][:12].contiguous(), w[1][1]), w[2]])
    # the tiling's edges: K 16, 48 and 128, M = 1, M not a multiple of the
    # tile, Cin = 67; row 0 has only its last neighbour valid, row M // 2
    # none; two runs bit-identical
    for name, *arrays, w_np in sa_mlp_pool_cases():
        gc, vc = (torch.from_numpy(x).to(cuda_device) for x in arrays)
        wc = [(torch.from_numpy(a).to(cuda_device),
               torch.from_numpy(b).to(cuda_device)) for a, b in w_np]
        got = P.sa_mlp_pool(gc, vc, wc, compute_dtype=dtype)
        want = P.sa_mlp_pool_reference(gc, vc, wc, dtype)
        err = float(((got - want).abs() / (1 + want.abs())).max())
        assert err <= tol, name
        assert torch.equal(got, P.sa_mlp_pool(gc, vc, wc,
                                              compute_dtype=dtype)), name
        assert bool(want[0].any()), name
        assert gc.shape[0] == 1 or not got[gc.shape[0] // 2].any(), name


def test_neural_card_matches_cpu(cuda_device):
    cloud = sample_venue(n_points=4096, n_people=50, seed=42)
    kernels.reset_launch_counts()
    card = NeuralPipeline(device="cuda").analyze(cloud)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fps_batched"] == 2
    assert kernels.FPS_ROUTES["registers"] == 2
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


def test_conv_backward_in_full_float32(cuda_device):
    """CrowdNet's trunk convolution (4 x 201 x 64 x 64 -> 128, 3 x 3) on
    the card, forward and backward, under the global defaults (TF32 on):
    its weight and input gradients equal a float64 CPU reference within
    float32 rounding, 1e-4 of the sum of the absolute products; TF32 rounds
    each product to 10 bits (5e-4)."""
    from lidar_ai_recommendation_software_tpu_torch.models import crowdnet
    assert torch.backends.cudnn.allow_tf32  # the default the fix must beat
    rng = np.random.RandomState(5)
    conv = torch.nn.Conv2d(201, 128, 3, padding=1)
    x = torch.from_numpy(rng.randn(4, 201, 64, 64).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 128, 64, 64).astype(np.float32))
    card = conv.to(cuda_device)
    xc = x.to(cuda_device).requires_grad_()
    crowdnet._conv(xc, card).backward(g.to(cuda_device))
    x64 = x.double().requires_grad_()
    w64 = conv.weight.detach().cpu().double().requires_grad_()
    torch.nn.functional.conv2d(x64, w64, padding=1).backward(g.double())
    # the same sums over absolute values: the scale of float32 rounding
    xa = x.double().abs().requires_grad_()
    wa = w64.detach().abs().requires_grad_()
    torch.nn.functional.conv2d(xa, wa, padding=1).backward(g.double().abs())
    for name, got, want, scale in (
            ("weight", card.weight.grad, w64.grad, wa.grad),
            ("input", xc.grad, x64.grad, xa.grad)):
        err = float(((got.cpu().double() - want).abs() / scale).max())
        assert err <= 1e-4, (name, err)


def test_row_prefix_sums_reproducible_on_card(cuda_device):
    """The BEV cell sums' float64 prefix of a lone 32,768-long row (the
    pillar z sums of a batch of 4 x 8,192 points): 1,000 reruns on the
    card bit-identical (PyTorch's scan of a lone row is not: its
    device-wide scan adds the tiles' sums in an order that varies), and
    within float64 rounding of the CPU's sequential scan."""
    from lidar_ai_recommendation_software_tpu_torch.models import crowdnet
    row = torch.rand(1, 32768, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    card = row.to(cuda_device)
    first = crowdnet._row_prefix_sums(card)
    differ = sum(int(not torch.equal(crowdnet._row_prefix_sums(card),
                                     first)) for _ in range(1000))
    assert differ == 0
    np.testing.assert_allclose(first.cpu().numpy(),
                               torch.cumsum(row, 1).numpy(), rtol=1e-12)


def test_training_is_deterministic_and_matches_cpu(cuda_device):
    """Two steps on the card twice: bit-identical losses and parameters
    (no float atomics in the backward: the gathers' index_put, the cell
    sums' prefix, cuDNN's deterministic algorithms; no lone-row scan in
    the forward: the pillar sums' prefix); the first step's
    gradients within 1e-5 of the CPU's, tensor by tensor."""
    from lidar_ai_recommendation_software_tpu_torch.models import train
    cfg = train.TrainConfig(batch_size=2, n_points=2048, grid=16,
                            sa1_samples=512, sa2_samples=128)

    def run(device):
        state = train.init_state(cfg, device=device)
        rng = np.random.RandomState(cfg.seed)
        losses, grads = [], None
        for i in range(2):
            kernels.reset_launch_counts()
            m = train.train_step(state, train.batch_tensors(
                train.make_batch(rng, cfg), device), cfg)
            losses.append(float(m["loss"]))
            if i == 0:
                grads = {n: p.grad.cpu() for n, p in
                         state.model.named_parameters()}
            if device != "cpu":
                assert kernels.LAUNCHES["fps_batched"] == 2
                assert kernels.LAUNCHES["sa_mlp_pool"] == 2
        return state, losses, grads

    a, la, ga = run("cuda")
    b, lb, _ = run("cuda")
    assert la == lb
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))
    _, lc, gc = run("cpu")
    assert la[0] == pytest.approx(lc[0], rel=1e-5)
    for name, g in gc.items():
        assert float((ga[name] - g).norm() / g.norm()) <= 1e-5, name


def _hashgrid_clouds():
    rng = np.random.RandomState(12)
    pile = rng.uniform(-8, 8, (6000, 3)).astype(np.float32)
    pile[:, 2] *= 0.1
    pile[:300] = rng.uniform(0.0, 0.05, (300, 3))
    venue = scaled_venue(300_000)[:, :3].astype(np.float32)
    return {"blobs": _blobs(3, 20000, 20.0, 0.15, 0.9),
            "bucket_overflow": (pile, rng.rand(6000) > 0.02),
            "above_the_dense_limit": (venue, np.ones(len(venue), bool))}


@pytest.mark.parametrize("name", ["blobs", "bucket_overflow",
                                  "above_the_dense_limit"])
def test_hashgrid_card_matches_cpu(cuda_device, name):
    """The hash grid and ``ball_group``'s hash-grid route ("auto" above
    262,144 sources) on the card, bit-equal to the CPU."""
    from lidar_ai_recommendation_software_tpu_torch.ops import (
        grouping, hashgrid)
    pts, mask = _hashgrid_clouds()[name]
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    q, qm = p[::max(1, len(pts) // 4096)][:4096], m[::max(
        1, len(pts) // 4096)][:4096]
    for radius, cap in ((0.4, 32), (0.6, 64)):
        cpu = hashgrid.build_grid(p, m, radius)
        card = hashgrid.build_grid(p.to(cuda_device), m.to(cuda_device),
                                   radius)
        for field in ("origin", "dims", "order", "sorted_ids",
                      "sorted_points"):
            assert torch.equal(getattr(card, field).cpu(),
                               getattr(cpu, field)), field
        want = hashgrid.ball_count(cpu, q, qm, radius, bucket_capacity=cap)
        got = hashgrid.ball_count(card, q.to(cuda_device),
                                  qm.to(cuda_device), radius,
                                  bucket_capacity=cap)
        assert torch.equal(got.cpu(), want)
        method = "auto" if len(pts) > grouping.BRUTEFORCE_MAX_SOURCE \
            else "hashgrid"
        want = grouping.ball_group(q, qm, p, m, radius, 32, method=method,
                                   bucket_capacity=cap)
        got = grouping.ball_group(q.to(cuda_device), qm.to(cuda_device),
                                  p.to(cuda_device), m.to(cuda_device),
                                  radius, 32, method=method,
                                  bucket_capacity=cap)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


# the eps-adjacency's edge cases, and a buffer whose slices hold two column
# tiles each
EPS_CASES = {case[0]: case[1:] for case in eps_edges_cases()}
EPS_CASES["20,000 points, slices of two tiles"] = (
    *_blobs(3, 20_000, 20.0, 0.15, 0.9), 0.3)


@pytest.mark.parametrize("name", sorted(EPS_CASES))
def test_eps_edges_matches_plain_version(cuda_device, name):
    """``eps_edges`` on the card: the plain version's offsets and columns
    bit for bit, from the count and the fill launch (the count alone where
    there is no edge), and the same again on a second call."""
    pts, mask, eps_ = EPS_CASES[name]
    p = torch.from_numpy(pts).to(cuda_device)
    m = torch.from_numpy(mask).to(cuda_device)
    kernels.reset_launch_counts()
    offsets, cols = eps.eps_edges(p, m, eps_)
    torch.cuda.synchronize()
    want = eps.eps_edges_reference(p, m, eps_)
    assert torch.equal(offsets, want[0])
    assert torch.equal(cols, want[1])
    assert kernels.LAUNCHES["eps_edges"] == (
        eps.EPS_LAUNCHES if cols.numel() else 1)
    again = eps.eps_edges(p, m, eps_)
    assert torch.equal(again[0], offsets) and torch.equal(again[1], cols)
