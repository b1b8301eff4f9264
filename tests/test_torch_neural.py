"""The port's ``NeuralPipeline`` on the CPU against the JAX package's
(``use_pallas=False``), both serving the shipped checkpoint.

Tolerances: people counts, hotspots' cells, bottlenecks and the dominant
direction are equal; maps agree within rtol 1e-4 / atol 1e-4 (the model's
tolerance, ``tests/test_torch_crowdnet.py``); ``avg_density`` follows from
the count and is equal.
"""

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu import neural as jneural
from lidar_ai_recommendation_software_tpu.synthetic import sample_venue
from lidar_ai_recommendation_software_tpu_torch import (
    NeuralPipeline, neural as tneural)

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pipes():
    """One JAX pipeline and one port pipeline for the whole module. Both
    draw their over-capacity subsets from RandomState(0) streams that
    advance together as long as every test feeds both the same clouds."""
    return (jneural.NeuralPipeline(use_pallas=False),
            NeuralPipeline(device="cpu"))


def _same_analysis(got, want):
    d, jd = got["density"], want["density"]
    assert d["total_people"] == jd["total_people"]
    assert d["avg_density"] == jd["avg_density"]
    assert d["origin"] == jd["origin"]
    assert abs(d["max_density"] - jd["max_density"]) < 1e-4
    np.testing.assert_allclose(d["density_map"], jd["density_map"], **TOL)
    np.testing.assert_allclose(d["density_grid"], jd["density_grid"], **TOL)
    assert len(d["hotspots"]) == len(jd["hotspots"])
    for h, jh in zip(d["hotspots"], jd["hotspots"]):
        assert (h["x"], h["y"]) == (jh["x"], jh["y"])
        assert abs(h["density"] - jh["density"]) < 1e-4
    f, jf = got["flow"], want["flow"]
    assert f["bottlenecks"] == jf["bottlenecks"]
    assert f["dominant_direction"] == jf["dominant_direction"]
    assert abs(f["avg_speed"] - jf["avg_speed"]) < 1e-4
    for key in ("positions", "vectors", "magnitudes"):
        np.testing.assert_allclose(f["flow_vectors"][key],
                                   jf["flow_vectors"][key], **TOL)
    np.testing.assert_allclose(f["congestion_map"], jf["congestion_map"],
                               **TOL)
    np.testing.assert_allclose(got["congestion"]["map"],
                               want["congestion"]["map"], **TOL)
    np.testing.assert_array_equal(got["coordinate_offset"],
                                  want["coordinate_offset"])
    assert set(got["recommendations"]) == set(want["recommendations"])
    assert got["recommendations"] == want["recommendations"]


def test_analyze_contract_matches_jax(pipes):
    jp, tp = pipes
    pts = sample_venue(n_points=4096, n_people=50, seed=42)
    got, want = tp.analyze(pts), jp.analyze(pts)
    _same_analysis(got, want)
    g = tp.train_config.grid
    assert got["density"]["density_map"].shape == (g, g)
    assert 10 <= got["density"]["total_people"] <= 150
    assert got["flow"]["flow_vectors"]["vectors"].shape == (g * g, 2)
    assert 0.0 <= got["congestion"]["map"].min()
    assert got["congestion"]["max"] <= 1.0
    assert got["recommendations"]["opportunities"]


def test_downsample_branch_matches_jax(pipes):
    """Clouds above the model's capacity are cut to the same uniform
    subset in both packages (one numpy stream each, seeded alike)."""
    jp, tp = pipes
    pts = sample_venue(n_points=9000, n_people=40, seed=3)
    got, want = tp.analyze(pts), jp.analyze(pts)
    _same_analysis(got, want)
    assert got["density"]["total_people"] > 0


def test_small_cloud_is_padded_and_utm_offsets_recentred(pipes):
    jp, tp = pipes
    pts = sample_venue(n_points=2048, n_people=30, seed=7)
    pts[:, 0] += 500_000.0
    pts[:, 1] += 4_100_000.0
    got, want = tp.analyze(pts), jp.analyze(pts)
    _same_analysis(got, want)
    assert got["coordinate_offset"][0] > 4096.0
    padded, mask = tp.padded_cloud(pts[:, :3])
    assert padded.shape == (4096, 3) and mask.sum() == 2048
    assert not padded[2048:].any()


def test_forward_outputs_match_jax(pipes):
    jp, tp = pipes
    pts = sample_venue(n_points=4096, n_people=20, seed=1)
    vmin = pts[:, :2].min(axis=0).astype(np.float32)
    vsize = float(np.ptp(pts[:, :2], axis=0).max()) + 1e-6
    got, want = tp.forward(pts, vmin, vsize), jp.forward(pts, vmin, vsize)
    assert set(got) == {"density", "flow", "congestion", "count"}
    for key in got:
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


def test_legacy_checkpoint_without_count_head_serves(tmp_path):
    legacy = tmp_path / "legacy.npz"
    with np.load(tneural.default_checkpoint_path(),
                 allow_pickle=False) as z:
        kept = {k: z[k] for k in z.files if "count_head" not in k}
    np.savez_compressed(legacy, **kept)
    tp = NeuralPipeline(str(legacy), device="cpu")
    jp = jneural.NeuralPipeline(str(legacy), use_pallas=False)
    assert tp._legacy_count and jp._legacy_count
    pts = sample_venue(n_points=2048, n_people=30, seed=5)
    got, want = tp.analyze(pts), jp.analyze(pts)
    # the count is the density map's integral, rounded: allow the last one
    assert abs(got["density"]["total_people"]
               - want["density"]["total_people"]) <= 1
    np.testing.assert_allclose(got["density"]["density_map"],
                               want["density"]["density_map"], **TOL)
    assert set(got["recommendations"]) == {"issues", "actions",
                                           "opportunities"}


def test_mismatched_checkpoint_raises_named_error(tmp_path):
    broken = tmp_path / "broken.npz"
    with np.load(tneural.default_checkpoint_path(),
                 allow_pickle=False) as z:
        kept = {k: z[k] for k in z.files}
    drop = [k for k in kept if "count_head" in k][0]
    del kept[drop]
    wk = [k for k in kept if k.endswith("kernel")][0]
    kept[wk] = kept[wk][..., :1]
    np.savez_compressed(broken, **kept)
    with pytest.raises(ValueError, match="format mismatch") as port_err:
        NeuralPipeline(str(broken), device="cpu")
    with pytest.raises(ValueError, match="format mismatch") as jax_err:
        jneural.NeuralPipeline(str(broken), use_pallas=False)
    assert str(port_err.value) == str(jax_err.value)


def test_device_is_explicit():
    """The default device is the card: without one the constructor raises
    and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        NeuralPipeline()


def test_checkpoint_copy_is_byte_identical():
    with open(tneural.default_checkpoint_path(), "rb") as a, \
            open(jneural.default_checkpoint_path(), "rb") as b:
        assert a.read() == b.read()
