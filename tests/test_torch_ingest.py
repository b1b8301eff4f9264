"""How a scan reaches the device and how its coordinates come back
(``pipeline.py``: ``Pipeline._upload``, ``Pipeline.recentring_offset``,
``restore_offset``): a recentred sequence, the sequence's uploads, the
recentring threshold, and the neural path's offset.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_ingest.py -q
"""

import numpy as np
import pytest

from lidar_ai_recommendation_software_tpu_torch.neural import NeuralPipeline
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    sample_venue, venue_sequence)
from lidar_ai_recommendation_software_tpu_torch.utils import profiling
from port_helpers import UTM_SHIFT


@pytest.fixture(scope="module")
def frames():
    """The small sequence of tests/test_torch_tracing.py: 3 x 5,000."""
    return venue_sequence(n_frames=3, n_points=5000, n_people=30,
                          extent=12.0, seed=5)


@pytest.fixture(scope="module")
def plain(frames):
    return Pipeline(device="cpu").analyze_sequence(frames, dt=0.5)


def _xy(spots):
    return np.array([[s["x"], s["y"]] for s in spots]).reshape(-1, 2)


def test_a_recentred_sequence_tracks_the_same_people(frames, plain):
    """Every frame shifted by a UTM offset: recentred as the last frame,
    the same people in every frame, and positions back where the
    unshifted sequence has them, plus the shift."""
    got = Pipeline(device="cpu").analyze_sequence(
        [f + UTM_SHIFT for f in frames], dt=0.5)
    assert got["coordinate_offset"][:2].all()
    assert (got["density"]["total_people"]
            == plain["density"]["total_people"])
    np.testing.assert_array_equal(
        got["tracked_people"].mask.sum(dim=1).numpy(),
        plain["tracked_people"].mask.sum(dim=1).numpy())
    shift = UTM_SHIFT[:2]
    # the tracked flow of so few people has no bottleneck: both lists empty
    for key, sub in (("density", "hotspots"), ("flow", "bottlenecks")):
        want, have = _xy(plain[key][sub]), _xy(got[key][sub])
        assert want.shape == have.shape, (key, sub)
        np.testing.assert_allclose(have, want + shift, rtol=0, atol=0.1)
    assert len(plain["density"]["hotspots"]) > 0
    want = plain["flow"]["flow_vectors"]["positions"]
    assert len(want) > 0
    np.testing.assert_allclose(got["flow"]["flow_vectors"]["positions"],
                               want + shift, rtol=0, atol=0.1)


def test_each_frame_crosses_once(frames, plain):
    """Three frames, three uploads of their float64 points: the largest
    frame's tensor serves both the fit and its extraction. Unshifted,
    the flow positions stay the device's float32."""
    pipe = Pipeline(device="cpu")
    with profiling.tracing() as rec:
        got = pipe.analyze_sequence(frames, dt=0.5)
    (scan,) = rec.scans
    uploads = [sp for sp in scan.spans if sp.name == "pipeline.upload"]
    assert [sp.attrs for sp in uploads] == [
        {"pinned": False, "bytes": len(f) * 3 * 8} for f in frames]
    parents = [scan.spans[sp.parent].name for sp in uploads]
    assert parents == ["pipeline.analyze", "sequence.fit",
                       "sequence.frame"]
    assert not got["coordinate_offset"].any()
    assert got["flow"]["flow_vectors"]["positions"].dtype == np.float32
    np.testing.assert_array_equal(got["flow"]["flow_vectors"]["positions"],
                                  plain["flow"]["flow_vectors"]["positions"])


@pytest.mark.parametrize("past", [False, True], ids=["at", "past"])
def test_the_recentring_threshold(past):
    """A largest |x| of exactly ``RECENTER_THRESHOLD`` keeps the scan
    where it is; one ulp past it recentres."""
    edge = Pipeline.RECENTER_THRESHOLD
    pts = sample_venue()[:2000].copy()
    pts[:, 0] += edge - pts[:, 0].max()
    pts[np.argmax(pts[:, 0]), 0] = (np.nextafter(edge, np.inf) if past
                                    else edge)
    assert np.abs(pts[:, :2]).max() == pts[:, 0].max()
    with profiling.tracing() as rec:
        _, _, offset = Pipeline(device="cpu")._ingest(pts)
    assert offset.any() == past
    assert sum(sc.counters().get("pipeline.recentred", 0)
               for sc in rec.scans) == int(past)
    np.testing.assert_array_equal(Pipeline.recentring_offset(pts), offset)


def test_neural_and_analytic_paths_take_one_offset():
    pts = sample_venue() + UTM_SHIFT
    neural = NeuralPipeline(device="cpu").analyze(pts)
    analytic = Pipeline(device="cpu").analyze(pts)
    assert neural["coordinate_offset"][:2].all()
    np.testing.assert_array_equal(neural["coordinate_offset"],
                                  analytic["coordinate_offset"])
