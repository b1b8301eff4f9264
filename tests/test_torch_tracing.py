"""The port's tracer (``utils/profiling.py``): spans and counters inside
``Pipeline.analyze``, a session's scan records, the bounded aggregates,
the ``lidar.*`` ranges in ``torch.profiler`` traces, and the host reads
torch reports on the card.

This file imports no JAX, so its card tests also run where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import eps, kernels
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    sample_venue, scaled_venue, venue_sequence)
from lidar_ai_recommendation_software_tpu_torch.utils import profiling
from port_helpers import UTM_SHIFT

# the spans of one analysis that nothing overflows, in the order they
# open, each with its parent's index
ANALYZE_SPANS = [
    ("pipeline.analyze", None), ("pipeline.prepare", 0),
    ("pipeline.upload", 0), ("pipeline.fit", 0), ("pipeline.device", 0),
    ("preprocess", 4), ("preprocess.cluster", 5), ("density.people", 4),
    ("density.centroids", 7), ("density.grid", 4), ("flow.field", 4),
    ("pipeline.guard", 0), ("pipeline.guard", 0), ("pipeline.guard", 0),
    ("pipeline.readback", 0), ("pipeline.recommend", 0)]


@pytest.fixture(scope="module")
def venue():
    return sample_venue()


@pytest.fixture(scope="module")
def pipe(venue):
    p = Pipeline(device="cpu")
    p.analyze(venue)  # the first call's one-off work
    return p


def _same(a, b):
    for key in ("density", "flow"):
        for k, v in a[key].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b[key][k])
            elif k == "flow_vectors":
                for name, arr in v.items():
                    np.testing.assert_array_equal(arr, b[key][k][name])
            else:
                assert v == b[key][k], (key, k)
    assert a["recommendations"] == b["recommendations"]
    np.testing.assert_array_equal(a["processed"].labels.numpy(),
                                  b["processed"].labels.numpy())


def test_one_analyze_is_one_scan_with_nested_spans(pipe, venue):
    with profiling.tracing() as rec:
        pipe.analyze(venue)
    assert rec.dropped == 0 and len(rec.scans) == 1
    scan = rec.scans[0]
    assert [(sp.name, sp.parent) for sp in scan.spans] == ANALYZE_SPANS
    assert {sp.scan for sp in scan.spans} == {scan.id}
    for sp in scan.spans:
        assert sp.end_ns >= sp.start_ns > 0, sp.name
        if sp.parent is not None:
            up = scan.spans[sp.parent]
            assert up.start_ns <= sp.start_ns <= sp.end_ns <= up.end_ns
    ends = [sp.end_ns for sp in scan.spans if sp.parent == 0]
    assert ends == sorted(ends)  # the root's children one after another
    root, upload, fit, device = scan.spans[0], *scan.spans[2:5]
    assert root.attrs == {"points": len(venue), "first": False}
    # the float64 scan crosses once; the fit casts and pads it there
    assert upload.attrs == {"pinned": False, "bytes": len(venue) * 3 * 8}
    assert fit.attrs == {"device": "cpu"}
    assert device.attrs == {"reason": "first"}
    # the plain eps-adjacency built the all-pairs clustering's edges
    cluster = scan.spans[6]
    assert cluster.counters == {}
    assert set(cluster.attrs) == {"edges"} and cluster.attrs["edges"] > 0
    # the fixture's buffer is below the place_dense switch
    cents, cap = scan.spans[8], pipe.fit_capacity(venue).capacity
    assert cents.attrs == {"route": "indexed",
                           "rows": cap.max_points,
                           "slots": cap.max_people}
    assert cents.counters == {"density.routes.indexed": 1}
    # no rerun, and the CPU has no host reads
    assert scan.counters() == {"density.routes.indexed": 1}


def test_a_recentred_scan_is_counted_once(pipe, venue):
    with profiling.tracing() as rec:
        got = pipe.analyze(venue + UTM_SHIFT)
    (scan,) = rec.scans
    (fit,) = [sp for sp in scan.spans if sp.name == "pipeline.fit"]
    assert fit.counters == {"pipeline.recentred": 1}
    assert scan.counters() == {"pipeline.recentred": 1,
                               "density.routes.indexed": 1}
    np.testing.assert_array_equal(
        got["coordinate_offset"][:2],
        np.round((venue[:, :2] + UTM_SHIFT[:2]).mean(axis=0)))
    assert got["density"]["total_people"] == 446


class _SmallBuffer(Pipeline):
    """A clustering buffer of 4,096 points, which the fixture's non-ground
    points overflow once."""

    def fit_capacity(self, points):
        return super().fit_capacity(points).with_capacity(
            cluster_capacity=4096)


def test_an_overflow_reruns_the_device_program_once(venue):
    small = _SmallBuffer(device="cpu")
    with profiling.tracing() as rec:
        got = small.analyze(venue)
    (scan,) = rec.scans
    devices = [sp for sp in scan.spans if sp.name == "pipeline.device"]
    assert [sp.attrs["reason"] for sp in devices] == ["first",
                                                      "cluster_overflow"]
    assert devices[1].counters == {"pipeline.reruns.cluster_overflow": 1}
    # each device run extracts the people once
    assert scan.counters() == {"pipeline.reruns.cluster_overflow": 1,
                               "density.routes.indexed": 2}
    assert [sp.name for sp in scan.spans].count("preprocess.cluster") == 2
    assert scan.spans[0].attrs["first"] is True
    assert got["density"]["total_people"] == 446


def test_outside_a_session_nothing_is_kept(pipe, venue, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kept a record or opened a range")
    monkeypatch.setattr(profiling.Recorder, "_open", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_timings()
    pipe.analyze(venue)
    t = profiling.timings()
    assert t["pipeline.analyze"]["count"] == 1
    assert t["pipeline.guard"]["count"] == 3
    assert t["pipeline.analyze"]["top_s"] == t["pipeline.analyze"]["total_s"]
    assert t["pipeline.fit"]["top_s"] == 0.0  # nested in the analysis
    agg = profiling._AGGREGATES["pipeline.fit"]
    for _ in range(1000):
        with profiling.stage("pipeline.fit"):
            pass
    assert profiling._AGGREGATES["pipeline.fit"] is agg  # one fixed entry
    assert set(profiling._AGGREGATES) == set(t)
    assert profiling.timings()["pipeline.fit"]["count"] == 1001
    profiling.count("host_reads")  # no session: nothing to count into


def test_profiler_traces_hold_the_pipeline_ranges(pipe, venue, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipe.analyze(venue)
    names = {e.key for e in prof.key_averages()}
    want = {"lidar." + name for name, _ in ANALYZE_SPANS}
    assert want <= names, want - names


def test_results_are_bit_equal_with_a_session(pipe, venue):
    plain = pipe.analyze(venue)
    with profiling.tracing():
        traced = pipe.analyze(venue)
    _same(plain, traced)


TEMPORAL_SPANS = ["temporal.flow", "temporal.match", "temporal.consistency",
                  "temporal.nodes", "temporal.bottlenecks"]


def test_one_sequence_is_one_scan_and_its_results_do_not_change():
    frames = venue_sequence(n_frames=3, n_points=5000, n_people=30,
                            extent=12.0, seed=5)
    seq_pipe = Pipeline(device="cpu")
    plain = seq_pipe.analyze_sequence(frames, dt=0.5)
    with profiling.tracing() as rec:
        traced = seq_pipe.analyze_sequence(frames, dt=0.5)
    _same(plain, traced)
    for f in ("positions", "mask", "z"):
        assert torch.equal(getattr(plain["tracked_people"], f),
                           getattr(traced["tracked_people"], f))

    (scan,) = rec.scans
    names = [sp.name for sp in scan.spans]
    root = scan.spans[0]
    assert root.name == "pipeline.sequence" and root.parent is None
    assert root.attrs == {"frames": 3, "points": 15_000}
    top = [sp.name for sp in scan.spans if sp.parent == 0]
    assert top == ["pipeline.analyze", "sequence.fit", "sequence.frame",
                   "sequence.frame", "temporal.flow"]
    assert [sp.attrs for sp in scan.spans
            if sp.name == "sequence.frame"] == [{"t": 0}, {"t": 1}]
    (fit,) = [sp for sp in scan.spans if sp.name == "sequence.fit"]
    assert fit.attrs == {"device": "cpu"}
    flow = names.index("temporal.flow")
    assert names[flow:] == TEMPORAL_SPANS
    assert all(scan.spans[i].parent == flow
               for i in range(flow + 1, len(names)))
    # the pair tests of the all-pairs formulation, from the shapes
    attrs = scan.spans[flow].attrs
    k = traced["tracked_people"].positions.shape[1]
    cap = seq_pipe.fit_capacity(frames[-1]).capacity
    assert attrs == {"frames": 3, "slots": k,
                     "nodes": cap.grid_cells_x * cap.grid_cells_y}
    # three small frames, each clustered by the plain eps-adjacency and
    # its centroids read by index
    assert scan.counters() == {
        "temporal.pair_tests": 2 * k * k + 2 * attrs["nodes"] * k,
        "density.routes.indexed": 3}
    assert "sequence.restarts" not in scan.counters()


def test_the_ring_keeps_the_last_scans(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SCANS", 3)
    with profiling.tracing() as rec:
        for i in range(5):
            with profiling.stage("unit", i=i):
                with profiling.stage("inner"):
                    profiling.count("items", 2)
    assert rec.dropped == 2
    assert [sc.id for sc in rec.scans] == [2, 3, 4]
    assert [sc.spans[0].attrs["i"] for sc in rec.scans] == [2, 3, 4]
    assert all(sc.counters() == {"items": 2} for sc in rec.scans)


def test_sync_warnings_count_as_host_reads_and_go_no_further():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        filters = list(warnings.filters)
        shown = warnings.showwarning
        with profiling.tracing() as rec:
            with profiling.stage("outer"):
                with profiling.stage("inner"):
                    for _ in range(3):
                        warnings.warn(profiling.SYNC_WARNING + " (Triggered "
                                      "internally at Functions.cpp:1.)")
                warnings.warn(profiling.SYNC_WARNING)
                warnings.warn("another warning", RuntimeWarning)
            with pytest.raises(RuntimeError, match="already open"):
                with profiling.tracing():
                    pass
        assert warnings.filters == filters and warnings.showwarning is shown
    (scan,) = rec.scans
    assert [sp.counters for sp in scan.spans] == [{"host_reads": 1},
                                                  {"host_reads": 3}]
    assert [str(w.message) for w in caught] == ["another warning"]
    assert profiling._SESSION is None


def test_each_thread_keeps_its_own_spans():
    workers, steps = 16, 200
    barrier = threading.Barrier(workers, timeout=30)

    def work(k):
        with profiling.stage("job", k=k):
            barrier.wait()
            for _ in range(steps):
                with profiling.stage("step"):
                    profiling.count("n")
            barrier.wait()

    profiling.reset_timings()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.tracing() as rec:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(sc.spans[0].attrs["k"] for sc in rec.scans) == list(
        range(workers))
    for sc in rec.scans:
        assert len(sc.spans) == steps + 1
        assert all(sp.parent == 0 for sp in sc.spans[1:])
        assert sc.counters() == {"n": steps}
    t = profiling.timings()  # no update of the aggregates lost
    assert (t["job"]["count"], t["step"]["count"]) == (workers,
                                                       workers * steps)


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch reports host reads only "
                    "for CUDA tensors, and the kernels have no CPU mode")
    return Pipeline(device="cuda")


@pytest.mark.cuda
def test_host_reads_of_the_all_pairs_clustering(card):
    frame = scaled_venue(40_960)
    card.analyze(frame)
    kernels.reset_launch_counts()
    with profiling.tracing() as rec:
        card.analyze(frame)
    (scan,) = rec.scans
    (cluster,) = [sp for sp in scan.spans if sp.name == "preprocess.cluster"]
    # the kernel built the edges with one read (their total); the sweeps
    # read once each, and their number depends on the clusters' shapes
    assert kernels.LAUNCHES["eps_edges"] == eps.EPS_LAUNCHES
    assert cluster.attrs["edges"] > 28_000  # a self pair a valid point
    assert 1 <= cluster.counters.get("host_reads", 0) <= 20
    guards = [sp for sp in scan.spans if sp.name == "pipeline.guard"]
    assert all(sp.counters.get("host_reads", 0) >= 1 for sp in guards)


@pytest.mark.cuda
def test_the_1m_scan_is_measured_with_two_host_reads(card):
    """At 1M points the host makes no pass over the scan before it
    crosses, and the fit reads the host twice: the extent and the largest
    column count. A recentred scan is counted once."""
    scan = scaled_venue(1_000_000)
    shifted = scan + UTM_SHIFT
    card.analyze(scan)
    card.analyze(shifted)
    with profiling.tracing() as rec:
        card.analyze(scan)
        card.analyze(shifted)
    plain, moved = rec.scans
    spans = {sp.name: sp for sp in plain.spans}
    assert "host_reads" not in spans["pipeline.prepare"].counters
    assert spans["pipeline.fit"].counters == {"host_reads": 2}
    assert spans["pipeline.fit"].attrs == {"device": "cuda"}
    assert spans["pipeline.upload"].attrs["bytes"] == 24_000_000
    assert "pipeline.recentred" not in plain.counters()
    assert moved.counters()["pipeline.recentred"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "error"])
def test_sync_debug_mode_is_restored(card, mode):
    torch.cuda.set_sync_debug_mode(mode)
    try:
        before = torch.cuda.get_sync_debug_mode()
        with profiling.tracing():
            assert torch.cuda.get_sync_debug_mode() == 1  # warn
        assert torch.cuda.get_sync_debug_mode() == before
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_setup_kernels_reports_a_library_found(card):
    kernels.load_library()  # built here if this is the first use
    kernels.load_library.cache_clear()
    with profiling.tracing() as rec:
        kernels.load_library()
    (scan,) = rec.scans
    assert [(sp.name, sp.attrs) for sp in scan.spans] == [
        ("setup.kernels", {"built": False})]
