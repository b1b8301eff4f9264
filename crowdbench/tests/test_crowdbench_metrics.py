"""The metric arithmetic on fixed inputs: the 95th percentile over all
scans, points over the window, the device's idle share as the union of
intervals, the roofline's count, and the per-layer readers."""

import numpy as np
import pytest

from crowdbench import roofline, run, spec
from crowdbench.trace import Trace, merge, union_length


def test_p95_is_over_every_scan():
    lat = list(np.random.RandomState(0).exponential(0.1, 401))
    assert run.percentile(lat, 95) == pytest.approx(np.percentile(lat, 95))
    # not a median of chunks' percentiles
    chunks = [np.percentile(lat[i:i + 50], 95) for i in range(0, 400, 50)]
    assert run.percentile(lat, 95) != pytest.approx(np.median(chunks))


class _Clock:
    """A pipeline whose every scan takes 0.25 s of a fake clock."""

    def __init__(self, monkeypatch):
        self.now = 0.0
        monkeypatch.setattr(run.time, "perf_counter", lambda: self.now)

    def analyze(self, pts):
        self.now += 0.25
        return {"density": {}, "flow": {}, "recommendations": {},
                "people": None}


def test_points_over_the_window(monkeypatch):
    pipe = _Clock(monkeypatch)
    pool = [np.zeros((1000, 3)), np.zeros((3000, 3))]
    order = iter([0, 1] * 10)
    kept = run.Kept(1, spec.load_kind("scan"))
    win = run.closed_loop(pipe, pool, order, 1.1, kept, None, lambda: None)
    # five scans: the fifth starts at 1.0 s, before the end, and ends past
    # it; the window closes with it
    assert win["attempted"] == 5
    assert win["window_s"] == pytest.approx(1.25)
    assert win["points"] == 3 * 1000 + 2 * 3000
    assert win["points"] / win["window_s"] == pytest.approx(7200.0)
    assert win["latencies"] == [0.25] * 5


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace():
    """Two scans of 1,000 us; kernels that overlap, one launched inside
    the clustering's span."""
    return Trace([
        _ev("user_annotation", "bench.analyze", 0, 1000),
        _ev("user_annotation", "bench.fit_capacity", 10, 400),
        _ev("user_annotation", "bench.dbscan_labels", 500, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 510, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 700, 5, corr=2),
        _ev("kernel", "table_fill", 520, 50, corr=1),
        _ev("kernel", "other", 540, 100, corr=2),
        _ev("gpu_memcpy", "Memcpy HtoD", 450, 20),
        _ev("user_annotation", "bench.analyze", 1000, 1000),
        _ev("kernel", "late", 1900, 100),
        _ev("cpu_op", "aten::add", 100, 10),
    ])


def test_idle_is_the_union_of_intervals():
    assert merge([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert union_length([(0, 2), (1, 3), (5, 6)]) == 4
    tr = _trace()
    assert tr.window_s() == pytest.approx(2000e-6)
    # busy: [450, 470] + [520, 640] + [1900, 2000] = 240 us, not the sum
    # of the operations' times (270 us)
    assert tr.busy_s() == pytest.approx(240e-6)
    read = spec.metric_reader("device.idle_pct")
    run_ = run.TracedRun({}, 0, tr, [0], {0: 1}, None)
    assert read(run_) == pytest.approx(100 * (1 - 240 / 2000))


def test_breakdown_names_gaps_by_the_hosts_span():
    tr = _trace()
    gaps = dict(tr.idle_gaps())
    # 0..450: the midpoint 225 lies in fit_capacity
    assert gaps["fit_capacity"] == pytest.approx(450e-6)
    assert sum(gaps.values()) == pytest.approx(2000e-6 - 240e-6)
    ops = dict(tr.top_device_ops())
    assert ops["other"] == pytest.approx(100e-6)


def test_roofline_counts_inputs_and_outputs():
    # xyz read once (12 bytes) and a label written once (4 bytes)
    assert roofline.clustering_bytes(700_000) == 11_200_000
    assert roofline.roofline_pct(3.35e6, 1e-3, 3.35e12) == \
        pytest.approx(0.1)
    assert roofline.roofline_pct(1.0, 0.0, 3.35e12) is None
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == \
        3.35e12
    assert roofline.peaks("cpu") is None


def test_cluster_roofline_reads_kernels_launched_in_the_span():
    tr = _trace()
    # only the kernel launched inside dbscan_labels counts: 50 us
    assert tr.span_device_s("dbscan_labels") == pytest.approx(50e-6)
    read = spec.metric_reader("kernels.cluster_roofline_pct")
    peaks = {"hbm_bytes_per_s": 3.35e12}
    r = run.TracedRun({}, 0, tr, [0, 0], {0: 1000}, peaks)
    want = 100 * (2 * 16_000 / 3.35e12) / 50e-6
    assert read(r) == pytest.approx(want)
    assert read(run.TracedRun({}, 0, None, [], {}, peaks)) is None


def test_span_readers_take_means_a_scan():
    spans = {"analyze": [0.2, 0.4], "analyze_device": [0.05, 0.05],
             "fit_capacity": [0.1, 0.1], "dbscan_labels": [0.01, 0.03],
             "extract_people": [0.002, 0.002],
             "analyze_density": [0.008, 0.008], "analyze_flow": [0.02, 0.04]}
    r = run.TracedRun(spans, 2, None, [], {}, None)
    want = {"pipeline.fit_ms": 100.0, "pipeline.host_ms": 250.0,
            "preprocess.cluster_ms": 20.0, "density.ms": 10.0,
            "flow.ms": 30.0}
    for name, value in want.items():
        assert spec.metric_reader(name)(r) == pytest.approx(value), name
        assert spec.metric_reader(name)(
            run.TracedRun({}, 0, None, [], {}, None)) is None


def test_loop_rate_reads_the_untraced_part():
    read = spec.metric_reader("loop.points_per_s")
    r = run.TracedRun({}, 0, None, [], {}, None,
                      plain={"points": 3_000_000, "window_s": 2.0})
    assert read(r) == pytest.approx(1_500_000.0)
    assert read(run.TracedRun({}, 0, None, [], {}, None)) is None
    assert read(run.TracedRun({}, 0, None, [], {}, None,
                              plain={"points": 0, "window_s": 2.0})) is None
