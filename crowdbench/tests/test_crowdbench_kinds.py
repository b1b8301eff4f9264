"""The kind ``scan`` is the harness as it was before kinds: the same pools,
the same checks; the port's span records reach the readers of a traced
run, and the three readers of them read fixed records."""

import pytest

from crowdbench import run, spec, traffic, trace
from lidar_ai_recommendation_software_tpu_torch.utils import profiling

SCAN = spec.load_kind("scan")
SMALL = 10_000  # the CPU configuration: the sensor frame at 10,000 points


def small_cell(points=SMALL, pool=1):
    cell = spec.resolve("sensor_frame_40k.stream")
    cell.config["points"] = points
    cell.traffic["pool"] = pool
    return cell


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell", [
    "venue_scan_1m.refresh", "venue_scan_1m.sensor_order",
    "sensor_frame_40k.stream", "small"])
def test_scan_pool_is_the_traffic_generators_bit_for_bit(cell, seed):
    c = small_cell(pool=3) if cell == "small" else spec.resolve(cell)
    assert c.kind.__name__ == SCAN.__name__  # no "kind": the scan
    got = c.kind.make_pool(c.config, c.traffic, seed)
    want = traffic.make_pool(c.config, c.traffic, seed)
    assert len(got) == len(want) == c.traffic["pool"]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert [c.kind.points(x) for x in got] == [len(x) for x in want]


# ``checks`` of the small configuration, one scan in the pool (a window
# judges every scan of a pool of one), as the harness printed them at
# commit 98d80ca, before the kind modules, on the CPU
PARENT_CHECKS = {
    0: {"people": 0.0, "density_stats": 3.894365163681357e-09,
        "bottlenecks": 0.0, "centroids": 0.0, "density_cells": 0.0,
        "flow": 7.274836498760706e-07},
    1: {"people": 0.0, "density_stats": 4.0976379067636515e-08,
        "bottlenecks": 0.0, "centroids": 0.0, "density_cells": 0.0,
        "flow": 5.956982492838492e-07},
}


@pytest.mark.parametrize("seed", sorted(PARENT_CHECKS))
def test_scan_checks_are_the_harness_before_kinds(seed):
    result, info, lines = run.bench(small_cell(), seed, 0.3, False,
                                    device="cpu")
    assert result["correct"] is True
    assert {k: v["value"] for k, v in result["checks"].items()} == \
        PARENT_CHECKS[seed]
    assert list(result["checks"]) == list(SCAN.LIGHT + SCAN.HEAVY)
    assert f"pool 1 x {SMALL:,} points" in info[1]


def test_traced_run_keeps_the_ports_records(monkeypatch):
    seen = []
    reader = spec.metric_reader

    def keeping(name, root):
        seen.append(name)
        read = reader(name, root)
        return lambda tr: seen.append(tr) or read(tr)
    monkeypatch.setattr(spec, "metric_reader", keeping)
    # a part for the records half as long as the synchronised part: their
    # counts of scans differ
    result, _, _ = run.bench(small_cell(5_000, 2), 2**31 + 11, 0.9, True,
                             device="cpu")
    assert result["correct"] is True
    tr = seen[-1]
    # the session holds its own part's scans, one record each, and none
    # of the synchronised part's, whose spans the other readers read
    roots = [sc.spans[0].name for sc in tr.records]
    assert tr.recorded > 0 and roots == ["pipeline.analyze"] * tr.recorded
    assert tr.scans > 0 and len(tr.spans["analyze"]) == tr.scans
    assert len(tr.spans["analyze_device"]) == tr.scans
    for name in ("pipeline.upload_ms", "pipeline.readback_ms"):
        assert result["metrics"][name]["value"] > 0, name
    # the CPU's session counts no host reads: nothing to read
    assert "preprocess.cluster_reads" not in result["metrics"]


class _Pipe:
    def fit_capacity(self, x):
        return x

    def analyze_device(self, x):
        return x


def test_instrument_opens_a_session_for_the_block_alone():
    pipe = _Pipe()
    with trace.instrument(pipe, trace.Spans(sync=False),
                          record=True) as scans:
        with profiling.stage("pipeline.analyze"):
            with profiling.stage("pipeline.upload"):
                pass
    assert [sp.name for sp in scans[0].spans] == ["pipeline.analyze",
                                                  "pipeline.upload"]
    with profiling.stage("pipeline.analyze"):  # after the block
        pass
    assert len(scans) == 1
    with trace.instrument(pipe, trace.Spans(sync=False)) as scans:
        assert scans is None
    assert "analyze_device" not in vars(pipe)


def test_a_port_without_a_tracer_gives_no_records(monkeypatch):
    monkeypatch.delattr(profiling, "tracing")
    with trace.instrument(_Pipe(), trace.Spans(sync=False),
                          record=True) as scans:
        assert scans is None


def test_extra_spans_wrap_and_are_restored():
    orig = profiling.timings
    spans = trace.Spans(sync=False)
    extra = ((profiling.__name__, "timings", "port.timings"),)
    with trace.instrument(_Pipe(), spans, extra):
        assert profiling.timings is not orig
        assert isinstance(profiling.timings(), dict)
    assert profiling.timings is orig
    assert len(spans.seconds["port.timings"]) == 1


def _scan(i, spans):
    """A port record: (name, parent, seconds, counters) a span."""
    sc = profiling.Scan(i)
    for name, parent, seconds, counters in spans:
        sc.spans.append(profiling.SpanRecord(
            name, i, parent, 0, {}, dict(counters), int(seconds * 1e9)))
    return sc


RECORDS = [
    _scan(0, [("pipeline.analyze", None, 0.030, {}),
              ("pipeline.upload", 0, 0.004, {"host_reads": 1}),
              ("preprocess.cluster", 0, 0.002, {"host_reads": 3}),
              ("pipeline.readback", 0, 0.005, {"host_reads": 20})]),
    _scan(1, [("pipeline.analyze", None, 0.030, {}),
              ("pipeline.upload", 0, 0.002, {}),
              ("preprocess.cluster", 0, 0.002, {"host_reads": 5}),
              ("pipeline.readback", 0, 0.007, {"host_reads": 20})]),
]


@pytest.mark.parametrize("name,want", [
    ("pipeline.upload_ms", 3.0), ("pipeline.readback_ms", 6.0),
    ("preprocess.cluster_reads", 4.0)])
def test_record_readers_take_means_a_scan(name, want):
    read = spec.metric_reader(name)
    # the records' own part: its scans, not the synchronised part's
    assert read(run.TracedRun({}, 5, None, [], {}, None, RECORDS,
                              2)) == pytest.approx(want)
    assert read(run.TracedRun({}, 2, None, [], {}, None)) is None
    assert read(run.TracedRun({}, 2, None, [], {}, None, RECORDS)) is None


def test_cluster_reads_need_a_session_that_counts():
    uncounted = [_scan(0, [("pipeline.analyze", None, 0.03, {}),
                           ("preprocess.cluster", 0, 0.002, {})])]
    read = spec.metric_reader("preprocess.cluster_reads")
    assert read(run.TracedRun({}, 1, None, [], {}, None, uncounted,
                              1)) is None


INTERFACE = ("make_pool", "points", "call", "reference", "clustered",
             "keep", "light", "heavy", "as_kept", "LIGHT", "HEAVY", "SPANS")


def test_every_configurations_kind_has_the_interface():
    bench = spec.load_spec()
    for w in bench["workloads"]:
        kind = spec.resolve(w["name"]).kind
        assert all(hasattr(kind, a) for a in INTERFACE), w["name"]
        limits = spec.resolve(w["name"]).config["limits"]
        assert set(limits) == set(kind.LIGHT + kind.HEAVY), w["name"]
