"""The kind ``sequence`` and the cell ``sequence_4x100k.track``: the frozen
walk is the port's ``venue_sequence`` bit for bit, the pool is the
walk's sliding windows, a traced run of the cell at a small size comes
out correct with the cell's new metrics, and the readers of the port's
records read fixed records."""

import json

import numpy as np
import pytest

from crowdbench import run, spec, venue, walk
from lidar_ai_recommendation_software_tpu_torch.utils import profiling

CELL = "sequence_4x100k.track"
NEW = ("temporal.ms", "sequence.frames_ms", "temporal.match_ms",
       "temporal.nodes_ms", "sequence.host_reads")


def test_walk_is_the_ports_bit_for_bit():
    from lidar_ai_recommendation_software_tpu_torch import synthetic
    cfg = spec.resolve(CELL).config
    extent, people = venue.venue_size(cfg["points"], cfg["people_per_100m2"])
    assert people == cfg["people"] == 500
    args = dict(n_frames=7, dt=cfg["dt"], n_points=cfg["points"],
                n_people=cfg["people"], extent=extent, speed=cfg["speed"],
                person_points=cfg["person_points"], seed=2**31 - 7)
    got, want = walk.venue_sequence(**args), synthetic.venue_sequence(**args)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.shape == (100_000, 3) and a.tobytes() == b.tobytes()


def test_pool_is_the_walks_sliding_windows():
    cell = spec.resolve(CELL)
    cfg = dict(cell.config, points=3_000, people=20)
    pool = cell.kind.make_pool(cfg, cell.traffic, 2**33 + 1)
    assert len(pool) == cell.traffic["pool"] == 4
    extent, _ = venue.venue_size(3_000, cfg["people_per_100m2"])
    walk_seed = int(run.traffic.seed_state(2**33 + 1, 1)[0]) >> 1
    frames = walk.venue_sequence(7, 0.5, 3_000, 20, extent, 1.0, 40,
                                 walk_seed)
    arrays = set()
    for i, item in enumerate(pool):
        assert item.dt == cfg["dt"] and len(item.frames) == 4
        assert cell.kind.points(item) == 12_000
        for f, g in zip(item.frames, frames[i:i + 4]):
            assert f.tobytes() == g.tobytes()
            arrays.add(id(f))
    assert len(arrays) == 16  # no window shares an array with another


def test_the_cell_is_added_and_nothing_else_changes():
    bench = spec.load_spec()
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == (
        "sequence_4x100k", "track", 1)
    cell = spec.resolve(CELL)
    names = [m["name"] for m in cell.per_layer]
    assert set(NEW) <= set(names)
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL] and m["moves"] == "scan_p95_ms"
    assert [m["name"] for m in cell.end_to_end] == ["scan_p95_ms", "setup_s"]
    assert set(cell.config["limits"]) == set(cell.kind.LIGHT
                                             + cell.kind.HEAVY)
    for other in ("venue_scan_1m.refresh", "sensor_frame_40k.stream"):
        assert not set(NEW) & {m["name"] for m in
                               spec.resolve(other).per_layer}


def test_a_traced_run_at_a_small_size_is_correct():
    cell = spec.resolve(CELL)
    cell.config.update(points=4_000, people=25)
    cell.traffic.update(pool=1, walk_frames=4)
    result, info, lines = run.bench(cell, 2**31 + 9, 0.9, True,
                                    device="cpu")
    assert result["correct"] is True and result["failed"] == 0, lines
    for name in NEW[:4]:
        assert result["metrics"][name]["value"] > 0, name
    # the CPU's session counts no host reads: nothing to read
    assert "sequence.host_reads" not in result["metrics"]
    assert set(result["checks"]) == set(cell.kind.LIGHT + cell.kind.HEAVY)
    assert "pool 1 x 16,000 points" in info[1]


def test_a_port_without_the_entry_point_runs_without_its_span():
    kind = spec.load_kind("sequence")
    assert [name for _, _, name in kind.SPANS] == [
        "people_of_cloud", "temporal_flow", "match_people",
        "accumulate_samples"]
    missing = (kind.SPANS[0][0], "no_such_function", "nothing")
    assert kind._present(kind.SPANS + (missing,)) == kind.SPANS


def _scan(i, spans):
    """A port record: (name, parent, seconds, counters) a span."""
    sc = profiling.Scan(i)
    for name, parent, seconds, counters in spans:
        sc.spans.append(profiling.SpanRecord(
            name, i, parent, 0, {}, dict(counters), int(seconds * 1e9)))
    return sc


def _sequence(i, match_s, nodes_s, reads):
    """A sequence call's records: the nested analysis counts 20 reads that
    the reader leaves out, a frame's guard 2 and the tracking ``reads``."""
    return _scan(i, [
        ("pipeline.sequence", None, 0.1, {}),
        ("pipeline.analyze", 0, 0.03, {}),
        ("pipeline.readback", 1, 0.005, {"host_reads": 20}),
        ("sequence.fit", 0, 0.001, {}),
        ("sequence.frame", 0, 0.01, {}),
        ("pipeline.guard", 4, 0.0, {"host_reads": 2}),
        ("temporal.flow", 0, 0.05, {}),
        ("temporal.match", 6, match_s, {"temporal.pair_tests": 9}),
        ("temporal.nodes", 6, nodes_s, {}),
        ("temporal.bottlenecks", 6, 0.001, {"host_reads": reads})])


RECORDS = [_sequence(0, 0.020, 0.010, 5), _sequence(1, 0.030, 0.014, 3)]


@pytest.mark.parametrize("name,want", [
    ("temporal.match_ms", 25.0), ("temporal.nodes_ms", 12.0),
    ("sequence.host_reads", 6.0)])
def test_record_readers_take_means_a_call(name, want):
    read = spec.metric_reader(name)
    assert read(run.TracedRun({}, 5, None, [], {}, None, RECORDS,
                              2)) == pytest.approx(want)
    assert read(run.TracedRun({}, 2, None, [], {}, None)) is None


def test_host_reads_need_a_session_that_counts_and_a_sequence():
    read = spec.metric_reader("sequence.host_reads")
    uncounted = [_sequence(0, 0.02, 0.01, 0)]
    for sp in uncounted[0].spans:
        sp.counters.pop("host_reads", None)
    assert read(run.TracedRun({}, 1, None, [], {}, None, uncounted,
                              1)) is None
    scans = [_scan(0, [("pipeline.analyze", None, 0.03, {"host_reads": 3})])]
    assert read(run.TracedRun({}, 1, None, [], {}, None, scans, 1)) is None


@pytest.mark.parametrize("name,span", [("temporal.ms", "temporal_flow"),
                                       ("sequence.frames_ms",
                                        "people_of_cloud")])
def test_span_readers_take_means_a_call(name, span):
    read = spec.metric_reader(name)
    tr = run.TracedRun({span: [0.01, 0.02, 0.03]}, 2, None, [], {}, None)
    assert read(tr) == pytest.approx(30.0)
    assert read(run.TracedRun({}, 2, None, [], {}, None)) is None


def test_configuration_states_the_deployment():
    cfg = json.loads((spec.HERE / "configs" / "sequence_4x100k.json")
                     .read_text())
    assert cfg["kind"] == "sequence" and cfg["reduced"] == []
    assert (cfg["frames"], cfg["points"], cfg["dt"], cfg["people"],
            cfg["person_points"], cfg["speed"]) == (4, 100_000, 0.5, 500,
                                                    40, 1.0)
    flow = cfg["pipeline"]["flow"]
    assert (flow["track_max_speed"], flow["track_consistency_tol"],
            flow["track_min_height"]) == (3.0, 0.75, 0.3)
    scan = json.loads((spec.HERE / "configs" / "venue_scan_1m.json")
                      .read_text())["pipeline"]
    for group, values in scan.items():
        if isinstance(values, dict):
            for k, v in values.items():
                assert cfg["pipeline"][group][k] == v, (group, k)
    assert np.isclose(venue.venue_size(100_000, 5.56)[0] * 2, 94.868,
                      atol=1e-3)
