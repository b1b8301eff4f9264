"""The readers of the people's extraction, ``density.people_ms`` and
``kernels.people_roofline_pct`` (``crowdbench/metrics/``), on a stub of a
traced run: nothing where no record of the port shows the ``place_dense``
centroid route or where nothing was traced, the value where the route
shows, and the bytes against a hand count."""

import pytest

from crowdbench import people_roofline, run, spec
from crowdbench.trace import Trace
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
    Scan, SpanRecord)

HBM = 3.35e12


def _records(*routes):
    """One scan of the port a route: a ``pipeline.analyze`` root and, for
    a route that is not None, its ``density.centroids`` span."""
    scans = []
    for i, route in enumerate(routes):
        spans = [SpanRecord("pipeline.analyze", i, None, 1, {})]
        if route is not None:
            spans.append(SpanRecord("density.centroids", i, 0, 2, {
                "route": route, "rows": 3_145_728, "slots": 393_216}))
        scans.append(Scan(i, spans))
    return scans


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace():
    """Two profiled scans; inside each ``extract_people`` span one kernel
    is launched (50 and 30 us), and one outside it (100 us)."""
    return Trace([
        _ev("user_annotation", "bench.analyze", 0, 1000),
        _ev("user_annotation", "bench.extract_people", 100, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        _ev("kernel", "place_dense_kernel", 150, 50, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 400, 5, corr=2),
        _ev("kernel", "flow", 420, 100, corr=2),
        _ev("user_annotation", "bench.analyze", 1000, 1000),
        _ev("user_annotation", "bench.extract_people", 1100, 200),
        _ev("cuda_runtime", "cudaLaunchKernel", 1110, 5, corr=3),
        _ev("kernel", "sort", 1200, 30, corr=3),
    ])


def _run(records, trace=True, spans=True):
    return run.TracedRun(
        spans={"extract_people": [0.004, 0.006]} if spans else {},
        scans=2, trace=_trace() if trace else None, profiled=[0, 1],
        clustered={0: 1_000, 1: 3_000}, peaks={"hbm_bytes_per_s": HBM},
        records=records, recorded=len(records))


PEOPLE_MS = spec.metric_reader("density.people_ms")
PEOPLE_ROOFLINE = spec.metric_reader("kernels.people_roofline_pct")


def test_the_bytes_are_a_hand_count():
    # xyz (3 x 4 bytes) and a cluster id (4 bytes) a clustered point
    assert people_roofline.people_bytes(1) == 3 * 4 + 4
    assert people_roofline.people_bytes(2_100_000) == 33_600_000


def test_the_readings_where_the_route_shows():
    r = _run(_records("place_dense", "place_dense"))
    assert PEOPLE_MS(r) == pytest.approx(5.0)  # 10 ms over 2 scans
    # 16 bytes of 4,000 clustered points over the 80 us launched inside
    # the two spans (the 100 us kernel outside them not counted)
    want = 100.0 * (16 * 4_000 / HBM) / 80e-6
    assert PEOPLE_ROOFLINE(r) == pytest.approx(want)


@pytest.mark.parametrize("routes", [(), (None, None), ("indexed",),
                                    ("place_dense", "indexed")],
                         ids=["no_session", "no_span", "indexed", "mixed"])
def test_nothing_where_the_route_does_not_show(routes):
    r = _run(_records(*routes))
    assert PEOPLE_MS(r) is None
    assert PEOPLE_ROOFLINE(r) is None


def test_nothing_where_nothing_was_traced():
    records = _records("place_dense")
    assert PEOPLE_ROOFLINE(_run(records, trace=False)) is None
    assert PEOPLE_MS(_run(records, spans=False)) is None
    assert PEOPLE_MS(run.TracedRun(
        spans={}, scans=0, trace=None, profiled=[], clustered={},
        peaks=None, records=records, recorded=1)) is None
