"""The port's ``compat``, ``utils/profiling``, ``utils/resilience`` and
``utils/store``'s PostgreSQL backend: the cases of
``tests/test_{compat,profiling,resilience,store_postgres}.py`` on the
port (its pipeline on the CPU), and the reference-compatible façade held
against the JAX package's on the same points (labels and people equal,
as ``tests/test_torch_pipeline.py`` holds the pipelines).
"""

import re
import sys

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu import compat as jax_compat
from lidar_ai_recommendation_software_tpu_torch import compat
from lidar_ai_recommendation_software_tpu_torch.utils import profiling
from lidar_ai_recommendation_software_tpu_torch.utils import resilience
from lidar_ai_recommendation_software_tpu_torch.utils import store as store_mod
from port_helpers import UTM_SHIFT
from test_store_postgres import FakeCursor, fake_pg  # noqa: F401


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


# -- compat (tests/test_compat.py) -------------------------------------------------

def test_reference_call_pattern(tmp_path, fixture_points):
    from lidar_ai_recommendation_software_tpu_torch.utils.io import (
        save_points)
    path = str(tmp_path / "venue.xyz")
    save_points(path, fixture_points)

    points = compat.load_lidar_data(path)
    assert points.shape[1] == 3

    processed = compat.preprocess_lidar_data(points, device="cpu")
    for key in ("points", "colors", "normals", "clusters",
                "ground_plane", "dimensions"):
        assert key in processed
    assert processed["points"].shape[0] == processed["clusters"].shape[0]
    assert set(processed["dimensions"]) >= {"x_range", "y_range",
                                            "width", "length"}

    density = compat.CrowdDensityModel().analyze(processed)
    assert density["total_people"] > 0
    assert "hotspots" in density and "density_map" in density

    flow = compat.CrowdFlowModel().analyze(processed)
    assert set(flow) >= {"flow_vectors", "avg_speed",
                         "dominant_direction", "bottlenecks"}

    recs = compat.generate_recommendations(density, flow)
    assert set(recs) == {"issues", "actions", "opportunities"}

    html = compat.generate_report(density, flow, recs,
                                  include_figures=False)
    assert html.startswith("<!DOCTYPE html>")


def test_people_positions_and_grid_density(fixture_points):
    processed = compat.preprocess_lidar_data(fixture_points, device="cpu")
    pos = compat.extract_people_positions(processed)
    assert pos.ndim == 2 and pos.shape[1] == 2
    gx, gy, grid = compat.calculate_grid_density(
        pos, processed["dimensions"]["x_range"],
        processed["dimensions"]["y_range"])
    assert grid.shape == (len(gx), len(gy))
    assert grid.sum() * 1.0 == len(pos)  # counts conserved


def test_downsample_semantics():
    pts = np.arange(300).reshape(100, 3).astype(float)
    np.random.seed(0)
    out = compat.downsample_point_cloud(pts, 0.25)
    assert out.shape == (25, 3)
    same = compat.downsample_point_cloud(pts, 1.0)
    assert same is pts


def test_downsample_consumes_numpy_state_as_jax():
    """The same rows survive, and numpy's global stream is left where the
    JAX package leaves it."""
    pts = np.random.RandomState(1).rand(1000, 3)
    np.random.seed(5)
    got = compat.downsample_point_cloud(pts, 0.3)
    got_next = np.random.rand(4)
    np.random.seed(5)
    want = jax_compat.downsample_point_cloud(pts, 0.3)
    want_next = np.random.rand(4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_next, want_next)


def test_risk_level_bands():
    m = compat.CrowdDensityModel
    assert m.calculate_risk_level(0.5) == "Low"
    assert m.calculate_risk_level(2.0) == "Moderate"
    assert m.calculate_risk_level(3.0) == "High"
    assert m.calculate_risk_level(4.5) == "Critical"


def test_preprocess_matches_jax(fixture_points):
    """``preprocess_lidar_data`` and the façade models on the same points:
    points, normals and labels as the JAX package's, the plane fit within
    1e-4 and the colours within 1e-6 (as ``tests/test_torch_preprocess.py``),
    people within 1e-5, the density dict equal and the flow floats within
    1e-5."""
    got = compat.preprocess_lidar_data(fixture_points, device="cpu")
    want = jax_compat.preprocess_lidar_data(fixture_points)
    for key in ("points", "normals", "clusters"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["ground_plane"], want["ground_plane"],
                               atol=1e-4)
    np.testing.assert_allclose(got["colors"], want["colors"], atol=1e-6)
    assert got["dimensions"] == pytest.approx(want["dimensions"])
    # centroids: float32 sums in another order, ulps apart
    np.testing.assert_allclose(compat.extract_people_positions(got),
                               jax_compat.extract_people_positions(want),
                               atol=1e-5)
    d = compat.CrowdDensityModel().analyze(got)
    jd = jax_compat.CrowdDensityModel().analyze(want)
    for key in ("total_people", "avg_density", "max_density", "hotspots"):
        assert d[key] == jd[key], key
    np.testing.assert_array_equal(d["density_map"], jd["density_map"])
    f = compat.CrowdFlowModel().analyze(got)
    jf = jax_compat.CrowdFlowModel().analyze(want)
    assert f["bottlenecks"] == jf["bottlenecks"]
    assert abs(f["avg_speed"] - jf["avg_speed"]) < 1e-5


def test_preprocess_keeps_utm_coordinates(fixture_points):
    """``preprocess_lidar_data`` does not recentre, as the JAX package's
    does not: on 2,000 points shifted by a UTM offset its points are the
    input's own float32 coordinates, and its points, normals and labels
    the JAX package's."""
    pts = fixture_points[:2000] + UTM_SHIFT
    got = compat.preprocess_lidar_data(pts, device="cpu")
    want = jax_compat.preprocess_lidar_data(pts)
    assert np.abs(got["points"][:, :2]).min() > 4096.0
    kept = {tuple(p) for p in pts.astype(np.float32)}
    assert all(tuple(p) in kept for p in got["points"])
    for key in ("points", "normals", "clusters"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["dimensions"] == pytest.approx(want["dimensions"])


def test_preprocess_needs_the_card_by_default(fixture_points):
    _no_card()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        compat.preprocess_lidar_data(fixture_points)


# -- profiling (tests/test_profiling.py) ---------------------------------------------

def test_stage_timing_registry():
    profiling.reset_timings()
    with profiling.stage("unit-test-stage"):
        _ = sum(range(1000))
    t = profiling.timings()
    assert t["unit-test-stage"]["count"] == 1
    assert t["unit-test-stage"]["mean_ms"] >= 0


def test_stage_annotates_torch_profiler_traces(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("annotated-stage"):
            torch.ones(8).sum()
    names = {e.key for e in prof.key_averages()}
    assert "lidar.annotated-stage" in names
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_desktop_module_imports():
    import lidar_ai_recommendation_software_tpu_torch.desktop as d
    assert callable(d.main)


def test_streamlit_app_importable_without_streamlit():
    import lidar_ai_recommendation_software_tpu_torch.app as a
    assert hasattr(a, "main")


# -- resilience (tests/test_resilience.py) -------------------------------------------

def test_device_healthy_on_cpu():
    assert resilience.device_healthy(timeout_s=30.0, device="cpu")


def test_device_healthy_false_without_a_card():
    _no_card()
    assert not resilience.device_healthy(timeout_s=30.0, attempts=1,
                                         retry_delay_s=0.0)


def test_device_healthy_retries_transient_failure():
    calls = {"n": 0}

    def flaky_probe():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return 1.0

    assert resilience.device_healthy(timeout_s=5.0, attempts=3,
                                     retry_delay_s=0.0, probe=flaky_probe)
    assert calls["n"] == 2


def test_device_healthy_false_after_exhausted_attempts():
    def dead_probe():
        raise RuntimeError("no device")

    assert not resilience.device_healthy(timeout_s=5.0, attempts=2,
                                         retry_delay_s=0.0,
                                         probe=dead_probe)


def test_device_healthy_non_numeric_probe_is_unhealthy():
    assert not resilience.device_healthy(timeout_s=5.0, attempts=1,
                                         retry_delay_s=0.0,
                                         probe=lambda: object())


def test_device_healthy_logs_exception_class(caplog):
    import logging

    def empty_msg_probe():
        raise RuntimeError()

    with caplog.at_level(logging.WARNING, logger="lidar_tpu.resilience"):
        assert not resilience.device_healthy(timeout_s=5.0, attempts=1,
                                             retry_delay_s=0.0,
                                             probe=empty_msg_probe)
    assert any("RuntimeError" in r.getMessage() for r in caplog.records)


def test_fallback_pipeline_degrades_to_the_cpu(fixture_points, monkeypatch):
    """The card's pipeline failing with the device lost (``analyze``
    raises and the health probe fails) degrades to the port's pipeline
    on the CPU: the golden values, the same result as a CPU run, marked
    ``degraded``."""
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    fp = resilience.FallbackPipeline(Pipeline(device="cpu"))

    def boom(*args):
        raise RuntimeError("device lost")

    monkeypatch.setattr(fp.pipeline, "analyze", boom)
    monkeypatch.setattr(resilience, "device_answers_in_subprocess",
                        lambda device: False)
    out = fp.analyze(fixture_points)
    assert out["degraded"] is True
    assert fp.fallbacks == 1
    assert out["density"]["total_people"] == 446
    assert abs(out["density"]["max_density"] - 3.5) < 1e-9
    assert out["flow"]["dominant_direction"] == "E"
    assert len(out["recommendations"]["issues"]) == 10
    want = Pipeline(device="cpu").analyze(fixture_points)
    assert out["density"]["hotspots"] == want["density"]["hotspots"]
    assert out["recommendations"] == want["recommendations"]


def test_fallback_pipeline_normal_path(fixture_points):
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    fp = resilience.FallbackPipeline(Pipeline(device="cpu"))
    out = fp.analyze(fixture_points)
    assert "degraded" not in out
    assert fp.fallbacks == 0
    assert out["density"]["total_people"] == 446


def test_fallback_pipeline_reraises_on_a_healthy_device(fixture_points,
                                                        monkeypatch):
    """A failure on a device that answers the probe (a kernel that does
    not build or launch, a bad shape) is raised, not degraded."""
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    fp = resilience.FallbackPipeline(Pipeline(device="cpu"))
    probes = []

    def launch_fails(points):
        raise RuntimeError("radius_count kernel launch failed")

    def probe(device):
        probes.append(torch.device(device).type)
        return True

    monkeypatch.setattr(fp.pipeline, "analyze", launch_fails)
    monkeypatch.setattr(resilience, "device_answers_in_subprocess", probe)
    with pytest.raises(RuntimeError, match="launch failed"):
        fp.analyze(fixture_points)
    assert fp.fallbacks == 0 and probes == ["cpu"]


@pytest.mark.parametrize("probe", ["answers", "fails", "times_out"])
def test_fallback_pipeline_probes_in_a_subprocess(fixture_points,
                                                  monkeypatch, probe):
    """After a failure that poisons this process's device (a sticky CUDA
    error, which the in-process probe would report again), the probe runs
    in a fresh process: the failure is raised when that process answers,
    and the CPU answers when it fails or times out."""
    import subprocess
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    fp = resilience.FallbackPipeline(Pipeline(device="cpu"))
    runs = []

    def sticky(points):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    def run(argv, **kw):
        runs.append((argv, kw["timeout"]))
        if probe == "times_out":
            raise subprocess.TimeoutExpired(argv, kw["timeout"])
        return subprocess.CompletedProcess(
            argv, 0 if probe == "answers" else 1, "", "probe failed")

    monkeypatch.setattr(fp.pipeline, "analyze", sticky)
    monkeypatch.setattr(resilience, "matmul_probe", sticky)
    monkeypatch.setattr(resilience.subprocess, "run", run)
    if probe == "answers":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            fp.analyze(fixture_points)
        assert fp.fallbacks == 0
    else:
        out = fp.analyze(fixture_points)
        assert out["degraded"] is True and fp.fallbacks == 1
        assert out["density"]["total_people"] == 446
    (argv, timeout), = runs
    assert argv[:2] == [sys.executable, "-c"] and argv[3] == "cpu"
    assert timeout == resilience.HEALTH_TIMEOUT_S


def test_subprocess_probe_runs_the_matmul():
    """The real probe: a fresh interpreter runs the matmul on the CPU and
    exits 0; on a device it cannot reach it exits non-zero."""
    assert resilience.device_answers_in_subprocess("cpu", timeout_s=120.0)
    assert not resilience.device_answers_in_subprocess("meta-device",
                                                       timeout_s=120.0)


def test_fallback_pipeline_default_needs_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        resilience.FallbackPipeline()


# -- PostgreSQL backend (tests/test_store_postgres.py) -------------------------------

@pytest.fixture()
def pg_store(fake_pg):  # noqa: F811
    store = store_mod.open_store("postgresql://fake-host/db")
    assert isinstance(store, store_mod.PostgresStore)
    yield store
    store.close()


def test_open_store_routes_dsn_to_postgres(fake_pg):  # noqa: F811
    s = store_mod.open_store("postgres://u:p@h/db")
    assert isinstance(s, store_mod.PostgresStore)
    assert fake_pg._created[0].dsn == "postgres://u:p@h/db"
    assert fake_pg._created[0].autocommit is True


def test_bootstrap_creates_schema(pg_store):
    conn = pg_store.conn
    tables = {r[0] for r in conn._sq.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    assert {"projects", "datasets", "events", "analyses",
            "density_results", "flow_results", "recommendations",
            "reports"} <= tables
    ddl = conn.executed[0][0]
    assert "SERIAL PRIMARY KEY" in ddl and "AUTOINCREMENT" not in ddl
    assert "BYTEA" in ddl and "BLOB" not in ddl


def test_event_analysis_results_lifecycle(pg_store):
    eid = pg_store.create_event("Festival", venue="Park",
                                event_date="2026-08-20",
                                description="what? 100% fun")
    assert eid == 1
    events = pg_store.list_events()
    assert events[0]["name"] == "Festival"
    assert events[0]["description"] == "what? 100% fun"

    aid = pg_store.create_analysis(event_id=eid,
                                   point_summary={"n": 10_000})
    assert pg_store.save_density_results(
        aid, {"total_people": 446, "max_density": 3.5}) >= 1
    assert pg_store.save_flow_results(
        aid, {"avg_speed": 1.26, "dominant_direction": "E"}) >= 1
    assert pg_store.save_recommendations(
        aid, {"issues": [], "actions": [], "opportunities": []}) >= 1
    rid = pg_store.save_report(aid, "<html>r</html>", title="run 1")

    assert pg_store.get_density_results(aid)["total_people"] == 446
    assert pg_store.get_flow_results(aid)["dominant_direction"] == "E"
    assert pg_store.get_recommendations(aid)["issues"] == []
    rep = pg_store.get_report(rid)
    assert rep["html"] == "<html>r</html>" and rep["title"] == "run 1"
    assert [r["id"] for r in pg_store.list_reports()] == [rid]

    rows = pg_store.analyses_for_event(eid)
    assert len(rows) == 1
    assert rows[0]["has_density"] and rows[0]["has_flow"]


def test_project_dataset_lifecycle(pg_store):
    pid = pg_store.create_project("venue-A", description="desc")
    assert pg_store.get_project(pid)["name"] == "venue-A"
    pg_store.touch_project(pid)
    assert len(pg_store.list_projects()) == 1

    pts = np.random.RandomState(0).rand(100, 3)
    did = pg_store.insert_dataset(pid, "scan-1", pts,
                                  metadata={"fmt": "npy"})
    ds = pg_store.get_dataset(did)
    assert ds["point_count"] == 100
    np.testing.assert_allclose(ds["points"], pts, atol=1e-6)
    assert ds["metadata"] == {"fmt": "npy"}
    assert pg_store.list_datasets(pid)[0]["name"] == "scan-1"

    pg_store.delete_project(pid)
    assert pg_store.get_project(pid) is None
    assert pg_store.list_datasets(pid) == []


def test_missing_rows_return_none(pg_store):
    assert pg_store.get_project(999) is None
    assert pg_store.get_dataset(999) is None
    assert pg_store.get_report(999) is None
    assert pg_store.get_density_results(999) is None


def test_every_insert_used_returning(pg_store):
    pg_store.create_event("e")
    aid = pg_store.create_analysis(event_id=1)
    pg_store.save_density_results(aid, {"x": 1})
    inserts = [s for s, _ in pg_store.conn.executed
               if re.match(r"\s*INSERT", s, re.I)]
    assert inserts, "no INSERTs captured"
    assert all(re.search(r"\bRETURNING\s+id\b", s) for s in inserts)
    assert all("?" not in FakeCursor._strip_literals(s)
               for s, _ in pg_store.conn.executed)


def test_close_closes_connection(fake_pg):  # noqa: F811
    s = store_mod.open_store("postgresql://fake")
    s.close()
    assert fake_pg._created[-1].closed


def test_literal_question_mark_survives(pg_store):
    eid = pg_store.create_event("q?", description="50% off?")
    ev = [e for e in pg_store.list_events() if e["id"] == eid][0]
    assert ev["name"] == "q?" and ev["description"] == "50% off?"


def test_cli_analyze_store_postgres_dsn(fake_pg, tmp_path,  # noqa: F811
                                       capsys):
    """``lidar-crowd-torch analyze --store postgres://...`` reaches
    PostgresStore end to end."""
    from lidar_ai_recommendation_software_tpu_torch import cli
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        sample_venue)

    pts = sample_venue(n_points=2000, n_people=20, seed=4)
    p = tmp_path / "cloud.npy"
    np.save(p, pts)
    rc = cli.main(["analyze", str(p), "--store",
                   "postgresql://fake-host/db", "--event", "gig",
                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "stored analysis" in out

    conn = fake_pg._created[0]
    assert conn.closed
    inserts = [(s, a) for s, a in conn.executed
               if re.match(r"\s*INSERT", s, re.I)]
    tables = [re.search(r"INSERT\s+INTO\s+(\w+)", s, re.I).group(1)
              for s, _ in inserts]
    assert {"events", "analyses", "density_results", "flow_results",
            "recommendations"} <= set(tables)
    ev_args = [a for s, a in inserts if "INTO events" in s][0]
    assert "gig" in ev_args
