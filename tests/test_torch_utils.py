"""The port's store, project manager, report and figures against the JAX
package's: the cases of ``tests/test_utils.py`` on the port (its pipeline
on the CPU), the HTML report of both packages equal on the same result
dicts, and the congestion figure's cell repair.

The port's report names its own engine in the footer; the comparison
swaps that one phrase and holds the rest equal byte for byte.
"""

import dataclasses
import datetime
import os
import re

import numpy as np
import pytest

from lidar_ai_recommendation_software_tpu.utils import report as jax_report
from lidar_ai_recommendation_software_tpu.utils import viz as jax_viz
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.utils import report
from lidar_ai_recommendation_software_tpu_torch.utils import viz
from lidar_ai_recommendation_software_tpu_torch.utils.project import (
    ProjectManager)
from lidar_ai_recommendation_software_tpu_torch.utils.report import (
    generate_report, risk_level)
from lidar_ai_recommendation_software_tpu_torch.utils.store import (
    ResultsStore)

JAX_ENGINE = "the TPU-native LiDAR crowd-analytics engine"


@pytest.fixture(scope="module")
def port_out(fixture_points):
    return Pipeline(device="cpu").analyze(fixture_points)


class TestPlaceholderTranslation:
    """sqlite '?' -> psycopg2 '%s' (PostgresStore._exec dialect hook)."""

    def test_basic(self):
        from lidar_ai_recommendation_software_tpu_torch.utils.store import (
            translate_placeholders as t)
        assert t("SELECT 1 WHERE a=? AND b=?") == \
            "SELECT 1 WHERE a=%s AND b=%s"

    def test_literals_untouched(self):
        from lidar_ai_recommendation_software_tpu_torch.utils.store import (
            translate_placeholders as t)
        assert t("INSERT INTO x (q) VALUES ('what?')") == \
            "INSERT INTO x (q) VALUES ('what?')"
        assert t("SELECT '?''?' , ?") == "SELECT '?''?' , %s"
        assert t("SELECT ? WHERE a LIKE 'x%' OR b LIKE c || '%'") == \
            "SELECT %s WHERE a LIKE 'x%' OR b LIKE c || '%'"
        assert t("SELECT 100 % 7, ?") == "SELECT 100 %% 7, %s"


class TestPostgresStore:
    """Live-server integration, wherever LIDAR_PG_DSN or DATABASE_URL
    points at a reachable PostgreSQL (skipped otherwise)."""

    def test_roundtrip(self):
        dsn = os.environ.get("LIDAR_PG_DSN",
                             os.environ.get("DATABASE_URL", ""))
        if not dsn.startswith(("postgres://", "postgresql://")):
            pytest.skip("no PostgreSQL DSN configured")
        psycopg2 = pytest.importorskip("psycopg2")
        from lidar_ai_recommendation_software_tpu_torch.utils.store import (
            PostgresStore)
        try:
            s = PostgresStore(dsn)
        except psycopg2.OperationalError:
            pytest.skip("PostgreSQL server unreachable")
        eid = s.create_event("it's a test?")
        aid = s.create_analysis(event_id=eid, point_summary={"n": 3})
        s.save_density_results(aid, {"total_people": 3})
        s.save_flow_results(aid, {"avg_speed": 1.0})
        rid = s.save_report(aid, "<html>100% done?</html>")
        assert s.get_report(rid)["html"] == "<html>100% done?</html>"
        assert s.get_density_results(aid)["total_people"] == 3
        rows = s.analyses_for_event(eid)
        assert rows and rows[-1]["has_density"]
        s.close()


class TestStore:
    def test_project_dataset_roundtrip(self, tmp_path):
        s = ResultsStore(str(tmp_path / "db.sqlite"))
        pid = s.create_project("p", "d")
        did = s.insert_dataset(pid, "cloud", np.random.rand(50, 3),
                               {"src": "test"})
        ds = s.get_dataset(did)
        assert ds["point_count"] == 50
        assert ds["points"].shape == (50, 3)
        assert ds["metadata"]["src"] == "test"
        assert s.list_datasets(pid)[0]["name"] == "cloud"
        s.close()

    def test_cascade_delete(self):
        s = ResultsStore()
        pid = s.create_project("p")
        s.insert_dataset(pid, "c", np.zeros((3, 3)))
        s.delete_project(pid)
        assert s.list_datasets(pid) == []

    def test_analysis_results_flow(self):
        s = ResultsStore()
        eid = s.create_event("concert", venue="arena")
        aid = s.create_analysis(event_id=eid, point_summary={"n": 10})
        s.save_density_results(aid, {"total_people": 3,
                                     "grid": np.eye(2)})
        s.save_flow_results(aid, {"avg_speed": 1.2})
        s.save_recommendations(aid, {"issues": []})
        s.save_report(aid, "<html></html>", title="t")
        assert s.get_density_results(aid)["total_people"] == 3
        assert s.get_flow_results(aid)["avg_speed"] == 1.2
        view = s.analyses_for_event(eid)
        assert view[0]["has_density"] and view[0]["has_flow"]
        assert s.list_reports()[0]["title"] == "t"

    def test_latest_result_wins(self):
        s = ResultsStore()
        aid = s.create_analysis()
        s.save_density_results(aid, {"v": 1})
        s.save_density_results(aid, {"v": 2})
        assert s.get_density_results(aid)["v"] == 2

    def test_each_package_reads_the_others_database(self, tmp_path):
        """One schema: a database either package wrote, the other reads."""
        from lidar_ai_recommendation_software_tpu.utils.store import (
            ResultsStore as JaxStore, postgres_ddl as jax_ddl)
        from lidar_ai_recommendation_software_tpu_torch.utils.store import (
            postgres_ddl)
        assert postgres_ddl() == jax_ddl()
        for writer, reader in ((ResultsStore, JaxStore),
                               (JaxStore, ResultsStore)):
            path = str(tmp_path / f"{writer.__module__}.sqlite")
            s = writer(path)
            pid = s.create_project("p")
            did = s.insert_dataset(pid, "c", np.arange(9.0).reshape(3, 3))
            aid = s.create_analysis(event_id=s.create_event("e"))
            s.save_density_results(aid, {"total_people": 7})
            s.close()
            r = reader(path)
            np.testing.assert_allclose(r.get_dataset(did)["points"],
                                       np.arange(9.0).reshape(3, 3))
            assert r.get_density_results(aid) == {"total_people": 7}
            r.close()


class TestProjectManager:
    def test_project_file_roundtrip(self, tmp_path):
        pm = ProjectManager()
        pm.new_project("venue A", "test project")
        pts = np.random.RandomState(0).rand(100, 3)
        pm.add_dataset("scan1", pts, {"sensor": "VLP-16"})
        path = str(tmp_path / "proj")
        pm.save_project(path)
        assert os.path.exists(path + ".lcaz")

        pm2 = ProjectManager()
        proj = pm2.open_project(path + ".lcaz")
        assert proj.name == "venue A"
        assert len(pm2.datasets) == 1
        np.testing.assert_allclose(pm2.datasets[0].points, pts, atol=1e-6)
        assert pm2.datasets[0].metadata["sensor"] == "VLP-16"

    def test_rejects_non_project_zip(self, tmp_path):
        import zipfile
        p = str(tmp_path / "fake.lcaz")
        with zipfile.ZipFile(p, "w") as z:
            z.writestr("manifest.json", '{"format": "other"}')
        with pytest.raises(ValueError):
            ProjectManager().open_project(p)

    def test_run_analysis_and_export(self, tmp_path, fixture_points):
        pm = ProjectManager(db_path=str(tmp_path / "p.sqlite"))
        pm.new_project("venue")
        pm.add_dataset("fixture", fixture_points)
        out = pm.run_analysis(device="cpu")
        assert out["density"]["total_people"] == 446
        pm.export_results_json(str(tmp_path / "r.json"), "fixture")
        pm.export_results_csv(str(tmp_path / "r.csv"), "fixture")
        csv = open(tmp_path / "r.csv").read()
        assert "total_people,446" in csv
        assert "hotspot_1" in csv

    def test_run_analysis_needs_the_card_by_default(self, fixture_points):
        """``run_analysis`` runs on the card unless asked for the CPU:
        without one it fails with the pipeline's message."""
        import torch
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        pm = ProjectManager()
        pm.new_project("venue")
        pm.add_dataset("fixture", fixture_points)
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            pm.run_analysis()


class TestReport:
    def test_risk_bands(self):
        assert risk_level(0.5) == "Low"
        assert risk_level(1.5) == "Moderate"
        assert risk_level(3.0) == "High"
        assert risk_level(5.0) == "Critical"

    def test_report_html(self, port_out):
        out = port_out
        html = generate_report(out["density"], out["flow"],
                               out["recommendations"],
                               processed_summary={"points": 10000})
        assert html.startswith("<!DOCTYPE html>")
        assert "Executive Summary" in html
        assert "446" in html
        assert "data:image/png;base64," in html  # embedded figures
        assert "Critical crowd density" in html
        for step in out["recommendations"]["actions"][0]["steps"]:
            assert step[:20] in html

    def test_pdf_report_is_real_pdf(self, tmp_path, fixture_points):
        """The PDF export writes an actual PDF (magic %PDF-, multiple
        pages)."""
        pm = ProjectManager()
        pm.new_project("venue")
        pm.add_dataset("fixture", fixture_points)
        pm.run_analysis(device="cpu")
        path = tmp_path / "out.pdf"
        pm.export_report_pdf(str(path))
        data = path.read_bytes()
        assert data[:5] == b"%PDF-"
        assert data.count(b"/Type /Page") >= 3  # summary + >=2 figures

    def test_report_without_figures(self):
        html = generate_report(
            {"total_people": 0, "avg_density": 0.0, "max_density": 0.0,
             "hotspots": []},
            {"avg_speed": 0.0, "dominant_direction": "N/A",
             "bottlenecks": [],
             "flow_vectors": {"positions": np.zeros((0, 2)),
                              "vectors": np.zeros((0, 2)),
                              "magnitudes": np.zeros(0)}},
            {"issues": [], "actions": [], "opportunities": []},
            include_figures=False)
        assert "No density hotspots" in html
        assert "No significant bottlenecks" in html


@pytest.fixture
def pinned_clock(monkeypatch):
    """``datetime.datetime.now()`` fixed, for both packages' reports."""
    class Fixed(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)

    monkeypatch.setattr(datetime, "datetime", Fixed)


def _sections(html):
    return re.findall(r"<h2>(.*?)</h2>", html)


@pytest.mark.parametrize("figures", [False, True])
def test_report_equals_jax_on_the_same_results(port_out, pinned_clock,
                                               figures):
    """Both packages' ``generate_report`` on the same result dicts: equal
    HTML without figures (the footer's engine name aside), the same
    sections and as many embedded PNGs with them."""
    d, f, r = port_out["density"], port_out["flow"], \
        port_out["recommendations"]
    summary = {"source": "sample", "points": 10000}
    got = report.generate_report(d, f, r, processed_summary=summary,
                                 include_figures=figures)
    want = jax_report.generate_report(d, f, r, processed_summary=summary,
                                      include_figures=figures)
    assert "2026-01-02 03:04:05" in got
    if not figures:
        assert got == want.replace(JAX_ENGINE, report.ENGINE)
        return
    assert _sections(got) == _sections(want)
    assert "Congestion Risk" in _sections(got)
    n = got.count("data:image/png;base64,")
    assert n == want.count("data:image/png;base64,") == 3


class TestViz:
    def test_figures_render(self, fixture_points, port_out):
        out = port_out
        for fig in [
            viz.point_cloud_figure(fixture_points,
                                   engine="matplotlib"),
            viz.density_heatmap_figure(out["density"],
                                       engine="matplotlib"),
            viz.flow_figure(out["flow"], engine="matplotlib"),
            viz.congestion_figure(out["density"], out["flow"],
                                  engine="matplotlib"),
        ]:
            b64 = viz.fig_to_base64(fig)
            assert len(b64) > 1000

    def test_color_modes_and_projection_branches(self, fixture_points):
        pts = fixture_points[:3000]
        for mode in ("Height", "Density", "Distance", "Cluster"):
            clusters = (np.arange(len(pts)) % 7 if mode == "Cluster"
                        else None)
            fig = viz.point_cloud_figure(pts, clusters=clusters,
                                         color_by=mode,
                                         engine="matplotlib")
            assert len(viz.fig_to_base64(fig)) > 1000
        for dims in (("x", "y"), ("x", "z"), ("y", "z")):
            fig = viz.density_heatmap_figure(
                points=pts, projection_dims=dims, resolution=100,
                engine="matplotlib")
            assert len(viz.fig_to_base64(fig)) > 1000
        fig = viz.density_heatmap_figure(
            points=pts, as_heatmap=False, engine="matplotlib")
        assert len(viz.fig_to_base64(fig)) > 1000

    def test_plotly_builders(self, fixture_points, port_out):
        pytest.importorskip("plotly")
        out = port_out
        figs = [
            viz.point_cloud_figure(fixture_points, engine="plotly"),
            viz.density_heatmap_figure(out["density"], engine="plotly"),
            viz.density_heatmap_figure(points=fixture_points,
                                       projection_dims=("x", "z"),
                                       engine="plotly"),
            viz.density_heatmap_figure(points=fixture_points,
                                       as_heatmap=False,
                                       engine="plotly"),
            viz.flow_figure(out["flow"], engine="plotly"),
            viz.congestion_figure(out["density"], out["flow"],
                                  engine="plotly"),
        ]
        for fig in figs:
            assert viz.is_plotly_figure(fig)
            assert fig.to_dict()["data"]

    def test_engine_auto_without_plotly(self, fixture_points):
        if viz.plotly_go() is not None:
            pytest.skip("plotly installed: auto resolves to plotly")
        fig = viz.point_cloud_figure(fixture_points[:1000])
        assert not viz.is_plotly_figure(fig)
        with pytest.raises(ImportError):
            viz.point_cloud_figure(fixture_points[:1000],
                                   engine="plotly")


def _bubbles(fig):
    """The congestion figure's data: (positions, risk 0-10, sizes)."""
    sc = fig.axes[0].collections[0]
    return (np.asarray(sc.get_offsets()), np.asarray(sc.get_array()),
            np.asarray(sc.get_sizes()))


def test_congestion_figure_at_one_metre_equals_jax(port_out):
    """At the default 1 m cells the repair changes nothing: the same
    bubbles as the JAX package's figure on the same results."""
    d, f = port_out["density"], port_out["flow"]
    assert d["grid_size"] == 1.0
    got = _bubbles(viz.congestion_figure(d, f, engine="matplotlib"))
    want = _bubbles(jax_viz.congestion_figure(d, f, engine="matplotlib"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1].max() == 10.0


def test_congestion_figure_reads_cells_of_its_grid_size():
    """At 0.5 m cells a flow node reads the cell (pos - origin) / 0.5 of
    the density map. The JAX package divides by 1 m whatever the grid
    (its ``utils/viz.py:358-361``), and reads other cells."""
    g = 0.5
    dmap = np.arange(1.0, 17.0).reshape(4, 4)  # [ix, iy], x-major
    ii, jj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    pos = np.stack([(ii.ravel() + 0.5) * g + 10.0,
                    (jj.ravel() + 0.5) * g - 3.0], axis=1)
    density = {"density_map": dmap, "origin": (10.0, -3.0), "grid_size": g}
    flow = {"flow_vectors": {"positions": pos,
                             "magnitudes": np.full(16, 0.9)}}
    want = 10.0 * dmap.ravel() / dmap.max()
    _, risk, _ = _bubbles(viz.congestion_figure(
        density, flow, engine="matplotlib"))
    np.testing.assert_allclose(risk, want, rtol=1e-12)
    _, jax_risk, _ = _bubbles(jax_viz.congestion_figure(
        density, flow, engine="matplotlib"))
    assert not np.allclose(jax_risk, want)


def _risk_of_cells(d, f):
    """The congestion risk the figure should draw: each flow node reads
    the density cell ``(pos - origin) / grid_size`` of its result."""
    pos = np.asarray(f["flow_vectors"]["positions"])
    grid = np.asarray(d["density_map"])
    ix = np.clip(((pos[:, 0] - d["origin"][0]) / d["grid_size"]).astype(int),
                 0, grid.shape[0] - 1)
    iy = np.clip(((pos[:, 1] - d["origin"][1]) / d["grid_size"]).astype(int),
                 0, grid.shape[1] - 1)
    risk = grid[ix, iy] / (np.asarray(f["flow_vectors"]["magnitudes"]) + 0.1)
    return 10.0 * risk / risk.max()


def test_pipeline_result_names_its_cell_for_the_figure(fixture_points):
    """A pipeline run at 0.5 m cells carries its cell edge in the density
    dict, and the congestion figure (so the report) reads those cells."""
    from lidar_ai_recommendation_software_tpu_torch.config import (
        MONOLITH_CONFIG)
    cfg = MONOLITH_CONFIG.replace(density=dataclasses.replace(
        MONOLITH_CONFIG.density, grid_size=0.5))
    out = Pipeline(cfg, device="cpu").analyze(fixture_points)
    d, f = out["density"], out["flow"]
    assert d["grid_size"] == 0.5
    _, risk, _ = _bubbles(viz.congestion_figure(d, f, engine="matplotlib"))
    np.testing.assert_allclose(risk, _risk_of_cells(d, f), rtol=1e-12)


def test_neural_result_names_the_models_cell(fixture_points):
    """A ``NeuralPipeline`` result's cell is the venue's extent over the
    model's grid, and the congestion figure reads cells of that edge."""
    from lidar_ai_recommendation_software_tpu_torch.neural import (
        NeuralPipeline)
    pipe = NeuralPipeline(device="cpu")
    out = pipe.analyze(fixture_points)
    d, f = out["density"], out["flow"]
    extent = np.ptp(fixture_points[:, :2], axis=0).max() + 1e-6
    np.testing.assert_allclose(d["grid_size"],
                               extent / pipe.train_config.grid, rtol=1e-12)
    assert d["grid_size"] != 1.0
    _, risk, _ = _bubbles(viz.congestion_figure(d, f, engine="matplotlib"))
    np.testing.assert_allclose(risk, _risk_of_cells(d, f), rtol=1e-12)


class TestCLI:
    def test_sample_info_analyze(self, tmp_path, capsys):
        from lidar_ai_recommendation_software_tpu_torch.cli import main
        venue = str(tmp_path / "v.npy")
        assert main(["sample", "--out", venue]) == 0
        assert main(["info", venue]) == 0
        report_path = str(tmp_path / "r.html")
        jout = str(tmp_path / "r.json")
        db = str(tmp_path / "cli.sqlite")
        assert main(["analyze", venue, "--report", report_path, "--json",
                     jout, "--store", db, "--no-figures",
                     "--device", "cpu"]) == 0
        captured = capsys.readouterr().out
        assert "people detected : 446" in captured
        assert os.path.exists(report_path) and os.path.exists(jout)
        s = ResultsStore(db)
        assert len(s.list_reports()) == 1

    def test_analyze_downsample_options(self, tmp_path, capsys):
        """--downsample (reference random semantics) and --voxel (device
        voxel grid) both pre-thin the cloud before analysis."""
        from lidar_ai_recommendation_software_tpu_torch.cli import main
        from lidar_ai_recommendation_software_tpu_torch.synthetic import (
            sample_venue)
        venue = str(tmp_path / "v.npy")
        np.save(venue, sample_venue())

        assert main(["analyze", venue, "--downsample", "0.5",
                     "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "downsampled to 5,000 points" in out

        assert main(["analyze", venue, "--voxel", "0.4",
                     "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "voxel-downsampled to" in out
        n = int(out.split("voxel-downsampled to ")[1].split(" ")[0]
                .replace(",", ""))
        assert 0 < n < 10_000
