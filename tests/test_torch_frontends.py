"""The port's Streamlit app and Tkinter shell, driven headlessly by the
scripted fakes of ``tests/test_app_lifecycle.py`` and
``tests/test_desktop.py``: their cases on the port (its pipelines on the
CPU, ``main(device="cpu")``), the golden values through the app, and no
run on the CPU unless asked for.
"""

from __future__ import annotations

import importlib
import sys

import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.synthetic import sample_venue
from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
from lidar_ai_recommendation_software_tpu_torch.utils.store import (
    ResultsStore)
from test_app_lifecycle import FakeStreamlit, _texts
from test_desktop import FakeCanvas, FakeStringVar, FakeTk, fake_tk  # noqa: F401


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


@pytest.fixture()
def fake_app(monkeypatch, tmp_path):
    fake = FakeStreamlit()
    monkeypatch.setitem(sys.modules, "streamlit", fake)
    import lidar_ai_recommendation_software_tpu_torch.app as app_mod
    app = importlib.reload(app_mod)
    assert app.HAVE_STREAMLIT
    fake.script["SQLite path"] = str(tmp_path / "lifecycle.sqlite")

    def rerun(device="cpu"):
        fake.calls.clear()
        app.main(device=device)

    yield fake, rerun, str(tmp_path / "lifecycle.sqlite")
    monkeypatch.delitem(sys.modules, "streamlit", raising=False)
    importlib.reload(app_mod)


# -- the app (tests/test_app_lifecycle.py) -------------------------------------------

def test_db_backed_lifecycle(fake_app):
    fake, rerun, db_path = fake_app

    fake.script["Use generated sample data"] = True
    rerun()
    ss = fake.session_state
    assert ss.points is not None and len(ss.points) == 10_000
    aid = ss.analysis_id
    assert aid is not None
    store = ResultsStore(db_path)
    events = store.list_events()
    assert len(events) == 1
    assert store.analyses_for_event(events[0]["id"])

    fake.script["Run analysis"] = True
    rerun()
    fake.script["Run analysis"] = False
    assert ss.analysis_id == aid
    d = store.get_density_results(aid)
    f = store.get_flow_results(aid)
    assert d and d["total_people"] == 446  # golden fixture parity
    assert f and "avg_speed" in f
    assert store.get_recommendations(aid)
    assert ss.recs_saved

    fake.script["Generate report"] = True
    rerun()
    fake.script["Generate report"] = False
    reports = store.list_reports()
    assert len(reports) == 1
    assert any(n == "download_button" for n, _ in fake.calls)

    fake.script["Open report"] = True
    rerun()
    htmls = _texts(fake, "html")
    assert htmls and "<html" in htmls[-1].lower()

    with store.conn:
        n_recs = store.conn.execute(
            "SELECT COUNT(*) FROM recommendations WHERE analysis_id=?",
            (aid,)).fetchone()[0]
    assert n_recs == 1
    store.close()


def test_new_upload_starts_new_analysis(fake_app):
    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    rerun()
    first = fake.session_state.analysis_id
    rerun()
    assert fake.session_state.analysis_id == first

    fake.script["Use generated sample data"] = False
    rerun()
    fake.script["Use generated sample data"] = True
    rerun()
    second = fake.session_state.analysis_id
    assert second != first
    store = ResultsStore(db_path)
    assert len(store.list_events()) == 2
    store.close()


def test_autosave_off_touches_no_db(fake_app):
    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    fake.script["Auto-save stages to database"] = False
    rerun()
    assert fake.session_state.analysis_id is None
    store = ResultsStore(db_path)
    assert store.list_events() == []
    store.close()


def test_neural_variant_serves_and_autosaves(fake_app):
    fake, rerun, db_path = fake_app
    fake.script["Use generated sample data"] = True
    rerun()
    fake.script["Use generated sample data"] = False

    fake.script["Variant"] = "neural"
    fake.script["Run analysis"] = True
    rerun()
    fake.script["Run analysis"] = False

    s = ResultsStore(db_path)
    analyses = s.analyses_for_event(1)
    assert len(analyses) == 1 and analyses[0]["has_density"]
    aid = analyses[0]["id"]
    d = s.get_density_results(aid)
    assert d["total_people"] == 26  # the JAX CLI's count on the fixture
    assert s.get_flow_results(aid)["dominant_direction"] in {
        "E", "NE", "N", "NW", "W", "SW", "S", "SE"}


@pytest.mark.parametrize("variant", ["monolith", "neural"])
def test_app_needs_the_card_by_default(fake_app, variant):
    _no_card()
    fake, rerun, _ = fake_app
    fake.script["Use generated sample data"] = True
    fake.script["Variant"] = variant
    fake.script["Run analysis"] = True
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        rerun(device="cuda")
    assert fake.session_state.results is None


# -- the desktop shell (tests/test_desktop.py) ---------------------------------------

def test_desktop_shell_full_session(fake_tk, tmp_path):  # noqa: F811
    from lidar_ai_recommendation_software_tpu_torch import desktop

    pts = sample_venue(n_points=2000, n_people=25, seed=6)
    npy = tmp_path / "venue.npy"
    pio.save_points(str(npy), pts)
    proj = tmp_path / "session.lcaz"
    report = tmp_path / "report.html"

    fd = fake_tk.filedialog
    mb = fake_tk.messagebox
    statuses = []

    def script(root):
        menus = root.menubar.cascades
        filem, anm = menus["File"], menus["Analysis"]

        filem.commands["New Project"]()
        anm.commands["Run Analysis"]()
        assert len(mb.warnings) == 1

        fd.queue.append(str(npy))
        filem.commands["Import Data..."]()
        assert FakeCanvas.drawn == 1

        root.bindings["<F5>"](None)
        assert FakeCanvas.drawn == 2

        mb.okcancel_script.append(False)
        root.protocols["WM_DELETE_WINDOW"]()
        assert not root.destroyed

        fd.queue.append(str(proj))
        filem.commands["Save Project..."]()

        fd.queue.append(str(report))
        anm.commands["Generate Report..."]()

        fd.queue.append(str(proj))
        filem.commands["Open Project..."]()

        filem.commands["Quit"]()
        statuses.append(root.destroyed)

    FakeTk.script = staticmethod(script)
    desktop.main(device="cpu")

    root = FakeTk.last
    assert statuses == [True] and root.destroyed
    assert proj.exists()
    html = report.read_text()
    assert "<html" in html.lower() and "people" in html.lower()


def _import_and(fake_tk, tmp_path, command, seen, seed=6):  # noqa: F811
    pts = sample_venue(n_points=2048, n_people=25, seed=seed)
    npy = tmp_path / "v.npy"
    pio.save_points(str(npy), pts)

    def script(root):
        menus = root.menubar.cascades
        fake_tk.filedialog.queue.append(str(npy))
        menus["File"].commands["Import Data..."]()
        drawn_before = FakeCanvas.drawn
        menus["Analysis"].commands[command]()
        seen["status"] = FakeStringVar.instances[-1].get()
        seen["drew"] = FakeCanvas.drawn == drawn_before + 1
        root.destroy()

    FakeTk.script = staticmethod(script)


def test_desktop_status_reflects_analysis(fake_tk, tmp_path):  # noqa: F811
    from lidar_ai_recommendation_software_tpu_torch import desktop
    seen = {}
    _import_and(fake_tk, tmp_path, "Run Analysis", seen)
    desktop.main(device="cpu")
    assert "people=" in seen["status"] and "m/s" in seen["status"]


def test_desktop_neural_analysis(fake_tk, tmp_path):  # noqa: F811
    from lidar_ai_recommendation_software_tpu_torch import desktop
    seen = {}
    _import_and(fake_tk, tmp_path, "Run Neural Analysis", seen, seed=8)
    desktop.main(device="cpu")
    assert seen["status"].startswith("[neural] people=")
    assert seen["drew"]


@pytest.mark.parametrize("command", ["Run Analysis", "Run Neural Analysis"])
def test_desktop_needs_the_card_by_default(fake_tk, tmp_path,  # noqa: F811
                                          command):
    from lidar_ai_recommendation_software_tpu_torch import desktop
    _no_card()
    seen = {}
    _import_and(fake_tk, tmp_path, command, seen)
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        desktop.main()
    assert "status" not in seen
