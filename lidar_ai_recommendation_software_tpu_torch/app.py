"""Streamlit front-end (optional).

The PyTorch/CUDA counterpart of the reference's Streamlit wizard family
(app.py, app_simplified.py, app_with_db.py): one app, five tabs
(Upload -> Visualize -> Analyze -> Recommendations -> Report) plus a
Database tab, with the DB-backed lifecycle of app_with_db.py when a
store is configured: an analysis row is auto-created on upload
(app_with_db.py:1058,1121), density/flow/recommendations/report are each
saved right after their stage completes (:1238,1279,1329,1426), reports
can be browsed back by id (:1441-1508), and the store is closed at exit
(:1511-1516). Gated on streamlit being installed; the analytics core is
the port's Pipeline the CLI uses, on the card (``main(device="cuda")``,
the default, raises without one). Figures render interactive plotly when
plotly is importable (the reference is plotly-only), matplotlib
otherwise.

Run:  streamlit run lidar_ai_recommendation_software_tpu_torch/app.py
"""

from __future__ import annotations

import atexit
import os

try:
    import streamlit as st
    HAVE_STREAMLIT = True
except ImportError:  # pragma: no cover - exercised only without streamlit
    HAVE_STREAMLIT = False


def main(device: str = "cuda"):  # driven by a scripted fake in the tests
    if not HAVE_STREAMLIT:
        raise SystemExit(
            "streamlit is not installed; use the CLI front-end instead: "
            "python -m lidar_ai_recommendation_software_tpu_torch.cli --help")

    from lidar_ai_recommendation_software_tpu_torch.config import (
        MODULAR_CONFIG, MONOLITH_CONFIG)
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.synthetic import sample_venue
    from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
    from lidar_ai_recommendation_software_tpu_torch.utils import viz
    from lidar_ai_recommendation_software_tpu_torch.utils.report import (
        generate_report)
    from lidar_ai_recommendation_software_tpu_torch.utils.store import (
        ResultsStore)

    def render(fig):
        """plotly figures render interactive, matplotlib static."""
        if viz.is_plotly_figure(fig):
            st.plotly_chart(fig, use_container_width=True)
        else:
            st.pyplot(fig)

    st.set_page_config(page_title="LiDAR Crowd Analytics (CUDA)",
                       layout="wide")
    st.title("LiDAR Crowd Analytics — PyTorch/CUDA engine")

    ss = st.session_state
    for key in ("points", "results", "analysis_id"):
        ss.setdefault(key, None)

    # DB lifecycle (app_with_db.py): one store per session, auto-saving
    # each stage; close registered once at exit (:1511-1516)
    db_path = st.sidebar.text_input("SQLite path",
                                    "crowd_analytics.sqlite")
    autosave = st.sidebar.checkbox("Auto-save stages to database",
                                   value=True)

    def store():
        if "store_obj" not in ss or ss.get("store_path") != db_path:
            ss.store_obj = ResultsStore(db_path)
            ss.store_path = db_path
            atexit.register(ss.store_obj.close)
        return ss.store_obj

    def ensure_analysis() -> int:
        """Auto-create event+analysis on first save of a session upload
        (app_with_db.py:1058-1121)."""
        if ss.analysis_id is None:
            s = store()
            eid = s.create_event("streamlit session")
            ss.analysis_id = s.create_analysis(
                event_id=eid,
                point_summary={"n": 0 if ss.points is None
                               else len(ss.points)})
        return ss.analysis_id

    tabs = st.tabs(["Upload", "Visualize", "Analyze",
                    "Recommendations", "Report", "Database"])

    with tabs[0]:
        st.header("Upload point cloud")
        use_sample = st.checkbox("Use generated sample data")
        up = st.file_uploader(
            "Point cloud file",
            type=["csv", "xyz", "txt", "npy", "pcd", "ply", "las"])
        token = None  # identifies the *upload action*, not the rerun
        if use_sample:
            ss.points = sample_venue()
            st.success(f"sample venue loaded: {len(ss.points):,} points")
            token = "sample"
        elif up is not None:
            fmt = up.name.rsplit(".", 1)[-1]
            ss.points = pio.load_points(up.read(), fmt=fmt)
            st.success(f"{up.name}: {len(ss.points):,} points")
            token = f"file:{up.name}:{len(ss.points)}"
        if token is None:
            ss.pop("upload_token", None)  # re-check/re-upload = new action
        elif autosave and ss.get("upload_token") != token:
            # one analysis row per upload action (app_with_db.py:1058),
            # not one per streamlit rerun
            ss.upload_token = token
            ss.analysis_id = None
            ss.recs_saved = False
            ensure_analysis()
            st.caption(f"analysis #{ss.analysis_id} created in {db_path}")

    with tabs[1]:
        st.header("Visualize")
        if ss.points is None:
            st.info("upload a point cloud first")
        else:
            color_by = st.selectbox(
                "Color by", ["Height", "Density", "Distance", "Cluster"])
            render(viz.point_cloud_figure(ss.points, color_by=color_by,
                                          preview=True))
            proj = st.selectbox("Density projection",
                                ["xy", "xz", "yz"])
            render(viz.density_heatmap_figure(
                points=ss.points,
                projection_dims=(proj[0], proj[1])))

    with tabs[2]:
        st.header("Analyze")
        variant = st.radio("Variant", ["monolith", "modular", "neural"],
                           horizontal=True,
                           help="neural serves CrowdNet (one forward "
                                "pass, packaged checkpoint) "
                                "instead of the analytic pipeline")
        if ss.points is not None and st.button("Run analysis"):
            if variant == "neural":
                from lidar_ai_recommendation_software_tpu_torch.neural import (
                    NeuralPipeline)
                with st.spinner("Running CrowdNet forward pass..."):
                    ss.results = NeuralPipeline(
                        device=device).analyze(ss.points)
            else:
                cfg = (MONOLITH_CONFIG if variant == "monolith"
                       else MODULAR_CONFIG)
                with st.spinner("Running the pipeline..."):
                    ss.results = Pipeline(cfg, device=device).analyze(
                        ss.points)
            st.success("done")
            if autosave:  # per-stage save (app_with_db.py:1238,1279)
                s = store()
                aid = ensure_analysis()
                d = ss.results["density"]
                f = ss.results["flow"]
                s.save_density_results(
                    aid, {k: v for k, v in d.items()
                          if k not in ("density_map", "density_grid",
                                       "grid_size")})
                s.save_flow_results(
                    aid, {k: v for k, v in f.items()
                          if k != "flow_vectors"})
                st.caption(f"density+flow saved to analysis #{aid}")
        if ss.results:
            d = ss.results["density"]
            f = ss.results["flow"]
            c1, c2, c3, c4 = st.columns(4)
            c1.metric("People", d["total_people"])
            c2.metric("Max density", f"{d['max_density']:.2f}")
            c3.metric("Avg speed", f"{f['avg_speed']:.2f} m/s")
            c4.metric("Direction", f["dominant_direction"])
            render(viz.density_heatmap_figure(d))
            render(viz.flow_figure(f))
            render(viz.congestion_figure(d, f))

    with tabs[3]:
        st.header("Recommendations")
        if not ss.results:
            st.info("run the analysis first")
        else:
            r = ss.results["recommendations"]
            if autosave and not ss.get("recs_saved"):
                store().save_recommendations(ensure_analysis(), r)
                ss.recs_saved = True  # saved once per analysis
            for issue in r["issues"]:
                st.error(f"**{issue['title']}** (severity "
                         f"{issue['severity']}/10, {issue['location']}) — "
                         f"{issue['description']}")
            for action in r["actions"]:
                with st.expander(f"{action['title']} "
                                 f"({action['priority']} priority)"):
                    st.write(action["description"])
                    for s in action["steps"]:
                        st.write(f"- {s}")
            for op in r["opportunities"]:
                st.success(f"**{op['title']}** ({op['impact']} impact) — "
                           f"{op['description']}")

    with tabs[4]:
        st.header("Report")
        if ss.results and st.button("Generate report"):
            html = generate_report(
                ss.results["density"], ss.results["flow"],
                ss.results["recommendations"],
                processed_summary={"points": len(ss.points)})
            if autosave:  # app_with_db.py:1426
                rid = store().save_report(ensure_analysis(), html,
                                          title="crowd report")
                st.caption(f"report #{rid} saved")
            st.components.v1.html(html, height=800, scrolling=True)
            st.download_button("Download HTML", html,
                               file_name="crowd_report.html")

    with tabs[5]:
        st.header("Database")
        s = store()
        st.subheader("Events")
        st.table(s.list_events())
        st.subheader("Analyses per event")
        eids = [e["id"] for e in s.list_events()]
        if eids:
            eid = st.selectbox("Event", eids)
            st.table(s.analyses_for_event(eid))
        st.subheader("Reports")
        reports = s.list_reports()
        st.table(reports)
        # report-by-id browsing (app_with_db.py:1441-1508)
        if reports:
            rid = st.selectbox("View report",
                               [r["id"] for r in reports])
            if st.button("Open report"):
                rec = s.get_report(rid)
                if rec:
                    st.components.v1.html(rec["html"], height=800,
                                          scrolling=True)


if __name__ == "__main__":
    main()
