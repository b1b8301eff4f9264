"""Visualization builders — interactive plotly when importable,
matplotlib always.

Host-side figure builders mirroring utils/visualization.py of the
reference (which is plotly-only and renders report PNGs through a
kaleido subprocess, report_generator.py:482-496):

  - point_cloud_figure      ~ visualize_point_cloud (visualization.py:10-97)
  - density_heatmap_figure  ~ create_density_heatmap (:99-191), including
    the projection-dims histogram branch and the KD-density scatter
    fallback
  - flow_figure             ~ create_flow_visualization (:193-278)
  - congestion_figure       ~ plot_crowd_metrics (:280-377)

Every builder takes ``engine``: "auto" (plotly if importable — the
reference's interactive rotate/hover/zoom UX — else matplotlib),
"plotly", or "matplotlib". Reports always force matplotlib
(utils/report.py) because PNG embedding must not depend on an external
kaleido binary. Downsampling rules match the reference: >50K points
renders 20% (5% in preview mode), visualization.py:29-33.
"""

from __future__ import annotations

import base64
import io
from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

_DIM_MAP = {"x": 0, "y": 1, "z": 2}


def plotly_go():
    """plotly.graph_objects when installed, else None (gated exactly like
    streamlit in app.py — optional front-end deps never break the core)."""
    try:
        import plotly.graph_objects as go
        return go
    except Exception:
        return None


def _engine_go(engine: str):
    """Resolve engine choice -> plotly module or None (matplotlib)."""
    if engine == "matplotlib":
        return None
    go = plotly_go()
    if engine == "plotly" and go is None:
        raise ImportError("plotly requested but not installed")
    return go


def is_plotly_figure(fig) -> bool:
    return type(fig).__module__.startswith("plotly")


def _downsample(points: np.ndarray, preview: bool,
                threshold: int = 50_000) -> np.ndarray:
    if len(points) <= threshold and not preview:
        return points
    frac = 0.05 if preview else (0.2 if len(points) > threshold else 1.0)
    if frac >= 1.0:
        return points
    n_keep = max(1, int(len(points) * frac))
    idx = np.random.default_rng(0).choice(len(points), n_keep,
                                          replace=False)
    return points[idx]


def _local_density(points_2d: np.ndarray, r: float = 0.5) -> np.ndarray:
    """KD-tree r-radius neighbor counts (visualization.py:43-45,165-168)."""
    from scipy.spatial import cKDTree
    t = cKDTree(points_2d)
    return np.asarray(t.query_ball_point(points_2d, r,
                                         return_length=True))


def point_cloud_figure(points: np.ndarray,
                       clusters: Optional[np.ndarray] = None,
                       color_by: str = "Height", point_size: float = 2.0,
                       preview: bool = False, show_grid: bool = True,
                       engine: str = "auto"):
    """3D scatter with the reference's color modes
    (visualization.py:38-70): Height / Density / Distance / Cluster.
    Plotly engine returns the reference's interactive rotatable
    Scatter3d; matplotlib a static 3D projection."""
    pts = np.asarray(points)
    keep_idx = None
    if clusters is not None:
        clusters = np.asarray(clusters)
    if len(pts) > 50_000 or preview:
        frac = 0.05 if preview else 0.2
        n_keep = max(1, int(len(pts) * frac))
        keep_idx = np.random.default_rng(0).choice(len(pts), n_keep,
                                                   replace=False)
        pts = pts[keep_idx]
        if clusters is not None:
            clusters = clusters[keep_idx]

    # colors per mode (shared across engines)
    if color_by == "Cluster" and clusters is not None:
        colors = np.where(clusters < 0, -1, clusters)
        scale_p, cmap_m, label = "Rainbow", "tab20", "Cluster ID"
    elif color_by == "Density":
        colors = _local_density(pts, r=0.5)
        scale_p, cmap_m, label = "Reds", "viridis", "Local Point Density"
    elif color_by == "Distance":
        colors = np.linalg.norm(pts - pts.mean(axis=0), axis=1)
        scale_p, cmap_m, label = "Blues", "plasma", \
            "Distance from Center (m)"
    else:  # Height
        colors = pts[:, 2]
        scale_p, cmap_m, label = "Viridis", "viridis", "Height (m)"

    go = _engine_go(engine)
    if go is not None:
        fig = go.Figure(data=[go.Scatter3d(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
            marker=dict(size=point_size + 1, color=colors,
                        colorscale=scale_p, opacity=0.8,
                        colorbar=dict(title=label)))])
        fig.update_layout(
            scene=dict(xaxis_title="X (m)", yaxis_title="Y (m)",
                       zaxis_title="Z (m)", aspectmode="data",
                       xaxis=dict(showgrid=show_grid),
                       yaxis=dict(showgrid=show_grid),
                       zaxis=dict(showgrid=show_grid)),
            margin=dict(l=0, r=0, b=0, t=0), height=600)
        return fig

    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=colors,
                    cmap=cmap_m, s=point_size)
    fig.colorbar(sc, ax=ax, shrink=0.6, label=label)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_zlabel("Z (m)")
    ax.set_title("Point cloud")
    return fig


def density_heatmap_figure(density_results: Optional[Dict] = None,
                           points: Optional[np.ndarray] = None,
                           projection_dims: Sequence[str] = ("x", "y"),
                           resolution: int = 100, as_heatmap: bool = True,
                           engine: str = "auto"):
    """Density heatmap. Three reference branches
    (visualization.py:99-191):

      - ``density_results`` with an analysis grid -> render that grid;
      - raw ``points`` + ``projection_dims`` (xy/xz/yz) -> histogram2d at
        ``resolution`` over the chosen projection;
      - raw ``points`` with ``as_heatmap=False`` -> scatter colored by
        KD-tree local density (the reference's fallback).
    """
    go = _engine_go(engine)
    d0, d1 = (_DIM_MAP[projection_dims[0]], _DIM_MAP[projection_dims[1]])

    if density_results is not None:
        grid = np.asarray(density_results.get(
            "density_map", density_results.get("density_grid")))
        if grid.ndim != 2:
            raise ValueError("density_results lacks a 2D grid")
        # orient x horizontally: stored maps are either (nx, ny) or
        # (ny, nx); both render — transpose the monolith's y-major grid
        if "density_map" not in density_results:
            grid = grid.T
        origin = density_results.get("origin")
        g = 1.0
        if origin is not None:
            xs = origin[0] + (np.arange(grid.shape[0]) + 0.5) * g
            ys = origin[1] + (np.arange(grid.shape[1]) + 0.5) * g
        else:
            xs = np.arange(grid.shape[0]) + 0.5
            ys = np.arange(grid.shape[1]) + 0.5

        if go is not None:
            fig = go.Figure(data=go.Heatmap(
                z=grid.T, x=xs, y=ys, colorscale="Hot",
                colorbar=dict(title="people/m²")))
            for h in density_results.get("hotspots", []):
                fig.add_trace(go.Scatter(
                    x=[h["x"]], y=[h["y"]], mode="markers",
                    marker=dict(symbol="star", size=16, color="cyan",
                                line=dict(color="black", width=1)),
                    hovertext=f'density {h.get("density", 0):.2f}',
                    showlegend=False))
            fig.update_layout(title="Crowd density",
                              xaxis_title="X (m)", yaxis_title="Y (m)",
                              height=600,
                              margin=dict(l=0, r=0, b=0, t=40))
            return fig

        fig, ax = plt.subplots(figsize=(8, 6))
        extent = None
        if origin is not None:
            extent = (origin[0], origin[0] + grid.shape[0] * g,
                      origin[1], origin[1] + grid.shape[1] * g)
        im = ax.imshow(grid.T, origin="lower", cmap="hot", extent=extent,
                       aspect="auto")
        fig.colorbar(im, ax=ax, label="people/m²")
        for h in density_results.get("hotspots", []):
            ax.plot(h["x"], h["y"], "c*", markersize=14,
                    markeredgecolor="k")
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_title("Crowd density")
        return fig

    if points is None:
        raise ValueError("need density_results or points")
    pts = np.asarray(points)
    a, b = pts[:, d0], pts[:, d1]
    title = (f"Density Projection "
             f"({projection_dims[0]}-{projection_dims[1]})")

    if as_heatmap:
        hist, xe, ye = np.histogram2d(a, b, bins=resolution)
        xc = (xe[:-1] + xe[1:]) / 2
        yc = (ye[:-1] + ye[1:]) / 2
        if go is not None:
            fig = go.Figure(data=go.Heatmap(
                z=hist.T, x=xc, y=yc, colorscale="Viridis",
                colorbar=dict(title="Density")))
            fig.update_layout(title=title,
                              xaxis_title=f"{projection_dims[0]} (m)",
                              yaxis_title=f"{projection_dims[1]} (m)",
                              height=600,
                              margin=dict(l=0, r=0, b=0, t=40))
            return fig
        fig, ax = plt.subplots(figsize=(8, 6))
        im = ax.imshow(hist.T, origin="lower", cmap="viridis",
                       extent=(xe[0], xe[-1], ye[0], ye[-1]),
                       aspect="auto")
        fig.colorbar(im, ax=ax, label="Density")
        ax.set_xlabel(f"{projection_dims[0]} (m)")
        ax.set_ylabel(f"{projection_dims[1]} (m)")
        ax.set_title(title)
        return fig

    # scatter fallback: KD-tree local density coloring
    dens = _local_density(np.stack([a, b], axis=1), r=0.5)
    if go is not None:
        fig = go.Figure(data=go.Scatter(
            x=a, y=b, mode="markers",
            marker=dict(size=5, color=dens, colorscale="Viridis",
                        colorbar=dict(title="Local Density"))))
        fig.update_layout(title=title,
                          xaxis_title=f"{projection_dims[0]} (m)",
                          yaxis_title=f"{projection_dims[1]} (m)",
                          height=600, margin=dict(l=0, r=0, b=0, t=40))
        return fig
    fig, ax = plt.subplots(figsize=(8, 6))
    sc = ax.scatter(a, b, c=dens, cmap="viridis", s=5)
    fig.colorbar(sc, ax=ax, label="Local Density")
    ax.set_xlabel(f"{projection_dims[0]} (m)")
    ax.set_ylabel(f"{projection_dims[1]} (m)")
    ax.set_title(title)
    return fig


def flow_figure(flow_results: Dict, max_arrows: int = 100,
                engine: str = "auto"):
    """Speed heatmap + flow arrows (visualization.py:193-278: magnitude
    interpolation + <=100 arrow traces, skipping vectors under 0.1)."""
    fv = flow_results["flow_vectors"]
    pos = np.asarray(fv["positions"])
    vec = np.asarray(fv["vectors"])
    mag = np.asarray(fv["magnitudes"])
    go = _engine_go(engine)

    idx = np.array([], int)
    if len(pos):
        keep = mag >= 0.1
        idx = np.where(keep)[0]
        if len(idx) > max_arrows:
            idx = idx[np.linspace(0, len(idx) - 1,
                                  max_arrows).astype(int)]

    if go is not None:
        fig = go.Figure()
        if len(pos):
            # griddata magnitude field on a 100x100 lattice
            # (visualization.py:219-224)
            from scipy.interpolate import griddata
            xg = np.linspace(pos[:, 0].min(), pos[:, 0].max(), 100)
            yg = np.linspace(pos[:, 1].min(), pos[:, 1].max(), 100)
            gx, gy = np.meshgrid(xg, yg)
            try:
                zg = griddata(pos, mag, (gx, gy), method="linear")
            except Exception:
                zg = None
            if zg is not None:
                fig.add_trace(go.Heatmap(
                    z=zg, x=xg, y=yg, colorscale="Viridis",
                    colorbar=dict(title="speed (m/s)")))
            for i in idx:
                x0, y0 = pos[i]
                dx, dy = vec[i]
                fig.add_trace(go.Scatter(
                    x=[x0, x0 + dx], y=[y0, y0 + dy], mode="lines",
                    line=dict(color="red", width=1.5),
                    hoverinfo="skip", showlegend=False))
        for b in flow_results.get("bottlenecks", []):
            fig.add_trace(go.Scatter(
                x=[b["x"]], y=[b["y"]], mode="markers+text",
                marker=dict(symbol="square", size=14, color="white",
                            line=dict(color="black", width=1)),
                text=[str(b["severity"])], textposition="middle center",
                showlegend=False))
        fig.update_layout(title="Crowd flow", xaxis_title="X (m)",
                          yaxis_title="Y (m)", height=600,
                          margin=dict(l=0, r=0, b=0, t=40))
        return fig

    fig, ax = plt.subplots(figsize=(8, 6))
    if len(pos):
        sc = ax.tricontourf(pos[:, 0], pos[:, 1], mag, levels=14,
                            cmap="viridis")
        fig.colorbar(sc, ax=ax, label="speed (m/s)")
        ax.quiver(pos[idx, 0], pos[idx, 1], vec[idx, 0], vec[idx, 1],
                  color="red", width=0.003)
    for b in flow_results.get("bottlenecks", []):
        ax.plot(b["x"], b["y"], "ws", markersize=10, markeredgecolor="k")
        ax.annotate(f'{b["severity"]}', (b["x"], b["y"]),
                    ha="center", va="center", fontsize=8)
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_title("Crowd flow")
    return fig


def congestion_figure(density_results: Dict, flow_results: Dict,
                      engine: str = "auto"):
    """Congestion risk = density / (speed + 0.1), normalised 0-10
    (visualization.py:322-326): bubble chart over the venue, with the
    reference's griddata contour overlay on the plotly engine
    (visualization.py:340-362). A flow node reads the density cell
    ``(position - origin) / grid_size``, both from ``density_results``
    (a cell edge of 1 m where it names none)."""
    fv = flow_results["flow_vectors"]
    pos = np.asarray(fv["positions"])
    mag = np.asarray(fv["magnitudes"])
    grid = np.asarray(density_results.get("density_map",
                      density_results.get("density_grid")))
    if "density_map" not in density_results:
        grid = grid.T
    origin = density_results.get("origin", (pos[:, 0].min() if len(pos)
                                            else 0.0,
                                            pos[:, 1].min() if len(pos)
                                            else 0.0))
    grid_size = density_results.get("grid_size", 1.0)
    risk10 = np.array([])
    if len(pos):
        ix = np.clip(((pos[:, 0] - origin[0]) / grid_size).astype(int), 0,
                     grid.shape[0] - 1)
        iy = np.clip(((pos[:, 1] - origin[1]) / grid_size).astype(int), 0,
                     grid.shape[1] - 1)
        dens = grid[ix, iy]
        risk = dens / (mag + 0.1)
        rmax = risk.max() if risk.max() > 0 else 1.0
        risk10 = 10.0 * risk / rmax

    go = _engine_go(engine)
    if go is not None:
        fig = go.Figure()
        if len(pos):
            # contour overlay (visualization.py:340-362)
            from scipy.interpolate import griddata
            xg = np.linspace(pos[:, 0].min(), pos[:, 0].max(), 100)
            yg = np.linspace(pos[:, 1].min(), pos[:, 1].max(), 100)
            gx, gy = np.meshgrid(xg, yg)
            try:
                zg = griddata(pos, risk10, (gx, gy), method="linear")
            except Exception:
                zg = None
            if zg is not None:
                fig.add_trace(go.Contour(
                    z=zg, x=xg, y=yg, colorscale="RdYlGn",
                    reversescale=True, opacity=0.4, showscale=False,
                    contours=dict(showlines=False)))
            fig.add_trace(go.Scatter(
                x=pos[:, 0], y=pos[:, 1], mode="markers",
                marker=dict(size=4 + risk10 * 2.0, color=risk10,
                            colorscale="RdYlGn", reversescale=True,
                            opacity=0.75,
                            colorbar=dict(title="congestion risk (0-10)")),
                hovertext=[f"risk {r:.1f}" for r in risk10],
                showlegend=False))
        fig.update_layout(title="Congestion risk", xaxis_title="X (m)",
                          yaxis_title="Y (m)", height=600,
                          margin=dict(l=0, r=0, b=0, t=40))
        return fig

    fig, ax = plt.subplots(figsize=(8, 6))
    if len(pos):
        sc = ax.scatter(pos[:, 0], pos[:, 1], s=8 + risk10 * 12,
                        c=risk10, cmap="RdYlGn_r", alpha=0.75)
        fig.colorbar(sc, ax=ax, label="congestion risk (0-10)")
    ax.set_xlabel("X (m)")
    ax.set_ylabel("Y (m)")
    ax.set_title("Congestion risk")
    return fig


def fig_to_base64(fig) -> str:
    """PNG-in-base64 for report embedding (report_generator.py:482-496 —
    no kaleido subprocess needed for the matplotlib engine; plotly
    figures fall back to kaleido only when available)."""
    if is_plotly_figure(fig):
        # reports are built with engine="matplotlib" exactly to avoid
        # this path, but accept a plotly figure if one arrives
        return base64.b64encode(fig.to_image(format="png")).decode(
            "ascii")
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")
