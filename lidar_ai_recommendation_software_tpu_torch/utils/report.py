"""HTML report generation.

Self-contained styled HTML mirroring utils/report_generator.py:12-496 of
the reference: executive-summary metric boxes, hotspot/bottleneck tables
with risk bands, embedded base64 PNG figures, recommendations sections and
footer timestamps. Figures render via matplotlib (no kaleido subprocess);
``viz`` (and so matplotlib) is imported only where a figure is drawn, so a
report without figures needs no matplotlib.
"""

from __future__ import annotations

import datetime
import html as _html
from typing import Dict, Optional

import numpy as np

from lidar_ai_recommendation_software_tpu_torch.config import DensityConfig

# the engine the report's footer names
ENGINE = "the LiDAR crowd-analytics engine (PyTorch/CUDA)"

_CSS = """
body { font-family: 'Segoe UI', Arial, sans-serif; margin: 0;
       background: #f5f7fa; color: #232629; }
.container { max-width: 1000px; margin: 0 auto; padding: 24px; }
header { background: #1f3b57; color: #fff; padding: 28px 24px; }
header h1 { margin: 0 0 4px 0; font-size: 26px; }
header p { margin: 0; opacity: .8; }
h2 { color: #1f3b57; border-bottom: 2px solid #dde3ea;
     padding-bottom: 6px; margin-top: 36px; }
.metrics { display: flex; gap: 16px; flex-wrap: wrap; margin: 18px 0; }
.metric { flex: 1 1 180px; background: #fff; border-radius: 8px;
          padding: 16px; box-shadow: 0 1px 3px rgba(0,0,0,.08);
          text-align: center; }
.metric .value { font-size: 30px; font-weight: 600; color: #1f3b57; }
.metric .label { font-size: 13px; color: #667; margin-top: 4px; }
table { border-collapse: collapse; width: 100%; background: #fff;
        box-shadow: 0 1px 3px rgba(0,0,0,.08); }
th, td { padding: 9px 12px; text-align: left;
         border-bottom: 1px solid #e4e8ee; font-size: 14px; }
th { background: #eef2f7; }
.risk-Low { color: #2e7d32; font-weight: 600; }
.risk-Moderate { color: #f9a825; font-weight: 600; }
.risk-High { color: #ef6c00; font-weight: 600; }
.risk-Critical { color: #c62828; font-weight: 600; }
.issue, .action, .opportunity { background: #fff; border-radius: 8px;
    padding: 14px 16px; margin: 10px 0;
    box-shadow: 0 1px 3px rgba(0,0,0,.08); }
.issue { border-left: 4px solid #c62828; }
.action { border-left: 4px solid #1565c0; }
.opportunity { border-left: 4px solid #2e7d32; }
.figure { text-align: center; margin: 18px 0; }
.figure img { max-width: 100%; border-radius: 8px;
              box-shadow: 0 1px 4px rgba(0,0,0,.12); }
footer { text-align: center; color: #8a93a0; font-size: 12px;
         padding: 24px; }
"""


def risk_level(density: float,
               cfg: DensityConfig = DensityConfig()) -> str:
    """LOS band (crowd_density_model.py:100-117)."""
    if density < cfg.risk_moderate:
        return "Low"
    if density < cfg.risk_high:
        return "Moderate"
    if density < cfg.risk_critical:
        return "High"
    return "Critical"


def _esc(x) -> str:
    return _html.escape(str(x))


def generate_report(density_results: Dict, flow_results: Dict,
                    recommendations: Dict,
                    processed_summary: Optional[Dict] = None,
                    title: str = "Crowd Analysis Report",
                    include_figures: bool = True) -> str:
    """Build the full self-contained HTML report string."""
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    d = density_results
    f = flow_results
    r = recommendations

    parts = [f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
             f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
             f"<body><header><div class='container'>"
             f"<h1>{_esc(title)}</h1><p>Generated {now}</p>"
             f"</div></header><div class='container'>"]

    # Executive summary metric boxes (report_generator.py:37-80)
    avg = float(d.get("avg_density", 0.0))
    parts.append("<h2>Executive Summary</h2><div class='metrics'>")
    for value, label in [
            (d.get("total_people", 0), "People detected"),
            (f"{avg:.2f}", "Avg density (p/m²)"),
            (f"{float(d.get('max_density', 0.0)):.2f}",
             "Peak density (p/m²)"),
            (f"{float(f.get('avg_speed', 0.0)):.2f}",
             "Avg speed (m/s)"),
            (_esc(f.get("dominant_direction", "N/A")),
             "Dominant direction"),
            (len(r.get("issues", [])), "Issues found")]:
        parts.append(f"<div class='metric'><div class='value'>{value}"
                     f"</div><div class='label'>{label}</div></div>")
    parts.append("</div>")

    venue_band = risk_level(avg)
    parts.append(
        f"<p>Overall venue risk level: "
        f"<span class='risk-{venue_band}'>{venue_band}</span></p>")

    if processed_summary:
        parts.append("<h2>Dataset</h2><table><tbody>")
        for k, v in processed_summary.items():
            parts.append(f"<tr><th>{_esc(k)}</th><td>{_esc(v)}</td></tr>")
        parts.append("</tbody></table>")

    # Density section with hotspot table (report_generator.py:184-276)
    parts.append("<h2>Crowd Density</h2>")
    if include_figures:
        from lidar_ai_recommendation_software_tpu_torch.utils import viz
        try:
            b64 = viz.fig_to_base64(viz.density_heatmap_figure(d, engine="matplotlib"))
            parts.append(f"<div class='figure'>"
                         f"<img src='data:image/png;base64,{b64}'/></div>")
        except Exception:
            parts.append("<p><em>density figure unavailable</em></p>")
    hotspots = d.get("hotspots", [])
    if hotspots:
        parts.append("<table><thead><tr><th>#</th><th>Location</th>"
                     "<th>Density (p/m²)</th><th>Risk</th></tr></thead>"
                     "<tbody>")
        for i, h in enumerate(hotspots, 1):
            band = risk_level(float(h["density"]))
            parts.append(
                f"<tr><td>{i}</td>"
                f"<td>({h['x']:.1f}, {h['y']:.1f})</td>"
                f"<td>{h['density']:.2f}</td>"
                f"<td class='risk-{band}'>{band}</td></tr>")
        parts.append("</tbody></table>")
    else:
        parts.append("<p>No density hotspots identified.</p>")

    # Flow section with bottleneck table (report_generator.py:278-360)
    parts.append("<h2>Crowd Flow</h2>")
    if include_figures:
        try:
            b64 = viz.fig_to_base64(viz.flow_figure(f, engine="matplotlib"))
            parts.append(f"<div class='figure'>"
                         f"<img src='data:image/png;base64,{b64}'/></div>")
        except Exception:
            parts.append("<p><em>flow figure unavailable</em></p>")
    bottlenecks = f.get("bottlenecks", [])
    if bottlenecks:
        parts.append("<table><thead><tr><th>#</th><th>Location</th>"
                     "<th>Severity (1-10)</th></tr></thead><tbody>")
        for i, b in enumerate(bottlenecks, 1):
            parts.append(f"<tr><td>{i}</td>"
                         f"<td>({b['x']:.1f}, {b['y']:.1f})</td>"
                         f"<td>{b['severity']}</td></tr>")
        parts.append("</tbody></table>")
    else:
        parts.append("<p>No significant bottlenecks identified.</p>")

    # Combined congestion figure (report_generator.py:362-382)
    if include_figures:
        try:
            b64 = viz.fig_to_base64(viz.congestion_figure(d, f, engine="matplotlib"))
            parts.append("<h2>Congestion Risk</h2><div class='figure'>"
                         f"<img src='data:image/png;base64,{b64}'/></div>")
        except Exception:
            pass

    # Recommendations (report_generator.py:384-470)
    parts.append("<h2>Issues</h2>")
    for issue in r.get("issues", []):
        parts.append(
            f"<div class='issue'><strong>{_esc(issue['title'])}</strong> "
            f"(severity {issue['severity']}/10, {_esc(issue['location'])})"
            f"<p>{_esc(issue['description'])}</p></div>")
    if not r.get("issues"):
        parts.append("<p>No issues identified.</p>")

    parts.append("<h2>Recommended Actions</h2>")
    for action in r.get("actions", []):
        steps = "".join(f"<li>{_esc(s)}</li>"
                        for s in action.get("steps", []))
        parts.append(
            f"<div class='action'><strong>{_esc(action['title'])}"
            f"</strong> — {_esc(action['priority'])} priority"
            f"<p>{_esc(action['description'])}</p><ol>{steps}</ol></div>")

    parts.append("<h2>Opportunities</h2>")
    for op in r.get("opportunities", []):
        parts.append(
            f"<div class='opportunity'><strong>{_esc(op['title'])}"
            f"</strong> — {_esc(op['impact'])} impact"
            f"<p>{_esc(op['description'])}</p></div>")

    parts.append(f"</div><footer>Generated by {ENGINE} — {now}</footer>"
                 f"</body></html>")
    return "".join(parts)


def generate_pdf_report(path: str, density_results: Dict,
                        flow_results: Dict, recommendations: Dict,
                        processed_summary: Optional[Dict] = None,
                        title: str = "Crowd Analysis Report") -> None:
    """Write a REAL multi-page PDF report (matplotlib PdfPages backend).

    The reference's "PDF export" writes a plain text file with a .pdf
    extension (windows_implementation/core/project_manager.py:379-435 —
    "we'll just simulate PDF creation"); this produces an actual PDF:
    page 1 = executive summary + hotspot/bottleneck tables +
    recommendations, then the density heatmap, flow field and congestion
    figures, one per page.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    from lidar_ai_recommendation_software_tpu_torch.utils import viz

    d, f, r = density_results, flow_results, recommendations
    now = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")

    lines = [title, "=" * min(len(title), 60), "",
             f"Generated: {now}"]
    for k, v in (processed_summary or {}).items():
        lines.append(f"{k}: {v}")
    lines += ["",
              f"Total people:       {d['total_people']}",
              f"Average density:    {d['avg_density']:.2f} people/m^2",
              f"Maximum density:    {d['max_density']:.2f} people/m^2 "
              f"({risk_level(d['max_density'])} risk)",
              f"Average speed:      {f['avg_speed']:.2f} m/s",
              f"Dominant direction: {f['dominant_direction']}", "",
              "Hotspots:"]
    for h in d.get("hotspots", []) or [None]:
        lines.append("  (none)" if h is None else
                     f"  ({h['x']:.1f}, {h['y']:.1f})  "
                     f"{h['density']:.2f} people/m^2  "
                     f"[{risk_level(h['density'])}]")
    lines.append("")
    lines.append("Bottlenecks:")
    for b in f.get("bottlenecks", []) or [None]:
        lines.append("  (none)" if b is None else
                     f"  ({b['x']:.1f}, {b['y']:.1f})  severity "
                     f"{b['severity']}/10")
    lines.append("")
    for section, items, fmt in (
            ("Issues", r.get("issues", []),
             lambda i: f"  [{i['severity']}/10] {i['title']} — "
                       f"{i['location']}"),
            ("Actions", r.get("actions", []),
             lambda a: f"  [{a['priority']}] {a['title']}"),
            ("Opportunities", r.get("opportunities", []),
             lambda o: f"  [{o['impact']}] {o['title']}")):
        lines.append(section + ":")
        lines.extend(fmt(x) for x in items) if items else \
            lines.append("  (none)")
        lines.append("")

    with PdfPages(path) as pdf:
        fig = plt.figure(figsize=(8.27, 11.69))  # A4 portrait
        fig.text(0.06, 0.97, "\n".join(lines), va="top", family="monospace",
                 fontsize=8)
        pdf.savefig(fig)
        plt.close(fig)
        for builder in (
                lambda: viz.density_heatmap_figure(d, engine="matplotlib"),
                lambda: viz.flow_figure(f, engine="matplotlib"),
                lambda: viz.congestion_figure(d, f, engine="matplotlib")):
            try:
                fig = builder()
            except Exception:
                continue  # a figure family missing its inputs is skipped
            pdf.savefig(fig)
            plt.close(fig)
