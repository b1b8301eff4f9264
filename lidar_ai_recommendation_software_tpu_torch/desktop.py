"""Desktop shell (Tkinter).

The working counterpart of the reference's PyQt5 MainWindow
(windows_implementation/main.py:38-437 — which cannot start as shipped:
it imports a gui/ package that does not exist in the repo,
main.py:18-22). Tkinter ships with CPython, so this shell runs anywhere.

Features mirroring the reference shell: project lifecycle (New / Open /
Save), dataset import via all supported formats, Run Analysis (F5) on the
port's real pipeline on the card (``main(device="cuda")``, the default,
raises without one), report generation + save, embedded matplotlib views,
statusbar point count, and an unsaved-changes close guard
(main.py:391-415).

UI glue is deliberately thin over ProjectManager — everything testable
lives there.
"""

from __future__ import annotations

import os
import sys


def main(device: str = "cuda"):
    # Executed headlessly by the tests against a scripted
    # fake tkinter (same pattern as the Streamlit lifecycle fake); on a
    # real display the same body drives the real toolkit.
    import tkinter as tk
    from tkinter import filedialog, messagebox, ttk

    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

    from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
    from lidar_ai_recommendation_software_tpu_torch.utils import viz
    from lidar_ai_recommendation_software_tpu_torch.utils.project import (
        PROJECT_EXTENSION, ProjectManager)

    pm = ProjectManager()

    root = tk.Tk()
    root.title("LiDAR Crowd Analytics (CUDA)")
    root.geometry("1100x750")

    status = tk.StringVar(value="no project")
    canvas_holder = {"canvas": None}

    def set_status(msg):
        status.set(msg)

    def show_figure(fig):
        if canvas_holder["canvas"] is not None:
            canvas_holder["canvas"].get_tk_widget().destroy()
        canvas = FigureCanvasTkAgg(fig, master=plot_frame)
        canvas.draw()
        canvas.get_tk_widget().pack(fill="both", expand=True)
        canvas_holder["canvas"] = canvas

    def new_project():
        pm.new_project("untitled")
        set_status("new project")

    def open_project():
        path = filedialog.askopenfilename(
            filetypes=[("Crowd project", f"*{PROJECT_EXTENSION}")])
        if path:
            proj = pm.open_project(path)
            n = sum(len(d.points) for d in pm.datasets)
            set_status(f"{proj.name}: {len(pm.datasets)} datasets, "
                       f"{n:,} points")

    def save_project():
        path = filedialog.asksaveasfilename(
            defaultextension=PROJECT_EXTENSION)
        if path:
            pm.save_project(path)
            set_status(f"saved {os.path.basename(path)}")

    def import_data():
        path = filedialog.askopenfilename(filetypes=[
            ("Point clouds", "*.csv *.xyz *.txt *.npy *.pcd *.ply *.las"),
            ("All files", "*.*")])
        if not path:
            return
        if pm.current_project is None:
            pm.new_project("untitled")
        pts = pio.load_points(path)
        pm.add_dataset(os.path.basename(path), pts)
        set_status(f"imported {len(pts):,} points from "
                   f"{os.path.basename(path)}")
        show_figure(viz.point_cloud_figure(pts, preview=True, engine="matplotlib"))

    def run_analysis(_event=None):
        if not pm.datasets:
            messagebox.showwarning("No data", "import a dataset first")
            return
        set_status("running analysis...")
        root.update_idletasks()
        out = pm.run_analysis(device=device)
        d = out["density"]
        set_status(
            f"people={d['total_people']} max={d['max_density']:.2f} "
            f"p/m² speed={out['flow']['avg_speed']:.2f} m/s")
        show_figure(viz.density_heatmap_figure(d, engine="matplotlib"))

    def run_neural_analysis():
        if not pm.datasets:
            messagebox.showwarning("No data", "import a dataset first")
            return
        from lidar_ai_recommendation_software_tpu_torch.neural import (
            NeuralPipeline)
        set_status("running CrowdNet forward pass...")
        root.update_idletasks()
        out = NeuralPipeline(device=device).analyze(pm.datasets[0].points)
        d = out["density"]
        set_status(
            f"[neural] people={d['total_people']} "
            f"max={d['max_density']:.2f} p/m² "
            f"speed={out['flow']['avg_speed']:.2f} m/s")
        show_figure(viz.density_heatmap_figure(d, engine="matplotlib"))

    def generate_report():
        if not pm.datasets:
            messagebox.showwarning("No data", "import a dataset first")
            return
        html = pm.generate_report(device=device)
        path = filedialog.asksaveasfilename(defaultextension=".html")
        if path:
            with open(path, "w") as f:
                f.write(html)
            set_status(f"report saved to {os.path.basename(path)}")

    def on_close():
        if pm.unsaved_changes and not messagebox.askokcancel(
                "Unsaved changes",
                "The project has unsaved changes. Quit anyway?"):
            return
        root.destroy()

    menubar = tk.Menu(root)
    filemenu = tk.Menu(menubar, tearoff=0)
    filemenu.add_command(label="New Project", command=new_project)
    filemenu.add_command(label="Open Project...", command=open_project)
    filemenu.add_command(label="Save Project...", command=save_project)
    filemenu.add_separator()
    filemenu.add_command(label="Import Data...", command=import_data)
    filemenu.add_separator()
    filemenu.add_command(label="Quit", command=on_close)
    menubar.add_cascade(label="File", menu=filemenu)
    analysismenu = tk.Menu(menubar, tearoff=0)
    analysismenu.add_command(label="Run Analysis", accelerator="F5",
                             command=run_analysis)
    analysismenu.add_command(label="Run Neural Analysis",
                             command=run_neural_analysis)
    analysismenu.add_command(label="Generate Report...",
                             command=generate_report)
    menubar.add_cascade(label="Analysis", menu=analysismenu)
    root.config(menu=menubar)
    root.bind("<F5>", run_analysis)

    plot_frame = ttk.Frame(root)
    plot_frame.pack(fill="both", expand=True)
    ttk.Label(root, textvariable=status, relief="sunken",
              anchor="w").pack(fill="x", side="bottom")
    root.protocol("WM_DELETE_WINDOW", on_close)
    root.mainloop()


if __name__ == "__main__":
    sys.exit(main())
