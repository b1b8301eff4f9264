"""Command-line front-end of the PyTorch/CUDA port.

The counterpart of the JAX package's ``lidar-crowd`` and of the
reference's Streamlit wizard flow (app.py:1-394 Upload -> Visualize ->
Analyze -> Recommend -> Report) as a scriptable CLI, with the same
commands, options, output lines and JSON/store payloads. A Streamlit
front-end with the same tabs lives in ``app.py`` (gated on streamlit
being installed).

Every command that runs the analytics takes ``--device {cuda,cpu}``
(default ``cuda``): without a card, ``cuda`` fails with the pipeline's
message; the CPU runs only when asked for by name, or under
``--fallback-cpu`` when the card's pipeline fails. ``analyze`` times its
host stages (``cli load``, ``cli analyze``, ``cli json``, ``cli report``,
``cli store``) as ``utils.profiling.stage`` spans: each name's count,
total, last and first time in ``profiling.timings()``, and a
``lidar.<stage>`` range in any ``torch.profiler`` trace.

Commands:
  lidar-crowd-torch analyze <cloud> [--report out.html] [--json out.json]
                            [--variant monolith|modular] [--store db.sqlite]
                            [--device cuda|cpu]
  lidar-crowd-torch analyze-seq <frame> <frame> ... [--dt S]
  lidar-crowd-torch sample  [--points N] [--out venue.npy]
  lidar-crowd-torch bench   [--points N]
  lidar-crowd-torch train   [--steps N] [--out crowdnet.npz]
  lidar-crowd-torch info    <cloud>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage

DEVICES = ("cuda", "cpu")


def _device_option(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="where the analytics run (default: cuda; "
                             "fails without a card)")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lidar-crowd-torch",
        description="LiDAR crowd analytics on an NVIDIA GPU "
                    "(PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    a = sub.add_parser("analyze", help="run the full analytics pipeline")
    a.add_argument("cloud", help="point cloud file "
                   "(csv/xyz/txt/npy/pcd/ply/las) or 'sample'")
    a.add_argument("--variant", choices=["monolith", "modular"],
                   default="monolith")
    a.add_argument("--report", help="write HTML report to this path")
    a.add_argument("--pdf", dest="pdf_out",
                   help="write a multi-page PDF report to this path")
    a.add_argument("--json", dest="json_out",
                   help="write results JSON to this path")
    a.add_argument("--store", help="persist results: SQLite path or "
                   "postgres:// DSN (reference app_with_db.py lifecycle)")
    a.add_argument("--fallback-cpu", action="store_true",
                   help="degrade to the pipeline on the CPU if the device "
                        "fails (utils/resilience.FallbackPipeline)")
    a.add_argument("--event", default="", help="event name for the store")
    a.add_argument("--no-figures", action="store_true",
                   help="skip figure rendering in the report")
    a.add_argument("--downsample", type=float, default=None,
                   metavar="FACTOR",
                   help="random-downsample to this fraction before "
                        "analysis (reference downsample_point_cloud "
                        "semantics, data_processing.py:231-249)")
    a.add_argument("--voxel", type=float, default=None, metavar="SIZE",
                   help="voxel-grid downsample (one point per SIZE-m "
                        "voxel, on the device) before analysis")
    a.add_argument("--neural", nargs="?", const="default", default=None,
                   metavar="CKPT",
                   help="serve with CrowdNet (one forward pass) "
                        "instead of the analytic pipeline; optional "
                        "checkpoint path (default: packaged tiny ckpt)")
    _device_option(a)

    s = sub.add_parser("sample", help="generate the synthetic venue")
    s.add_argument("--points", type=int, default=10_000)
    s.add_argument("--out", default="venue.npy")

    b = sub.add_parser("bench", help="quick pipeline benchmark")
    b.add_argument("--points", type=int, default=100_000)
    _device_option(b)

    i = sub.add_parser("info", help="inspect a point cloud file")
    i.add_argument("cloud")

    t = sub.add_parser(
        "train", help="distil the analytic pipeline into CrowdNet")
    t.add_argument("--out", default="crowdnet.npz",
                   help="portable checkpoint artifact to write")
    t.add_argument("--steps", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--points", type=int, default=4096,
                   help="points per training venue (static capacity)")
    t.add_argument("--grid", type=int, default=32, help="BEV grid size")
    t.add_argument("--sa1", type=int, default=512,
                   help="SA1 FPS sample count")
    t.add_argument("--sa2", type=int, default=128,
                   help="SA2 FPS sample count")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--bf16", action="store_true",
                   help="bf16 operands in the SA MLPs and the trunk")
    t.add_argument("--pallas", action="store_true",
                   help="accepted for scripts of the JAX CLI and ignored: "
                        "the port always runs its CUDA kernels on a card")
    t.add_argument("--remat", action="store_true",
                   help="rematerialise SA layers (memory for FLOPs)")
    t.add_argument("--eval-venues", type=int, default=8,
                   help="held-out venues for the final metrics")
    t.add_argument("--orbax-dir", default=None,
                   help="also save a resumable train state in this "
                        "directory: a torch.save file (train_state.pt), "
                        "not Orbax")
    _device_option(t)

    q = sub.add_parser("analyze-seq",
                       help="temporal analysis of a frame sequence")
    q.add_argument("frames", nargs="+",
                   help="point cloud files in time order (>=2)")
    q.add_argument("--dt", type=float, default=1.0,
                   help="seconds between frames")
    q.add_argument("--report", help="write HTML report to this path")
    _device_option(q)
    return p


def _load(path: str) -> np.ndarray:
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        sample_venue)
    from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
    if path == "sample":
        return sample_venue()
    return pio.load_points(path)


def _device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def cmd_analyze(args) -> int:
    from lidar_ai_recommendation_software_tpu_torch.config import (
        MODULAR_CONFIG, MONOLITH_CONFIG)

    cfg = MONOLITH_CONFIG if args.variant == "monolith" else MODULAR_CONFIG
    # the pipeline first: without a card, device="cuda" fails here with
    # the pipeline's own message, before any work
    if args.neural is not None:
        from lidar_ai_recommendation_software_tpu_torch.neural import (
            NeuralPipeline)
        ckpt = None if args.neural == "default" else args.neural
        pipe = NeuralPipeline(ckpt, config=cfg, device=args.device)
    else:
        from lidar_ai_recommendation_software_tpu_torch.pipeline import (
            Pipeline)
        pipe = Pipeline(cfg, device=args.device)
        if args.fallback_cpu:
            from lidar_ai_recommendation_software_tpu_torch.utils.resilience \
                import FallbackPipeline
            pipe = FallbackPipeline(pipe)

    with stage("cli load"):
        points = _load(args.cloud)
    if args.downsample:
        from lidar_ai_recommendation_software_tpu_torch.compat import (
            downsample_point_cloud)
        points = downsample_point_cloud(points, args.downsample)
        print(f"downsampled to {len(points):,} points "
              f"(factor {args.downsample})")
    if args.voxel:
        from lidar_ai_recommendation_software_tpu_torch.ops.sampling import (
            voxel_downsample)
        p = torch.as_tensor(points, dtype=torch.float32, device=args.device)
        _, keep = voxel_downsample(
            p, torch.ones(len(points), dtype=torch.bool, device=p.device),
            args.voxel)
        points = points[keep.cpu().numpy()]
        print(f"voxel-downsampled to {len(points):,} points "
              f"({args.voxel} m voxels)")
    t0 = time.time()
    with stage("cli analyze"):
        out = pipe.analyze(points)
    dt = time.time() - t0
    if out.get("degraded"):
        print("WARNING: device unavailable — results computed by the "
              "CPU oracle fallback", file=sys.stderr)

    d, f, r = out["density"], out["flow"], out["recommendations"]
    print(f"Analyzed {len(points):,} points in {dt:.2f}s "
          f"({len(points) / dt:,.0f} pts/s incl. compile)")
    print(f"  people detected : {d['total_people']}")
    print(f"  avg / max density: {d['avg_density']:.2f} / "
          f"{d['max_density']:.2f} people/m²")
    print(f"  avg speed       : {f['avg_speed']:.2f} m/s "
          f"(dominant {f['dominant_direction']})")
    print(f"  hotspots        : {len(d['hotspots'])}")
    print(f"  bottlenecks     : {len(f['bottlenecks'])}")
    print(f"  issues/actions  : {len(r['issues'])}/{len(r['actions'])}")

    density_out = {k: v for k, v in d.items()
                   if k not in ("density_map", "density_grid", "grid_size")}
    flow_out = {k: v for k, v in f.items() if k != "flow_vectors"}
    if args.json_out:
        payload = {"density": density_out, "flow": flow_out,
                   "recommendations": r}
        with stage("cli json"), open(args.json_out, "w") as fh:
            json.dump(payload, fh, indent=2, default=_np_default)
        print(f"  results JSON    : {args.json_out}")

    summary = {"source": args.cloud, "points": len(points)}
    if args.report:
        from lidar_ai_recommendation_software_tpu_torch.utils.report import (
            generate_report)
        with stage("cli report"):
            html = generate_report(d, f, r, processed_summary=summary,
                                   include_figures=not args.no_figures)
            with open(args.report, "w") as fh:
                fh.write(html)
        print(f"  HTML report     : {args.report}")

    if args.pdf_out:
        from lidar_ai_recommendation_software_tpu_torch.utils.report import (
            generate_pdf_report)
        generate_pdf_report(args.pdf_out, d, f, r,
                            processed_summary=summary)
        print(f"  PDF report      : {args.pdf_out}")

    if args.store:
        # open_store routes postgres:// DSNs to PostgresStore; everything
        # else is a SQLite path
        from lidar_ai_recommendation_software_tpu_torch.utils.store import (
            open_store)
        with stage("cli store"):
            store = open_store(args.store)
            eid = store.create_event(args.event or args.cloud)
            aid = store.create_analysis(event_id=eid,
                                        point_summary={"n": len(points)})
            store.save_density_results(aid, density_out)
            store.save_flow_results(aid, flow_out)
            store.save_recommendations(aid, r)
            if args.report:
                with open(args.report) as fh:
                    store.save_report(aid, fh.read(), title=args.cloud)
            store.close()
        print(f"  stored analysis : id {aid} in {args.store}")
    return 0


def cmd_sample(args) -> int:
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        sample_venue, scaled_venue)
    from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
    pts = (sample_venue() if args.points == 10_000
           else scaled_venue(args.points))
    pio.save_points(args.out, pts)
    print(f"wrote {len(pts):,} points to {args.out}")
    return 0


def cmd_bench(args) -> int:
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        scaled_venue)
    from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

    pipe = Pipeline(device=args.device)
    pts = scaled_venue(args.points)
    scans = [pipe._upload(pts + i * 1e-4) for i in range(4)]
    cfg = pipe.fit_capacity(scans[0])
    clouds = [PointCloud.from_tensor(s, cfg.capacity.max_points)
              for s in scans]
    # the first call builds the CUDA kernels (nvcc) when none are built
    t0 = time.time()
    r = pipe.analyze_device(clouds[0], cfg)
    people = int(r[2].density.total_people)
    print(f"first call   : {time.time() - t0:.1f}s "
          f"(people={people}, device={_device_name(pipe.device)})")
    t0 = time.time()
    for c in clouds:
        r = pipe.analyze_device(c, cfg)
    _ = float(r[2].density.max_density)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    dt = (time.time() - t0) / len(clouds)
    print(f"steady-state : {dt * 1000:.1f} ms/cloud -> "
          f"{args.points / dt:,.0f} points/s")
    return 0


def cmd_train(args) -> int:
    from lidar_ai_recommendation_software_tpu_torch.models import train as T

    cfg = T.TrainConfig(
        batch_size=args.batch_size, n_points=args.points, grid=args.grid,
        sa1_samples=args.sa1, sa2_samples=args.sa2,
        learning_rate=args.lr, seed=args.seed, bf16=args.bf16,
        remat=args.remat, use_pallas=args.pallas)
    state = T.init_state(cfg, device=args.device)
    print(f"training CrowdNet on {_device_name(args.device)} "
          f"({args.steps} steps, batch {cfg.batch_size} x "
          f"{cfg.n_points} pts, grid {cfg.grid})")
    t0 = time.time()
    state, metrics = T.fit(cfg, args.steps, state)
    dt = time.time() - t0
    print(f"trained in {dt:.1f}s "
          f"({args.steps * cfg.batch_size / dt:.1f} venues/s); "
          f"final loss {metrics['loss']:.4f}")

    params = state.model.state_dict()
    ev = T.evaluate(params, cfg, n_venues=args.eval_venues,
                    device=args.device)
    print(f"held-out: density MAE {ev['density_mae']:.4f} "
          f"(zero-predictor {ev['density_mae_zero']:.4f}), "
          f"flow MSE {ev['flow_mse']:.4f}, "
          f"people count rel-err {ev['people_rel_err']:.1%}")

    T.save_params_npz(args.out, params, cfg)
    print(f"checkpoint      : {args.out}")
    if args.orbax_dir:
        os.makedirs(args.orbax_dir, exist_ok=True)
        path = os.path.join(args.orbax_dir, "train_state.pt")
        T.save_checkpoint(path, state, cfg)
        print(f"train state     : {path} (torch.save)")
    return 0


def cmd_analyze_seq(args) -> int:
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    pipe = Pipeline(device=args.device)
    frames = [_load(f) for f in args.frames]
    if len(frames) < 2:
        print("error: need at least two frames", file=sys.stderr)
        return 2
    out = pipe.analyze_sequence(frames, dt=args.dt)
    d, f = out["density"], out["flow"]
    print(f"Tracked {len(frames)} frames (dt={args.dt}s)")
    print(f"  people detected : {d['total_people']}")
    print(f"  measured speed  : {f['avg_speed']:.2f} m/s "
          f"(dominant {f['dominant_direction']})")
    print(f"  bottlenecks     : {len(f['bottlenecks'])}")
    if args.report:
        from lidar_ai_recommendation_software_tpu_torch.utils.report import (
            generate_report)
        html = generate_report(d, f, out["recommendations"],
                               processed_summary={
                                   "frames": len(frames),
                                   "dt_s": args.dt})
        with open(args.report, "w") as fh:
            fh.write(html)
        print(f"  HTML report     : {args.report}")
    return 0


def cmd_info(args) -> int:
    pts = _load(args.cloud)
    mins = pts.min(axis=0)
    maxs = pts.max(axis=0)
    print(f"{args.cloud}: {len(pts):,} points")
    print(f"  x: [{mins[0]:.2f}, {maxs[0]:.2f}]  "
          f"y: [{mins[1]:.2f}, {maxs[1]:.2f}]  "
          f"z: [{mins[2]:.2f}, {maxs[2]:.2f}]")
    return 0


def _np_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    raise TypeError(str(type(o)))


def main(argv=None) -> int:
    from lidar_ai_recommendation_software_tpu_torch.utils.io import (
        LoaderError)

    args = _build_parser().parse_args(argv)
    try:
        return {"analyze": cmd_analyze, "sample": cmd_sample,
                "bench": cmd_bench, "info": cmd_info,
                "train": cmd_train,
                "analyze-seq": cmd_analyze_seq}[args.command](args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e.filename}", file=sys.stderr)
        return 2
    except LoaderError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
