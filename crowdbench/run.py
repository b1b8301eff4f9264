"""Run one cell of the benchmark once.

    python3 -m crowdbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with a CUDA card. What one call of a cell is
comes from its kind (``kinds/<kind>.py``, ``spec.py``): for the kind
``scan``, ``Pipeline.analyze`` of one scan, and a "scan" below is one
call of the cell's kind. Set-up makes the cell's pool of scans from
``--seed``, builds ``Pipeline(config, device="cuda")`` (the first run in a
checkout also builds the port's kernels into its ``_build/``) and warms
every scan of the pool twice. Then one closed-loop caller submits the
pool's scans for ``--seconds``: the next scan when the last result has
returned, the window closing when the first scan to end past
``--seconds`` has returned.

``--trace 0`` reports the cell's end-to-end metrics, of
``points_per_s`` (the points of every scan completed, over the window),
``scan_p95_ms`` (over every scan's latency, from the call to the returned
dicts, the device synchronised) and ``setup_s`` (from the import of the
package, the first thing a run does, to the window's start): those that
``BENCHMARK.json`` gives the cell. ``--trace 1`` splits the
window in three equal parts: the first half of the first runs as an
untraced run does, and its second half as the second part does, inside a
session of the port's own tracer, whose span records and counters the
readers find in ``TracedRun.records``; in the second part every span
(``trace.py``) synchronises the device at its ends, and the ``*_ms``
metrics read it; the third runs under ``torch.profiler`` with no added
synchronisation, the host recording the benchmark's ranges and no
operator, and the device's idle share, the roofline and ``breakdown`` read
its trace. Each part's mean scan time is printed, so the cost of the
spans, of the port's session and of the profiler shows beside the
untraced scans.

After the window, with the peak memory read and the program's state
freed, the plain reference (for the kind ``scan``, ``reference.py``)
answers each scan of the pool on the card in float64, and the kind's
comparison (``compare.py``) holds every scan of the window to it (the full
arrays on a sample drawn from the seed). Each number compared is printed
beside its limit as the last lines of standard error and under
``checks``, the last key of the result line, the last line of standard
output.

Exits non-zero, printing no result, without enough CUDA cards, when
``jax``, ``jaxlib``, ``flax`` or the JAX package is loaded once the window
has closed, or when the port cannot be imported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from crowdbench import START, compare, roofline, spec, traffic
from crowdbench.trace import Spans, Trace, device_profile, instrument

FORBIDDEN = ("jax", "jaxlib", "flax", "lidar_ai_recommendation_software_tpu")

# full arrays of this many scans of each pool scan, drawn from the seed,
# are kept for the comparison
HEAVY_PER_SCAN = 2


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    the whole name before the first dot compared."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def percentile(values, q: float) -> float:
    """The q-th percentile of ``values``, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def pipeline_config(settings: Dict):
    """The port's ``PipelineConfig``: ``MONOLITH_CONFIG`` with the
    configuration file's settings."""
    from lidar_ai_recommendation_software_tpu_torch.config import (
        MONOLITH_CONFIG)
    groups = {k: dataclasses.replace(getattr(MONOLITH_CONFIG, k),
                                     **settings[k])
              for k in ("preprocess", "density", "flow", "recommend")}
    return dataclasses.replace(MONOLITH_CONFIG, dtype=settings["dtype"],
                               **groups)


class Kept:
    """What the comparison needs of the scans of the window, as the kind
    keeps it: the light part of every scan (for ``scan``, the result
    dicts), and the heavy part (the centroids, density grid and flow
    field) of ``HEAVY_PER_SCAN`` scans of each pool scan, a reservoir
    sample drawn from the seed."""

    def __init__(self, seed: int, kind: ModuleType):
        self.kind = kind
        self.rng = np.random.RandomState(int(traffic.seed_state(seed, 2)[1]))
        self.light: List[tuple] = []
        self.heavy: Dict[int, List[tuple]] = defaultdict(list)
        self.seen: Dict[int, int] = defaultdict(int)
        self.scans = 0  # ids of the scans submitted

    def next_id(self) -> int:
        self.scans += 1
        return self.scans - 1

    def add(self, scan_id: int, i: int, out: Dict) -> None:
        light, heavy = self.kind.keep(out)
        self.light.append((scan_id, i, light))
        self.seen[i] += 1
        item = (scan_id, heavy)
        if len(self.heavy[i]) < HEAVY_PER_SCAN:
            self.heavy[i].append(item)
        else:
            j = self.rng.randint(self.seen[i])
            if j < HEAVY_PER_SCAN:
                self.heavy[i][j] = item


def closed_loop(pipe, pool, order, seconds: float, kept: Kept,
                spans: Optional[Spans], sync) -> Dict:
    """One caller submitting scans for ``seconds``, each one call of
    ``kept``'s kind: latencies, points and the window, errors kept by
    scan."""
    kind = kept.kind
    lat, errors = [], []
    points, attempted = 0, 0
    start = time.perf_counter()
    deadline = start + seconds
    while time.perf_counter() < deadline:
        i = next(order)
        scan_id = kept.next_id()
        attempted += 1
        t0 = time.perf_counter()
        try:
            with (spans.span("analyze") if spans else
                  contextlib.nullcontext()):
                out = kind.call(pipe, pool[i])
                sync()
        except Exception as exc:  # a failed scan counts, the loop goes on
            errors.append(f"scan {scan_id} (pool {i}): "
                          f"{type(exc).__name__}: {exc}")
            continue
        lat.append(time.perf_counter() - t0)
        points += kind.points(pool[i])
        kept.add(scan_id, i, out)
        del out
    return {"latencies": lat, "points": points, "attempted": attempted,
            "errors": errors, "window_s": time.perf_counter() - start}


def references(kind: ModuleType, pool, indices, settings: Dict, device,
               dtype=torch.float64) -> Dict[int, Dict]:
    """The reference's answer for each scan ``indices`` of the pool."""
    return {i: kind.reference(pool[i], settings, dtype, device)
            for i in sorted(indices)}


def judge(pool, kept: Kept, settings: Dict, limits: Dict, device,
          refs: Optional[Dict[int, Dict]] = None) -> Dict:
    """The reference's answer for each scan of the pool that the window
    analysed, and every kept result held to it by ``kept``'s kind."""
    kind = kept.kind
    if refs is None:
        refs = references(kind, pool, kept.seen, settings, device)
    rows, wrong = [], set()
    for scan_id, i, res in kept.light:
        nums = kind.light(res, refs[i])
        rows.append(nums)
        if not compare.judge(nums, limits):
            wrong.add(scan_id)
    for i, items in kept.heavy.items():
        for scan_id, res in items:
            nums = kind.heavy(res, refs[i], device)
            rows.append(nums)
            if not compare.judge(nums, limits):
                wrong.add(scan_id)
    names = list(kind.LIGHT) + list(kind.HEAVY)
    return {"worst": compare.worst(rows, names), "wrong": wrong,
            "clustered": {i: kind.clustered(r) for i, r in refs.items()},
            "judged": len(rows)}


def card_info() -> Dict:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        first = res.stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in first.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


@dataclasses.dataclass
class TracedRun:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    spans: Dict[str, List[float]]   # synchronised spans' seconds
    scans: int                      # scans of the synchronised part
    trace: Optional[Trace]          # the profiled part's trace
    profiled: List[int]             # pool index of each profiled scan
    clustered: Dict[int, int]       # pool index -> clustered points
    peaks: Optional[Dict[str, float]]
    # the port's span records and counters of the part that runs in its
    # tracing session, a ``profiling.Scan`` a top-level span (none from a
    # port without the session), and the scans of that part
    records: List = dataclasses.field(default_factory=list)
    recorded: int = 0
    # the untraced part: its scans' points and its window's seconds
    plain: Dict[str, float] = dataclasses.field(default_factory=dict)


def bench(cell: spec.Cell, seed: int, seconds: float, trace: bool,
          device: str = "cuda", t0: float = START) -> tuple:
    """One run of ``cell`` on ``device``: the result line's dict, the
    lines printed before it, and the checks' lines for standard error."""
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    settings = cell.config["pipeline"]
    kind = cell.kind
    pool = kind.make_pool(cell.config, cell.traffic, seed)
    pipe = Pipeline(pipeline_config(settings), device=device)
    for _ in range(2):  # every scan's shapes, twice
        for item in pool:
            kind.call(pipe, item)
    sync()
    order = traffic.submissions(len(pool), seed)
    kept = Kept(seed, kind)
    setup_s = time.perf_counter() - t0

    profiled: List[int] = []
    tr = None
    spans = Spans(sync=True)
    if not trace:
        win = closed_loop(pipe, pool, order, seconds, kept, None, sync)
        parts = [win]
    else:
        part = seconds / 3
        plain = closed_loop(pipe, pool, order, part / 2, kept, None, sync)
        # the port's session costs each host read and span some us: it
        # gets a part of its own, and the synchronised part stays clean
        synced = Spans(sync=True)
        with instrument(pipe, synced, kind.SPANS, record=True) as scans:
            recorded = closed_loop(pipe, pool, order, part / 2, kept,
                                   synced, sync)
        records = list(scans or ())
        with instrument(pipe, spans, kind.SPANS):
            timed = closed_loop(pipe, pool, order, part, kept, spans, sync)
        light_before = len(kept.light)
        quiet = Spans(sync=False)
        with tempfile.TemporaryDirectory() as tmp, \
                instrument(pipe, quiet, kind.SPANS):
            path = Path(tmp) / "trace.json"
            with device_profile(path, on_card):
                traced = closed_loop(pipe, pool, order, part, kept, quiet,
                                     sync)
            tr = Trace.from_file(path)
        profiled = [i for _, i, _ in kept.light[light_before:]]
        parts = [plain, recorded, timed, traced]

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    del pipe
    if on_card:
        torch.cuda.empty_cache()

    errors = [e for p in parts for e in p["errors"]]
    limits = cell.config["limits"]
    verdict = judge(pool, kept, settings, limits, device)
    attempted = sum(p["attempted"] for p in parts)
    failed = len(errors) + len(verdict["wrong"])
    worst = verdict["worst"]
    correct = (failed == 0 and attempted > 0 and all(
        worst[k] is not None and worst[k] <= limits[k] for k in worst))

    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict] = {}
    card = card_info() if on_card else {"name": "cpu", "power_limit": "none"}
    card_kind = torch.cuda.get_device_name() if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": card_kind,
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    info = [f"card: {card_kind}, power limit {card['power_limit']}",
            f"scans: {attempted} attempted, {failed} failed, "
            f"{verdict['judged']} judged; pool {len(pool)} x "
            f"{kind.points(pool[0]):,} points; seed {seed}"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if not trace:
        win = parts[0]
        values = {"points_per_s": win["points"] / win["window_s"],
                  "scan_p95_ms": (1e3 * percentile(win["latencies"], 95)
                                  if win["latencies"] else None),
                  "setup_s": setup_s}
        values = {k: v for k, v in values.items() if k in units}
        lat_ms = sorted(1e3 * x for x in win["latencies"])
        info.append(f"window: {win['window_s']:.3f} s, "
                    f"{len(lat_ms)} scans completed; latency ms min "
                    f"{lat_ms[0]:.3f}, median {percentile(lat_ms, 50):.3f}, "
                    f"mean {sum(lat_ms) / len(lat_ms):.3f}, max "
                    f"{lat_ms[-1]:.3f}" if lat_ms else "no scan completed")
    else:
        run = TracedRun(spans=dict(spans.seconds),
                        scans=len(timed["latencies"]), trace=tr,
                        profiled=profiled, clustered=verdict["clustered"],
                        peaks=roofline.peaks(card_kind), records=records,
                        recorded=len(recorded["latencies"]),
                        plain={"points": plain["points"],
                               "window_s": plain["window_s"]})
        values = {m["name"]: spec.metric_reader(m["name"], cell.root)(run)
                  for m in cell.per_layer}
        if tr is not None and on_card and tr.window_s() > 0:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s()
            result["breakdown"] = {"device_ops": tr.top_device_ops(),
                                   "idle_gaps": tr.idle_gaps()}
        if tr is not None:
            info.append(f"trace: {len(tr.device)} device operations, "
                        f"{len(tr.spans)} spans, window {tr.window_s():.6f} s")
        calls = len(run.spans.get("analyze_device", ())) / max(1, run.scans)
        means = [1e3 * sum(p["latencies"]) / len(p["latencies"])
                 if p["latencies"] else float("nan") for p in parts]
        info.append(f"mean scan ms: {means[0]:.3f} untraced, "
                    f"{means[1]:.3f} with synchronised spans and the "
                    f"port's session, {means[2]:.3f} with synchronised "
                    f"spans, {means[3]:.3f} profiled")
        info.append(f"traced: {run.recorded} scans recorded, "
                    f"{run.scans} scans synchronised "
                    f"({calls:.3f} analyze_device calls a scan), "
                    f"{len(profiled)} profiled; rooflines against "
                    f"published peaks at 700 W, this card's limit "
                    f"{card['power_limit']}")
    for name, value in values.items():
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    result["checks"] = {k: {"value": worst[k], "limit": limits[k]}
                        for k in worst}
    lines = [f"error: {e}" for e in errors[:20]]
    lines += [f"{k} {worst[k]!r} limit {limits[k]!r}" for k in worst]
    return result, info, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"crowdbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 2
    result, info, lines = bench(cell, args.seed, args.seconds,
                                bool(args.trace))
    found = forbidden_modules()
    if found:
        print("crowdbench: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in info:
        print("# " + line)
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
