#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It

  1. prints the card's name and power limit;
  2. builds the port's CUDA kernels from ``csrc/`` (one nvcc per source,
     all started together);
  3. holds every kernel against its plain PyTorch version on the card
     (integers bit-equal) and times both with CUDA events: ``radius_count``
     at the pipeline's shapes and edge cases, the five column-table kernels
     of the venue-scale clustering at the 1M-point scan's shapes and on
     edge cases (an empty table, a full column and one past its cap,
     neighbours at exactly eps, a chain across the whole grid, a scattered
     mask);
  4. runs ``Pipeline(device="cuda").analyze`` on the seed-42 fixture
     (golden values, the kernel launched, a second run bit-identical, the
     modular variant equal to the CPU);
  5. runs a 40,960-point sensor frame and a 262,144-point venue on the
     card and holds each against the port's own CPU run (integers equal,
     floats within the tests' tolerances) and against the JAX package's
     values on the CPU, recorded below;
  6. runs a 1,000,000-point venue on the card (the column-grid clustering
     and the bucketed density): the JAX package's recorded values, every
     column kernel launched, a second run bit-identical;
  7. prints the warm wall time of ``analyze`` at every size.

Each pipeline run resets the launch counts just before it and reads them
just after. The line before the last is a JSON record of the kernels; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that line is printed. Without a CUDA device, or outside the
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

RADIUS = 2.0
PORT = "lidar_ai_recommendation_software_tpu_torch"
JAX_PKG = "lidar_ai_recommendation_software_tpu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "radius_count": (f"{PORT}/csrc/radius_count.cu",
                     f"{JAX_PKG}/ops/pallas/kernels.py:76"),
    "table_fill": (f"{PORT}/csrc/column_table.cu",
                   f"{JAX_PKG}/ops/pallas/fill.py:177"),
    "table_gather": (f"{PORT}/csrc/column_table.cu",
                     f"{JAX_PKG}/ops/pallas/fill.py:280"),
    "column_counts": (f"{PORT}/csrc/column_neighbours.cu",
                      f"{JAX_PKG}/ops/ccl.py:325"),
    "border_min": (f"{PORT}/csrc/column_neighbours.cu",
                   f"{JAX_PKG}/ops/ccl.py:365"),
    "propagate": (f"{PORT}/csrc/column_neighbours.cu",
                  f"{JAX_PKG}/ops/ccl.py:545"),
}
COLUMN_KERNELS = tuple(KERNELS)[1:]
# H100 SXM published peaks: HBM bandwidth, FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# seed-42 fixture, monolith (the CPU oracle's values)
GOLDEN = {"people": 446, "max_density": 3.5, "avg_density": 0.4958,
          "avg_speed": 1.2617, "direction": "E",
          "first_hotspot": (5.5, -10.5, 3.5), "n_hotspots": 5,
          "severities": [8, 8, 8, 7, 7]}
# scaled_venue(n) through the JAX package's Pipeline on the CPU
JAX_REFERENCE_40960 = {"people": 1786, "max_density": 3.75,
                       "direction": "E", "severities": [9, 9, 9]}
JAX_REFERENCE_262144 = {"people": 11644, "n_clusters": 11644,
                        "max_density": 4.0,
                        "avg_density": 0.49354320764541626,
                        "direction": "E", "severities": [9, 9, 8]}
JAX_REFERENCE_1M = {"people": 44449, "n_clusters": 44449,
                    "max_density": 4.25,
                    "avg_density": 0.49387937784194946,
                    "direction": "E", "severities": [8, 8, 7, 7]}
# flow vectors, speeds and centroids: sin/cos and sums differ in the last
# ulps between the CPU and CUDA
FLOAT_TOL = 1e-5


def max_sweeps() -> int:
    """The pipeline's bound on propagation sweeps: the configs'
    ``max_cc_iters`` in units of the JAX package's 8-pass iterations."""
    from lidar_ai_recommendation_software_tpu_torch import MONOLITH_CONFIG
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    return MONOLITH_CONFIG.capacity.max_cc_iters * ccl.SWEEPS_PER_CC_ITER


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_identity() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call on the device, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn, reps: int = 5) -> float:
    """Median wall milliseconds of a synchronised call, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, what bounds it): bytes over the HBM rate against
    operations over the FP32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got, want) -> int:
    import torch
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


# ---------------------------------------------------------------------------
# radius_count
# ---------------------------------------------------------------------------

def radius_cases(dev):
    """(name, centers, people, pmask) at the shapes the pipeline gives the
    kernel, plus the edge cases."""
    import numpy as np
    import torch

    def grid_centres(gx, gy, origin):
        i, j = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
        c = np.stack([origin[0] + (i.ravel() + 0.5),
                      origin[1] + (j.ravel() + 0.5)], 1)
        return c.astype(np.float32)

    def case(name, centres, people, mask):
        return (name, torch.from_numpy(centres).to(dev),
                torch.from_numpy(np.ascontiguousarray(people, np.float32))
                .to(dev), torch.from_numpy(mask).to(dev))

    rng = np.random.RandomState(0)
    out = []
    for gx, k, live, span in ((64, 1280, 446, 30.0),
                              (96, 5120, 1786, 60.7),
                              (160, 32768, 11644, 160.0)):
        centres = grid_centres(gx, gx, (-span / 2, -span / 2))
        people = rng.uniform(-span / 2, span / 2, (k, 2))
        out.append(case(f"{gx * gx}x{k} live prefix {live}", centres,
                        people, np.arange(k) < live))
    centres = grid_centres(96, 96, (-30.0, -30.0))
    people = rng.uniform(-30, 30, (5120, 2))
    out.append(case("9216x5120 scattered mask", centres, people,
                    rng.rand(5120) < 0.3))
    out.append(case("9216x5120 no people", centres, people,
                    np.zeros(5120, bool)))
    centre = np.float32([4.5, 4.5])
    boundary = np.stack([centre + [RADIUS, 0.0], centre + [0.0, -RADIUS],
                         centre + [RADIUS + 1e-3, 0.0], centre,
                         centre + [-RADIUS, 0.0]]).astype(np.float32)
    out.append(case("256x5 exact radius", grid_centres(16, 16, (0.0, 0.0)),
                    boundary, np.ones(5, bool)))
    return out


def run_radius_checks(dev) -> dict:
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    max_err = 0
    cases = radius_cases(dev)
    for name, c, p, m in cases:
        got = kernels.radius_count(c, p, m, RADIUS)
        want = kernels.radius_count_reference(c, p, m, RADIUS)
        torch.cuda.synchronize()
        err = int_err(got, want)
        print(f"radius_count {name}: max_abs_err {err}, total count "
              f"{int(want.sum())}")
        require(torch.equal(got, want), f"radius_count differs: {name}")
        if name == "256x5 exact radius":
            require(int(got[4 * 16 + 4]) == 4,
                    "people exactly at the radius must count")
        max_err = max(max_err, err)

    name, c, p, m = cases[1]  # the 40,960-point frame's shape
    ms = cuda_ms(lambda: kernels.radius_count(c, p, m, RADIUS))
    plain = cuda_ms(lambda: kernels.radius_count_reference(c, p, m, RADIUS))
    print(f"radius_count {name}: kernel {ms:.6f} ms, plain {plain:.6f} ms")
    ncent, k, live = c.shape[0], p.shape[0], int(m.sum())
    # centres and people read once, counts written once; the loop stops at
    # the live prefix: ~6 operations per live pair test
    b_ms, b_by = bound(ncent * 8 + k * 9 + ncent * 4, ncent * live * 6)
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}


# ---------------------------------------------------------------------------
# the column-table kernels
# ---------------------------------------------------------------------------

def column_cases():
    """(name, points (N, 3) float32, mask (N,), eps, min_samples, ncx,
    ncy, column cap) as numpy: the 1M-point scan's clustering input at
    the capacities fit_capacity gives it, then the edge cases."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    def padded(pts, n, mask=None):
        buf = np.zeros((n, 3), np.float32)
        buf[:len(pts)] = pts
        m = np.zeros(n, bool)
        m[:len(pts)] = True if mask is None else mask
        return buf, m

    out = []
    venue = scaled_venue(1_000_000)
    cap = Pipeline(device="cpu").fit_capacity(venue).capacity
    # the clustering mask of the scan: non-ground, above the 30th z
    # percentile (preprocess's ground split)
    ng = venue[:, 2] > np.percentile(venue[:, 2], 30.0)
    buf, m = padded(venue, cap.cluster_capacity, ng)
    out.append(("1M scan", buf, m, 0.3, 5, cap.cluster_cells_x,
                cap.cluster_cells_y, cap.cluster_column_cap))

    rng = np.random.RandomState(1)
    buf, _ = padded(rng.uniform(-5, 5, (4096, 3)), 4096)
    out.append(("empty table", buf, np.zeros(4096, bool), 0.3, 5, 32, 32, 8))

    # one point near every column centre of a 16 x 16 grid of columns a
    # little over 0.3 m wide (the corners span 4.8 m); column (3, 3)
    # filled to its cap of 8, column (10, 10) one past it
    i, j = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    base = np.stack([(i.ravel() + 0.5) * 0.3, (j.ravel() + 0.5) * 0.3,
                     np.zeros(256)], 1)
    corners = np.array([[0.0, 0.0, 0.0], [4.8, 4.8, 0.0]])
    extra = [np.array([[(c + 0.5) * 0.3, (c + 0.5) * 0.3, 0.0]])
             + rng.uniform(-0.04, 0.04, (k, 3)) for c, k in ((3, 7), (10, 8))]
    buf, m = padded(np.concatenate([corners, base] + extra), 512)
    out.append(("full column and one past", buf, m, 0.3, 3, 16, 16, 8))

    # pairs at exactly float32(eps) along y and z, and just beyond
    e = np.float32(0.35)
    beyond = np.nextafter(e, np.float32(1.0))
    pts = []
    for k in range(64):
        x = np.float32(k)
        pts += [[x, 0, 0], [x, e, 0], [x, 3, 0], [x, 3, e],
                [x, 6, 0], [x, 6, beyond]]
    buf, m = padded(np.array(pts, np.float32), 512)
    out.append(("neighbours at exactly eps", buf, m, 0.35, 2, 64, 32, 8))

    # one chain of points 0.285 m apart across all 1,024 columns, its
    # smallest point index at the far end of the stream order
    n_chain = 1078
    xs = (n_chain - 1 - np.arange(n_chain)) * 0.285
    buf, m = padded(np.stack([xs, np.zeros(n_chain), np.zeros(n_chain)], 1),
                    2048)
    out.append(("chain across the grid", buf, m, 0.3, 2, 1024, 8, 8))

    # blobs and background, every other point masked at random
    centres = rng.uniform(0, 30, (300, 2))
    blob = centres[rng.randint(0, 300, 30000)] + rng.normal(0, 0.15,
                                                            (30000, 2))
    pts = np.concatenate([np.column_stack([blob, rng.uniform(0, 1.8, 30000)]),
                          rng.uniform(0, 30, (20000, 3))])
    buf, m = padded(pts, 65536, rng.rand(len(pts)) < 0.5)
    out.append(("scattered mask", buf, m, 0.3, 5, 100, 100, 32))
    return out


def check_column_case(dev, name, pts, mask, eps, min_samples, ncx, ncy,
                      cap, timed: bool) -> dict:
    """Every column kernel against its plain version on one case; with
    ``timed``, their CUDA-event times and bounds too."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)

    p = torch.from_numpy(pts).to(dev)
    m = torch.from_numpy(mask).to(dev)
    py, ncells = ncy + 2, (ncx + 2) * (ncy + 2)
    order, scid, cell_start = ccl.sorted_stream(p, m, eps, ncx, ncy)
    bound_sweeps = max_sweeps()
    errs = {}

    def same(kernel, got, want):
        torch.cuda.synchronize()
        err = int_err(got, want)
        errs[kernel] = max(errs.get(kernel, 0), err)
        require(got.shape == want.shape and torch.equal(got, want),
                f"{kernel} differs from its plain version: {name} "
                f"(max abs err {err})")

    fill_args = (p, order, scid, cell_start, ncells, cap)
    tab, pst, ss, ov = C.table_fill(*fill_args)
    for got, want in zip((tab.view(torch.int32), pst, ss, ov),
                         C.table_fill_reference(*fill_args)):
        same("table_fill", got, want.view(torch.int32)
             if want.dtype == torch.float32 else want)
    placed = ss >= 0
    n_occ = int(placed.sum())

    nb_args = (tab, ss, py, cap, eps)
    counts = C.column_counts(*nb_args)
    same("column_counts", counts, C.column_counts_reference(*nb_args))
    core = placed & (counts >= min_samples)
    labels0 = torch.where(core, order, C.INT_MAX)
    lab = labels0.clone()
    sweeps = C.propagate(tab, ss, pst, py, cap, eps, lab, bound_sweeps)
    lab_ref = labels0.clone()
    C.propagate_reference(tab, ss, pst, py, cap, eps, lab_ref, bound_sweeps)
    same("propagate", lab, lab_ref)
    require(sweeps < bound_sweeps, f"{name}: propagation took {sweeps} "
            f"sweeps, the bound is {bound_sweeps}")
    bmin = C.border_min(*nb_args, lab)
    same("border_min", bmin, C.border_min_reference(*nb_args, lab))
    final = torch.where(core, lab, bmin)
    got = C.table_gather(final, pst, C.INT_MAX)
    same("table_gather", got, C.table_gather_reference(final, pst,
                                                       C.INT_MAX))
    n_clusters = int(torch.unique(got[got != C.INT_MAX]).numel())
    print(f"columns {name}: {int(mask.sum())} valid points, {n_occ} placed, "
          f"overflow {int(ov)}, {int(core.sum())} core, {n_clusters} "
          f"clusters, {sweeps} propagation sweeps; max_abs_err "
          f"{max(errs.values())}")

    if name == "full column and one past":
        require(int(ov) == 1, "one point past a full column is overflow")
    if name == "neighbours at exactly eps":
        # points 0, 1 are eps apart (y), 2, 3 too (z); 4, 5 just beyond
        c = C.table_gather(counts, pst, -1)[:6].tolist()
        require(c == [2, 2, 2, 2, 1, 1], f"counts at eps: {c}")
    if name == "chain across the grid":
        require(n_clusters == 1, f"the chain is one cluster, got "
                f"{n_clusters}")
    if name == "empty table":
        require(n_occ == 0 and n_clusters == 0, "the empty table")
    if not timed:
        return {"errs": errs}

    # the work of this run's table, for the bounds
    def grid(stream_positions):
        slots = ss[stream_positions].to(torch.int64)
        return torch.bincount(slots // cap, minlength=ncells).reshape(
            ncx + 2, py)

    def window(g):  # 3x3 sums; the border columns are empty
        pad = torch.nn.functional.pad(g, (1, 1, 1, 1))
        return sum(pad[1 + dx:1 + dx + ncx + 2, 1 + dy:1 + dy + py]
                   for dx in (-1, 0, 1) for dy in (-1, 0, 1))

    occ, core_occ = grid(placed), grid(core)
    win = window(occ)

    def slots_read(threads):
        """Slots a scan must read once: in every column next to a column
        with threads, its occupied slots and, unless full, the empty slot
        that ends them."""
        visited = window(threads) > 0
        return int((visited * (occ + 1).clamp_max(cap)).sum())

    pairs = int((occ * win).sum())
    core_pairs = int((core_occ * win).sum())
    scan, core_scan = slots_read(occ), slots_read(core_occ)
    n_changed = int((lab != labels0).sum())
    n, s = pts.shape[0], tab.shape[0]
    work = {  # (bytes: each input read once and each output written once,
        #          as far as this run's data needs them; operations: 9 per
        #          pair test)
        # table written whole; order, scid read, the placed points' xyz,
        # cell_start; stream_slot and point_stream written
        "table_fill": (16 * s + 8 * n + 12 * n_occ + 4 * (ncells + 1)
                       + 8 * n, 0),
        # point_stream read, the placed points' values, out written
        "table_gather": (4 * n + 4 * n_occ + 4 * n, 0),
        # stream_slot, the scanned slots, out
        "column_counts": (4 * n + 16 * scan + 4 * n, 9 * pairs),
        # and the placed points' labels
        "border_min": (4 * n + 16 * scan + 4 * n_occ + 4 * n, 9 * pairs),
        # per sweep stream_slot, the placed points' labels and the slots
        # the core points scan; each label that changes written once
        "propagate": (sweeps * (4 * n + 4 * n_occ + 16 * core_scan)
                      + 4 * n_changed, sweeps * 9 * core_pairs),
    }
    print(f"columns {name}: {pairs} pair tests per neighbourhood pass, "
          f"{core_pairs} from core points; {scan} slots scanned, "
          f"{core_scan} by core points; {n_changed} labels changed")
    calls = {
        "table_fill": (lambda: C.table_fill(*fill_args),
                       lambda: C.table_fill_reference(*fill_args)),
        "table_gather": (lambda: C.table_gather(final, pst, C.INT_MAX),
                         lambda: C.table_gather_reference(final, pst,
                                                          C.INT_MAX)),
        "column_counts": (lambda: C.column_counts(*nb_args),
                          lambda: C.column_counts_reference(*nb_args)),
        "border_min": (lambda: C.border_min(*nb_args, lab),
                       lambda: C.border_min_reference(*nb_args, lab)),
        "propagate": (
            lambda: C.propagate(tab, ss, pst, py, cap, eps, labels0.clone(),
                                bound_sweeps),
            lambda: C.propagate_reference(tab, ss, pst, py, cap, eps,
                                          labels0.clone(), bound_sweeps)),
    }
    times = {}
    for kernel, (fast, plain) in calls.items():
        ms, plain_ms = cuda_ms(fast), cuda_ms(plain, iters=5)
        b_ms, b_by = bound(*work[kernel])
        times[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by}
        print(f"{kernel} at the {name}: kernel {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"errs": errs, "times": times}


def run_column_checks(dev) -> dict:
    """Every case; the times of the 1M-point scan's."""
    errs = {k: 0 for k in COLUMN_KERNELS}
    times = None
    for name, *args in column_cases():
        res = check_column_case(dev, name, *args, timed=name == "1M scan")
        for k, e in res["errs"].items():
            errs[k] = max(errs[k], e)
        times = res.get("times", times)
    return {"errs": errs, "times": times}


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def host_arrays(out):
    """Every output of analyze() as numpy, for bit comparison."""
    import numpy as np
    pro, ppl = out["processed"], out["people"]
    d, f = out["density"], out["flow"]
    return {
        "labels": pro.labels.cpu().numpy(),
        "n_clusters": int(pro.n_clusters),
        "people_positions": ppl.positions.cpu().numpy(),
        "people_mask": ppl.mask.cpu().numpy(),
        "density_grid": d["density_grid"],
        "hotspots": np.array([[h["x"], h["y"], h["density"]]
                              for h in d["hotspots"]]).reshape(-1, 3),
        "bottlenecks": np.array([[b["x"], b["y"], b["severity"]]
                                 for b in f["bottlenecks"]]).reshape(-1, 3),
        "flow_vectors": f["flow_vectors"]["vectors"],
        "magnitudes": f["flow_vectors"]["magnitudes"],
        "avg_speed": f["avg_speed"],
        "avg_density": d["avg_density"],
    }


def check_golden(out) -> None:
    d, f = out["density"], out["flow"]
    hs = d["hotspots"]
    sev = [b["severity"] for b in f["bottlenecks"]]
    print(f"golden: people {d['total_people']}, max_density "
          f"{d['max_density']}, avg_density {d['avg_density']:.6f}, "
          f"avg_speed {f['avg_speed']:.6f}, direction "
          f"{f['dominant_direction']}, hotspots {len(hs)} first "
          f"({hs[0]['x']}, {hs[0]['y']}, {hs[0]['density']}), "
          f"severities {sev}")
    require(d["total_people"] == GOLDEN["people"], "people")
    require(abs(d["max_density"] - GOLDEN["max_density"]) < 1e-6,
            "max_density")
    require(abs(d["avg_density"] - GOLDEN["avg_density"]) < 1e-4,
            "avg_density")
    require(abs(f["avg_speed"] - GOLDEN["avg_speed"]) < 1e-4, "avg_speed")
    require(f["dominant_direction"] == GOLDEN["direction"], "direction")
    require(len(hs) == GOLDEN["n_hotspots"], "number of hotspots")
    hx, hy, hd = GOLDEN["first_hotspot"]
    # the golden position is given to 0.1 m (cell centres sit at the
    # inlier bbox minimum + 0.5 m)
    require(abs(hs[0]["x"] - hx) < 1e-2 and abs(hs[0]["y"] - hy) < 1e-2
            and abs(hs[0]["density"] - hd) < 1e-6, "first hotspot")
    require(sev == GOLDEN["severities"], "bottleneck severities")


def check_same(a: dict, b: dict, exact_floats: bool, what: str) -> None:
    import numpy as np
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        require(x.shape == y.shape, f"{what}: {key} shape {x.shape} vs "
                f"{y.shape}")
        if exact_floats or x.dtype.kind in "biu" or key in (
                "density_grid", "hotspots"):
            require(np.array_equal(x, y), f"{what}: {key} differs")
        elif key == "bottlenecks":
            require(np.array_equal(x[:, 2], y[:, 2]), f"{what}: severities")
            require(np.abs(x - y).max(initial=0.0) <= 1e-4,
                    f"{what}: bottleneck positions")
        else:
            err = float(np.abs(x - y).max(initial=0.0))
            require(err <= FLOAT_TOL, f"{what}: {key} off by {err}")


def check_jax_reference(out, ref: dict, what: str) -> None:
    d, f = out["density"], out["flow"]
    got = {"people": d["total_people"],
           "n_clusters": int(out["processed"].n_clusters),
           "max_density": d["max_density"], "avg_density": d["avg_density"],
           "direction": f["dominant_direction"],
           "severities": [b["severity"] for b in f["bottlenecks"]]}
    print(f"{what}: {got}")
    print(f"JAX package on the CPU (recorded): {ref}")
    for key, want in ref.items():
        if key == "avg_density":
            require(abs(got[key] - want) <= 1e-6, f"{what}: {key}")
        else:
            require(got[key] == want, f"{what}: {key} {got[key]} vs {want}")


def traced_run(pipe, points, what: str) -> tuple:
    """One analyze with the launch counts set to 0 just before it and read
    just after."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    kernels.reset_launch_counts()
    out = pipe.analyze(points)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches in the {what} run: {launches}")
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lidar_ai_recommendation_software_tpu_torch import (
        MODULAR_CONFIG, sample_venue, scaled_venue)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    dev = torch.device("cuda", 0)
    phase("device")
    ident = gpu_identity()
    print(ident)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    phase("build")
    t0 = time.perf_counter()
    kernels.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.3f} s "
          f"({kernels.library_path().name})")
    log = kernels.library_path().with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    phase("radius_count kernel against its plain version")
    radius = run_radius_checks(dev)

    phase("column-table kernels against their plain versions")
    t0 = time.perf_counter()
    cols = run_column_checks(dev)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("seed-42 fixture on the card")
    fixture = sample_venue()
    pipe = Pipeline(device="cuda")
    golden, launches = traced_run(pipe, fixture, "fixture")
    require(launches["radius_count"] > 0,
            "the fixture run did not launch radius_count")
    check_golden(golden)
    again = pipe.analyze(fixture)
    check_same(host_arrays(golden), host_arrays(again), True,
               "second fixture run")
    print("second run bit-identical: yes")
    mod_gpu = Pipeline(MODULAR_CONFIG, device="cuda").analyze(fixture)
    mod_cpu = Pipeline(MODULAR_CONFIG, device="cpu").analyze(fixture)
    check_same(host_arrays(mod_gpu), host_arrays(mod_cpu), False,
               "modular fixture, card vs CPU")
    print(f"modular fixture: people {mod_gpu['density']['total_people']}, "
          f"card equals CPU")

    venues = {}
    for n, ref, kernels_used in (
            (40_960, JAX_REFERENCE_40960, ("radius_count",)),
            (262_144, JAX_REFERENCE_262144, KERNELS)):
        phase(f"{n:,}-point venue, card vs the port on the CPU")
        t0 = time.perf_counter()
        venues[n] = scaled_venue(n)
        out, launches = traced_run(pipe, venues[n], f"{n:,}-point")
        for k in kernels_used:
            require(launches[k] > 0, f"the {n:,}-point run did not launch "
                    f"{k}")
        if launches["table_fill"]:
            sweeps = launches["propagate"] / launches["table_fill"]
            print(f"propagation sweeps per clustering: {sweeps}")
            require(sweeps < max_sweeps(), f"{sweeps} sweeps, the bound "
                    f"is {max_sweeps()}")
        cpu = Pipeline(device="cpu").analyze(venues[n])
        check_same(host_arrays(out), host_arrays(cpu), False,
                   f"{n:,} points, card vs CPU")
        print("card equals the port on the CPU: yes")
        check_jax_reference(out, ref, f"card, {n:,} points")
        if n == 40_960:
            radius["launches"] = launches["radius_count"]
        print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("1,000,000-point venue on the card")
    t0 = time.perf_counter()
    venues[1_000_000] = big = scaled_venue(1_000_000)
    out, launches_1m = traced_run(pipe, big, "1,000,000-point")
    for k in COLUMN_KERNELS:
        require(launches_1m[k] > 0, f"the 1M-point run did not launch {k}")
    runs = launches_1m["table_fill"]
    sweeps = launches_1m["propagate"] / runs
    print(f"clustering runs: {runs}, propagation sweeps per run: {sweeps}")
    require(sweeps < max_sweeps(), f"{sweeps} sweeps, the bound is "
            f"{max_sweeps()}")
    check_jax_reference(out, JAX_REFERENCE_1M, "card, 1,000,000 points")
    again = pipe.analyze(big)
    check_same(host_arrays(out), host_arrays(again), True,
               "second 1M-point run")
    print("second run bit-identical: yes")
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("warm wall time of analyze on the card")
    for name, pts in (("10,000-point fixture", fixture),
                      *((f"{n:,}-point venue", v)
                        for n, v in venues.items())):
        t0 = time.perf_counter()
        ms = wall_ms(lambda: pipe.analyze(pts))
        print(f"analyze {name}: median {ms:.3f} ms of 5 (warm, "
              f"synchronised) on {ident}; phase "
              f"{time.perf_counter() - t0:.3f} s")

    records = [dict(name="radius_count", route="cuda",
                    source=KERNELS["radius_count"][0],
                    replaces=KERNELS["radius_count"][1],
                    launches=radius["launches"],
                    max_abs_err=radius["max_abs_err"], ms=radius["ms"],
                    plain_ms=radius["plain_ms"],
                    bound_ms=radius["bound_ms"],
                    bound_by=radius["bound_by"], library_ms=None)]
    for k in COLUMN_KERNELS:
        records.append(dict(name=k, route="cuda", source=KERNELS[k][0],
                            replaces=KERNELS[k][1], launches=launches_1m[k],
                            max_abs_err=cols["errs"][k], **cols["times"][k],
                            library_ms=None))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
