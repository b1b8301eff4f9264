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
     mask), ``fps`` single and batched (bit-equal; masks, exact ties),
     ``sa_mlp_pool`` at the three shapes of the neural path in float32 and
     bfloat16 (within the stated tolerances), and ``place_dense`` on the
     3M-point scan's own stream and on edge cases (bit-equal);
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
  7. serves the shipped checkpoint through ``NeuralPipeline(device="cuda")
     .analyze`` (the card against the port's CPU run and the JAX package's
     recorded values, two ``fps_batched`` and two ``sa_mlp_pool`` launches
     a forward), runs the default-width CrowdNet on a batch of 4 and the
     100,000-point set-abstraction layer (``fps_single`` -> ``ball_group``
     -> ``group_features`` -> ``sa_mlp_pool``), each against the port's CPU
     run;
  8. runs a 3,000,000-point scan, whose centroids take the ``place_dense``
     route: the JAX package's recorded values, the centroids of the other
     route on the same labels, a second run bit-identical;
  9. prints the warm wall time of ``analyze`` at every size.

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
    "place_dense": (f"{PORT}/csrc/place_dense.cu",
                    f"{JAX_PKG}/ops/pallas/fill.py:398"),
    "fps_single": (f"{PORT}/csrc/fps.cu",
                   f"{JAX_PKG}/ops/pallas/kernels.py:351"),
    "fps_batched": (f"{PORT}/csrc/fps.cu",
                    f"{JAX_PKG}/ops/pallas/kernels.py:410"),
    "sa_mlp_pool": (f"{PORT}/csrc/sa_mlp_pool.cu",
                    f"{JAX_PKG}/ops/pallas/kernels.py:166"),
}
COLUMN_KERNELS = tuple(KERNELS)[1:6]
# H100 SXM published peaks: HBM bandwidth, FP32 outside the tensor cores,
# bf16 in the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

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
JAX_REFERENCE_3M = {"people": 133253, "n_clusters": 133253,
                    "max_density": 4.5, "avg_density": 0.4935303032398224,
                    "direction": "E", "severities": [9, 9, 8]}
# The shipped checkpoint through the JAX package's
# NeuralPipeline(use_pallas=False).analyze on the CPU, a fresh pipeline per
# cloud (``python3 -m tools.jax_reference_values neural``):
# sample_venue(n_points=4096, n_people=50, seed=42) and the 10,000-point
# seed-42 fixture, which is cut to 4,096 points first
JAX_NEURAL_4096 = {"people": 24, "max_density": 0.298941969871521,
                   "n_hotspots": 0, "avg_speed": 1.261393666267395,
                   "direction": "E", "severities": [],
                   "max_congestion": 0.48032957315444946}
JAX_NEURAL_FIXTURE = {"people": 26, "max_density": 0.5339675545692444,
                      "n_hotspots": 1, "avg_speed": 1.255526065826416,
                      "direction": "E", "severities": [],
                      "max_congestion": 0.49052268266677856}
# flow vectors, speeds and centroids: sin/cos and sums differ in the last
# ulps between the CPU and CUDA
FLOAT_TOL = 1e-5
# The centroids of the place_dense route against the indexed route: the
# first divides float32 sums in float32 (as the JAX package does), the second
# float64 sums in float64 and rounds once, so they differ by up to 2 float32
# ulps of the coordinate (6e-5 m at 256 m). Relative to max(1, |coordinate|).
CENTROID_ROUTE_TOL = 2.4e-7
# sa_mlp_pool against its plain version (a library matrix product): the
# inner sums run in another order. With bfloat16 operands a sum that lands
# an ulp apart can round an operand of the next layer the other way, 2^-8
# relative. Both as |a - b| <= tol * (1 + |b|).
SA_F32_TOL = 2e-5
SA_BF16_TOL = 2e-2
# CrowdNet's maps, the card against the port's CPU run and the JAX
# package's CPU values: products, convolutions and per-cell sums round in
# another order (the JAX package's own tests allow 1e-4 between its routes)
NEURAL_TOL = 1e-4


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


def cuda_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Mean milliseconds per call on the device, after a warm-up."""
    import torch
    for _ in range(warm):
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


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S
          ) -> tuple:
    """(least ms, what bounds it): bytes over the HBM rate against
    operations over their peak rate (FP32 unless said otherwise)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
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


def traced(fn, what: str) -> tuple:
    """``fn()`` with the launch counts set to 0 just before it and read
    just after."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"launches in the {what} run: "
          f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches


# ---------------------------------------------------------------------------
# place_dense
# ---------------------------------------------------------------------------

def run_place_checks(dev, points, labels, k: int) -> dict:
    """``place_dense`` against its plain version, bit for bit: the centroid
    pack of a scan's own clustering (``points`` (N, 3), ``labels`` (N,) on
    the card, ``k`` people slots), then the edge cases. Times and bound at
    the scan's stream; ``library_ms`` is one ``index_copy_`` into a
    (C + 1, K' + 1) buffer with a spill slot for the invalid rows."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import clustering
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place

    seg = torch.where(labels >= 0, labels.to(torch.int64), k).clamp_max(k)
    ids, valid, chans = clustering._segment_end_rows(points, seg, k)
    n, kp = ids.shape[0], place.padded_slots(k)
    rng = np.random.RandomState(5)

    def rows(ids_np, valid_np, nch):
        return (torch.from_numpy(ids_np.astype(np.int32)).to(dev),
                torch.from_numpy(valid_np).to(dev),
                torch.from_numpy(rng.uniform(-1e4, 1e4, (nch, len(ids_np)))
                                 .astype(np.float32)).to(dev))

    # ids from below 0 to past K': each clipped slot keeps its last row
    wild = np.sort(rng.randint(-3, 1024 + 40, 5000))
    clipped = np.clip(wild, 0, 1023)
    last = np.concatenate([clipped[1:] != clipped[:-1], [True]])
    cases = [
        ("the 3M scan's stream", (ids, valid, chans), k),
        ("no valid row", (ids, torch.zeros_like(valid), chans), k),
        ("every slot hit", rows(np.arange(2048), np.ones(2048, bool), 7),
         2048),
        ("ids below 0 and past K'", rows(wild, last, 3), 1000),
    ]
    max_err = 0.0
    for name, args, kk in cases:
        got = place.place_dense(*args, kk)
        want = place.place_dense_reference(*args, kk)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        max_err = max(max_err, err)
        print(f"place_dense {name}: {args[0].shape[0]} rows, "
              f"{int(args[1].sum())} valid, K' {got[1].shape[0]}, "
              f"{int(got[1].sum())} slots occupied; max_abs_err {err}")
        for g, w in zip(got, want):
            require(g.shape == w.shape and torch.equal(
                g.contiguous().view(torch.int32),
                w.contiguous().view(torch.int32)),
                f"place_dense differs from its plain version: {name}")
        if name == "no valid row":
            require(not got[0].any() and not got[1].any(),
                    "no valid row must leave every slot 0")
        if name == "every slot hit":
            require(bool(got[1].all()), "every slot must be occupied")
        if name == "ids below 0 and past K'":
            require(float(got[1][0]) == 1.0 and float(got[1][-1]) == 1.0,
                    "clipped ids land in the first and last slot")

    nch, n_valid = chans.shape[0], int(valid.sum())
    ms = cuda_ms(lambda: place.place_dense(ids, valid, chans, k))
    plain = cuda_ms(lambda: place.place_dense_reference(ids, valid, chans, k),
                    iters=5)
    spill = torch.where(valid, ids.clamp(0, kp - 1), kp).to(torch.int64)
    src = torch.cat([chans, torch.ones_like(chans[:1])])

    def library():
        buf = torch.zeros((nch + 1, kp + 1), dtype=torch.float32, device=dev)
        return buf.index_copy_(1, spill, src)

    lib_ms = cuda_ms(library)
    # ids and valid read once, the channels at the valid rows, every slot
    # of the (C + 1, K') result written once; no arithmetic
    b_ms, b_by = bound(5 * n + 4 * nch * n_valid + 4 * (nch + 1) * kp, 0)
    print(f"place_dense at the 3M scan's stream ({n} rows, {n_valid} valid, "
          f"{nch} channels, K' {kp}): kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, index_copy_ {lib_ms:.6f} ms, bound {b_ms:.6f} "
          f"ms ({b_by})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


# ---------------------------------------------------------------------------
# fps and sa_mlp_pool
# ---------------------------------------------------------------------------

def venue_batch(b: int, n: int):
    """``b`` sample venues of ``n`` points, the last 0, 1/8, 2/8 ... of
    each masked: (points (b, n, 3) float32, mask (b, n), venue_min (b, 2),
    venue_size (b,)) as numpy."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import sample_venue
    pts = np.stack([sample_venue(n_points=n, n_people=80, seed=100 + i)
                    for i in range(b)]).astype(np.float32)
    mask = np.arange(n)[None, :] < (n - np.arange(b) * (n // 8))[:, None]
    vmin = np.stack([p[m, :2].min(0) for p, m in zip(pts, mask)])
    vsize = np.array([np.ptp(p[m, :2], axis=0).max() + 1e-6
                      for p, m in zip(pts, mask)], np.float32)
    return pts, mask, vmin.astype(np.float32), vsize


def run_fps_checks(dev, layer_points) -> dict:
    """Both ``fps`` entries against the plain version, indices bit-equal.
    ``layer_points`` (100,000, 3) float32 on the card: the set-abstraction
    layer's cloud. Times: ``fps_single`` at that layer (4,096 samples),
    ``fps_batched`` at the served model's first layer (1 x 4,096 -> 512)."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    errs = {"fps_single": 0, "fps_batched": 0}

    def same(kernel, name, got, want):
        torch.cuda.synchronize()
        err = int_err(got, want)
        errs[kernel] = max(errs[kernel], err)
        first = int((got != want).flatten().to(torch.int8).argmax()) \
            if err else -1
        print(f"{kernel} {name}: {tuple(got.shape)} indices, max_abs_err "
              f"{err}" + (f", first difference at {first}" if err else ""))
        require(got.dtype == torch.int32 and torch.equal(got, want),
                f"{kernel} differs from its plain version: {name}")

    n_layer = layer_points.shape[0]
    ones = torch.ones(n_layer, dtype=torch.bool, device=dev)
    got = P.fps_single(layer_points, ones, 4096)
    want = P.fps_reference(layer_points, ones, 4096)
    same("fps_single", f"{n_layer} -> 4096", got, want)
    require(got.unique().numel() == 4096, "4,096 distinct samples")

    pts, mask, _, _ = venue_batch(4, 8192)
    bp, bm = dev_t(pts), dev_t(mask)
    got = P.fps_batched(bp, bm, 1024)
    same("fps_batched", "4 x 8192 -> 1024", got,
         P.fps_reference(bp, bm, 1024))
    rows = torch.stack([P.fps_single(bp[i], bm[i], 1024) for i in range(4)])
    same("fps_single", "row by row of the batch", rows, got)
    require(bool(torch.gather(bm, 1, got[:, 1:].to(torch.int64)).all()),
            "a masked point was chosen")

    few = np.zeros(4096, bool)
    few[np.random.RandomState(1).choice(4096, 100, replace=False)] = True
    p1, m1 = dev_t(pts[0, :4096]), dev_t(few)
    got = P.fps_single(p1, m1, 512, start_index=7)
    same("fps_single", "100 valid points, 512 samples, start 7", got,
         P.fps_reference(p1, m1, 512, start_index=7))
    require(int(got[0]) == 7 and got[1:].unique().numel() == 100,
            "with fewer valid points than samples the indices repeat")
    none = torch.zeros_like(m1)
    same("fps_single", "every point masked", P.fps_single(p1, none, 16),
         P.fps_reference(p1, none, 16))

    i, j = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    lattice = dev_t(np.stack([i.ravel(), j.ravel(), np.zeros(4096)], 1)
                    .astype(np.float32))
    lm = torch.ones(4096, dtype=torch.bool, device=dev)
    same("fps_single", "64 x 64 lattice (exact ties)",
         P.fps_single(lattice, lm, 512), P.fps_reference(lattice, lm, 512))
    both = torch.stack([lattice, lattice.flip(0)])
    same("fps_batched", "2 lattices (exact ties)",
         P.fps_batched(both, torch.stack([lm, lm]), 512),
         P.fps_reference(both, torch.stack([lm, lm]), 512))
    # 60,000 points: the distance cache leaves shared memory, 20,000: it
    # stays and the coordinates stream from L2
    for n in (60_000, 20_000):
        same("fps_single", f"{n} -> 256", P.fps_single(
            layer_points[:n].contiguous(), ones[:n], 256),
            P.fps_reference(layer_points[:n], ones[:n], 256))

    def fps_bound(b, n, m):
        # points and mask read once, indices written once; per point and
        # step 3 subtractions, 3 products, 2 sums and a minimum
        return bound(b * (13 * n + 4 * m), 9.0 * b * n * (m - 1))

    out = {}
    ms = cuda_ms(lambda: P.fps_single(layer_points, ones, 4096), iters=3,
                 warm=1)
    plain = cuda_ms(lambda: P.fps_reference(layer_points, ones, 4096),
                    iters=1, warm=1)
    b_ms, b_by = fps_bound(1, n_layer, 4096)
    print(f"fps_single {n_layer} -> 4096: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, bound {b_ms:.6f} ms ({b_by}); the 4,095 steps "
          f"depend on each other, {ms / 4095 * 1e3:.3f} us a step")
    out["fps_single"] = {"max_abs_err": errs["fps_single"], "ms": ms,
                         "plain_ms": plain, "bound_ms": b_ms,
                         "bound_by": b_by}
    sp, sm = bp[:1, :4096].contiguous(), bm[:1, :4096].contiguous()
    ms = cuda_ms(lambda: P.fps_batched(sp, sm, 512))
    plain = cuda_ms(lambda: P.fps_reference(sp, sm, 512), iters=2, warm=1)
    b_ms, b_by = fps_bound(1, 4096, 512)
    print(f"fps_batched 1 x 4096 -> 512: kernel {ms:.6f} ms, plain "
          f"{plain:.6f} ms, bound {b_ms:.6f} ms ({b_by}); "
          f"{ms / 511 * 1e3:.3f} us a step")
    out["fps_batched"] = {"max_abs_err": errs["fps_batched"], "ms": ms,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by}
    ms4 = cuda_ms(lambda: P.fps_batched(bp, bm, 1024))
    print(f"fps_batched 4 x 8192 -> 1024 (the default model's first "
          f"layer): kernel {ms4:.6f} ms, bound "
          f"{fps_bound(4, 8192, 1024)[0]:.6f} ms")
    return out


SA_SHAPES = (("served SA1", 512, 3, (32, 32, 64)),
             ("served SA2", 128, 67, (64, 64, 128)),
             ("100,000-point layer", 4096, 3, (32, 32, 64)),
             ("ragged tile", 510, 3, (32, 32, 64)))


def sa_weights(rng, cin, hidden, dev):
    import torch
    dims = [cin] + list(hidden)
    return [(torch.from_numpy((rng.randn(a, b) * 0.1).astype("float32"))
             .to(dev),
             torch.from_numpy((rng.randn(b) * 0.05).astype("float32"))
             .to(dev)) for a, b in zip(dims[:-1], dims[1:])]


def rel_err(got, want) -> float:
    """max |got - want| / (1 + |want|)."""
    return float(((got - want).abs() / (1 + want.abs())).max())


def run_sa_checks(dev) -> dict:
    """``sa_mlp_pool`` against its plain version (library matrix products
    in full float32) at the shapes of the neural path, K = 32, in float32
    and with bfloat16 operands; a centroid with no valid neighbour; M not a
    multiple of the tile. Times and bound at the 100,000-point layer."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the plain version's products must run in full float32")
    rng = np.random.RandomState(9)
    seen = {torch.float32: 0.0, torch.bfloat16: 0.0}
    abs_err = 0.0
    timed = None
    for name, m, cin, hidden in SA_SHAPES:
        g = torch.from_numpy((rng.randn(m, 32, cin) * 0.3).astype(np.float32)
                             ).to(dev)
        v = torch.from_numpy(rng.rand(m, 32) > 0.3).to(dev)
        v[m // 2] = False
        w = sa_weights(rng, cin, hidden, dev)
        for dtype, tol in ((torch.float32, SA_F32_TOL),
                           (torch.bfloat16, SA_BF16_TOL)):
            got = P.sa_mlp_pool(g, v, w, compute_dtype=dtype)
            want = P.sa_mlp_pool_reference(g, v, w, dtype)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            seen[dtype] = max(seen[dtype], err)
            if dtype == torch.float32:
                abs_err = max(abs_err, float((got - want).abs().max()))
            print(f"sa_mlp_pool {name} ({m} x 32 x {cin} -> {hidden[-1]}, "
                  f"{str(dtype).split('.')[1]}): max relative error {err:.3e} "
                  f"(tolerance {tol}), max value "
                  f"{float(want.abs().max()):.4f}")
            require(got.shape == want.shape and err <= tol,
                    f"sa_mlp_pool off by {err}: {name}, {dtype}")
            require(not got[m // 2].any(),
                    "a centroid with no valid neighbour pools to 0")
            if dtype == torch.float32:
                f32 = got
            else:
                require(float((got - f32).abs().max()) > 1e-6,
                        "bfloat16 operands must change the result")
        if name == "100,000-point layer":
            timed = (g, v, w, m, cin, hidden)
    print(f"sa_mlp_pool: worst relative error seen {seen[torch.float32]:.3e} "
          f"in float32, {seen[torch.bfloat16]:.3e} with bfloat16 operands")

    g, v, w, m, cin, hidden = timed
    dims = [cin] + list(hidden)
    ops = 2.0 * m * 32 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = (g.numel() * 4 + v.numel() + m * hidden[-1] * 4
              + sum(wi.numel() * 4 + bi.numel() * 4 for wi, bi in w))
    record = None
    for dtype, peak in ((torch.bfloat16, BF16_OPS_PER_S),
                        (torch.float32, FP32_OPS_PER_S)):
        ms = cuda_ms(lambda: P.sa_mlp_pool(g, v, w, compute_dtype=dtype))
        plain = cuda_ms(lambda: P.sa_mlp_pool_reference(g, v, w, dtype),
                        iters=5)
        b_ms, b_by = bound(nbytes, ops, peak)
        print(f"sa_mlp_pool at the 100,000-point layer ({m} x 32 x {cin} -> "
              f"{hidden[-1]}, {str(dtype).split('.')[1]}): kernel {ms:.6f} "
              f"ms, plain {plain:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
        record = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain,
                  "bound_ms": b_ms, "bound_by": b_by}
    return record  # float32: what the served model runs


# ---------------------------------------------------------------------------
# the neural path
# ---------------------------------------------------------------------------

def check_groups(card_model, cpu_model, pts, mask, what: str) -> None:
    """FPS and neighbour indices of both set-abstraction layers, the card
    against the CPU: exact."""
    import torch
    groups = []
    for model, dev in ((card_model, "cuda"), (cpu_model, "cpu")):
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        with torch.no_grad():
            idx1 = model.sa1.sample(p, m)
            c1, m1, gi1, gv1, g1 = model.sa1.group(p, None, m, idx1)
            f1 = model.sa1.pool(g1, gv1, m1)
            idx2 = model.sa2.sample(c1, m1)
            _, _, gi2, gv2, _ = model.sa2.group(c1, f1, m1, idx2)
        groups.append([t.cpu() for t in (idx1, gi1, gv1, idx2, gi2, gv2)])
    names = ("SA1 FPS indices", "SA1 neighbour indices", "SA1 validity",
             "SA2 FPS indices", "SA2 neighbour indices", "SA2 validity")
    for name, a, b in zip(names, *groups):
        require(torch.equal(a, b), f"{what}: {name} differ, card vs CPU")
    print(f"{what}: FPS and neighbour indices of both layers equal on the "
          f"card and the CPU")


def neural_arrays(out) -> dict:
    d, f = out["density"], out["flow"]
    return {"density_map": d["density_map"],
            "vectors": f["flow_vectors"]["vectors"],
            "congestion": out["congestion"]["map"],
            "people": d["total_people"],
            "bottlenecks": [(b["x"], b["y"], b["severity"])
                            for b in f["bottlenecks"]],
            "hotspot_cells": [(h["x"], h["y"]) for h in d["hotspots"]],
            "direction": f["dominant_direction"]}


def check_neural_same(a: dict, b: dict, tol: float, what: str) -> None:
    import numpy as np
    worst = 0.0
    for key in a:
        if isinstance(a[key], np.ndarray):
            err = float(np.abs(a[key] - b[key]).max())
            worst = max(worst, err)
            require(err <= tol, f"{what}: {key} off by {err}")
        else:
            require(a[key] == b[key], f"{what}: {key} {a[key]} vs {b[key]}")
    print(f"{what}: people, hotspot cells, bottlenecks and direction equal, "
          f"maps within {worst:.3e} (tolerance {tol})")


def check_neural_reference(out, ref: dict, what: str) -> None:
    d, f = out["density"], out["flow"]
    got = {"people": d["total_people"], "max_density": d["max_density"],
           "n_hotspots": len(d["hotspots"]), "avg_speed": f["avg_speed"],
           "direction": f["dominant_direction"],
           "severities": [b["severity"] for b in f["bottlenecks"]],
           "max_congestion": out["congestion"]["max"]}
    print(f"{what}: {got}")
    print(f"JAX package on the CPU (recorded): {ref}")
    for key, want in ref.items():
        if isinstance(want, float):
            require(abs(got[key] - want) <= NEURAL_TOL,
                    f"{what}: {key} {got[key]} vs {want}")
        else:
            require(got[key] == want, f"{what}: {key} {got[key]} vs {want}")


def run_neural_serving(ident: str) -> dict:
    """``NeuralPipeline.analyze`` with the shipped checkpoint at its full
    configuration (4,096 points, 512 and 128 samples, grid 32) on the card:
    against the port's CPU run, the JAX package's recorded values, and a
    second card run. Returns the launch counts of one ``analyze``."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import (
        NeuralPipeline, sample_venue)

    card, cpu = NeuralPipeline(device="cuda"), NeuralPipeline(device="cpu")
    cfg = card.train_config
    print(f"checkpoint: {cfg.n_points} points, {cfg.sa1_samples} and "
          f"{cfg.sa2_samples} samples, grid {cfg.grid}, bf16 {cfg.bf16}")
    cloud = sample_venue(n_points=4096, n_people=50, seed=42)
    out, launches = traced(lambda: card.analyze(cloud), "neural 4,096-point")
    require(launches["fps_batched"] == 2 and launches["sa_mlp_pool"] == 2,
            f"a forward launches fps_batched and sa_mlp_pool twice each, "
            f"got {launches}")
    g = cfg.grid
    require(out["density"]["density_map"].shape == (g, g)
            and out["flow"]["flow_vectors"]["vectors"].shape == (g * g, 2)
            and np.isfinite(out["density"]["density_map"]).all()
            and np.isfinite(out["flow"]["flow_vectors"]["vectors"]).all(),
            "finite maps of the grid's shape")
    check_neural_same(neural_arrays(out), neural_arrays(cpu.analyze(cloud)),
                      NEURAL_TOL, "neural 4,096 points, card vs CPU")
    check_neural_reference(out, JAX_NEURAL_4096, "card, neural 4,096 points")
    again = neural_arrays(card.analyze(cloud))
    check_neural_same(neural_arrays(out), again, 0.0,
                      "second neural run on the card")
    pts, mask = card.padded_cloud(cloud[:, :3])
    check_groups(card.model, cpu.model, pts[None], mask[None],
                 "neural 4,096 points")

    # above the model's capacity: each fresh pipeline cuts the fixture to
    # the same 4,096 points (the first draw of its numpy stream)
    fixture = sample_venue()
    fresh_card = NeuralPipeline(device="cuda")
    fout, fl = traced(lambda: fresh_card.analyze(fixture), "neural fixture")
    require(fl["fps_batched"] == 2 and fl["sa_mlp_pool"] == 2,
            f"launches of the fixture's forward: {fl}")
    check_neural_same(neural_arrays(fout), neural_arrays(
        NeuralPipeline(device="cpu").analyze(fixture)), NEURAL_TOL,
        "neural fixture (cut to 4,096 points), card vs CPU")
    check_neural_reference(fout, JAX_NEURAL_FIXTURE, "card, neural fixture")
    ms = wall_ms(lambda: card.analyze(cloud))
    print(f"NeuralPipeline.analyze, 4,096 points: median {ms:.3f} ms of 5 "
          f"(warm, synchronised) on {ident}")
    return launches


def run_default_model(ident: str) -> None:
    """The default-width CrowdNet (8,192 points, 1,024 and 256 samples,
    grid 64) on a batch of 4, weights from a numpy seed: the card against
    the port's CPU run."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import train

    cfg = train.TrainConfig()
    cpu_model = train.make_model(cfg).eval()
    cpu_model.load_state_dict(train.seeded_state_dict(cpu_model, 11))
    card_model = train.make_model(cfg).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    card_model.to("cuda")
    batch = venue_batch(cfg.batch_size, cfg.n_points)
    cpu_in = [torch.from_numpy(x) for x in batch]
    card_in = [x.to("cuda") for x in cpu_in]

    def forward(model, inputs):
        with torch.no_grad():
            return model(*inputs)

    out, launches = traced(lambda: forward(card_model, card_in),
                           "default-width model")
    require(launches["fps_batched"] == 2 and launches["sa_mlp_pool"] == 2,
            f"launches of the default model's forward: {launches}")
    want = forward(cpu_model, cpu_in)
    g = cfg.grid
    require(out["density"].shape == (4, g, g)
            and out["flow"].shape == (4, g, g, 2)
            and out["count"].shape == (4,), "output shapes")
    worst = 0.0
    for key in out:
        require(bool(torch.isfinite(out[key]).all()), f"{key} not finite")
        err = rel_err(out[key].cpu(), want[key])
        worst = max(worst, err)
        require(err <= NEURAL_TOL, f"default model: {key} off by {err}")
    print(f"default-width model, batch 4: outputs finite, card vs CPU "
          f"within {worst:.3e} relative (tolerance {NEURAL_TOL})")
    check_groups(card_model, cpu_model, batch[0], batch[1],
                 "default-width model")
    again = forward(card_model, card_in)
    require(all(torch.equal(out[k], again[k]) for k in out),
            "second forward of the default model differs")
    ms = wall_ms(lambda: forward(card_model, card_in))
    print(f"default-width model forward, 4 x 8,192 points: median {ms:.3f} "
          f"ms of 5 (warm, synchronised) on {ident}")


def run_sa_layer(dev, layer_points, ident: str) -> dict:
    """The single set-abstraction layer at 100,000 points: 4,096 samples,
    K = 32, r = 0.6, MLP 3-32-32-64, with bfloat16 operands and in float32:
    ``fps_single`` -> ``ball_group`` -> ``group_features`` ->
    ``sa_mlp_pool``, the card against the port's CPU run. Returns the
    launch counts of one bfloat16 layer."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)
    from lidar_ai_recommendation_software_tpu_torch.ops.grouping import (
        ball_group, group_features)

    rng = np.random.RandomState(0)
    dims = [3, 32, 32, 64]
    w_np = [((rng.randn(a, b) * 0.1).astype(np.float32),
             np.zeros(b, np.float32)) for a, b in zip(dims[:-1], dims[1:])]

    def layer(p, dtype):
        mask = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        w = [(torch.from_numpy(a).to(p.device),
              torch.from_numpy(b).to(p.device)) for a, b in w_np]
        idx = P.fps_single(p, mask, 4096)
        cents = p[idx.to(torch.int64)]
        gidx, gvalid = ball_group(cents, mask[idx.to(torch.int64)], p, mask,
                                  0.6, 32)
        g = group_features(p, None, cents, gidx, gvalid)
        return idx, gidx, gvalid, P.sa_mlp_pool(g, gvalid, w,
                                                compute_dtype=dtype)

    got, launches = traced(lambda: layer(layer_points, torch.bfloat16),
                           "100,000-point layer")
    require(launches["fps_single"] == 1 and launches["sa_mlp_pool"] == 1,
            f"launches of the layer: {launches}")
    t0 = time.perf_counter()
    cpu_points = layer_points.cpu()
    want = layer(cpu_points, torch.bfloat16)
    print(f"the port's CPU run of the layer took "
          f"{time.perf_counter() - t0:.3f} s")
    for name, a, b in zip(("FPS indices", "neighbour indices", "validity"),
                          got, want):
        require(torch.equal(a.cpu(), b), f"layer: {name} differ, card vs CPU")
    err = rel_err(got[3].cpu(), want[3])
    require(got[3].shape == (4096, 64) and err <= SA_BF16_TOL,
            f"layer, bfloat16: pooled features off by {err}")
    f32 = layer(layer_points, torch.float32)[3]
    f32_err = rel_err(f32.cpu(), layer(cpu_points, torch.float32)[3])
    require(f32_err <= SA_F32_TOL,
            f"layer, float32: pooled features off by {f32_err}")
    print(f"100,000-point layer: indices equal, pooled features within "
          f"{err:.3e} (bfloat16 operands, tolerance {SA_BF16_TOL}) and "
          f"{f32_err:.3e} (float32, tolerance {SA_F32_TOL}); "
          f"{int(got[2].sum())} of {got[2].numel()} neighbour slots valid")
    for dtype in (torch.bfloat16, torch.float32):
        ms = wall_ms(lambda: layer(layer_points, dtype), reps=3)
        print(f"100,000-point layer, {str(dtype).split('.')[1]}: median "
              f"{ms:.3f} ms of 3 (warm, synchronised) on {ident}")
    return launches


def run_scan_3m(pipe, ident: str) -> tuple:
    """A 3,000,000-point scan: its clustering buffer exceeds 2,097,152
    rows, so the centroids pack their segment ends with ``place_dense``.
    Returns (the scan, the launch counts of one ``analyze``, place_dense's
    record)."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.ops import clustering

    scan = scaled_venue(3_000_000)
    cap = pipe.fit_capacity(scan).capacity
    print(f"capacities: {cap.max_points} points, {cap.max_people} people")
    require(cap.max_points > clustering.SEGSUM_MAX_POINTS,
            "the scan's buffer must exceed the centroid route's switch")
    out, launches = traced(lambda: pipe.analyze(scan), "3,000,000-point")
    for k in (*COLUMN_KERNELS, "place_dense"):
        require(launches[k] > 0, f"the 3M-point run did not launch {k}")
    check_jax_reference(out, JAX_REFERENCE_3M, "card, 3,000,000 points")
    pro, ppl = out["processed"], out["people"]
    require(int(ppl.mask.sum()) == int(pro.n_clusters),
            "people must equal clusters")
    # the route below the switch, on the same labels
    k = ppl.mask.shape[0]
    switch = clustering.SEGSUM_MAX_POINTS
    clustering.SEGSUM_MAX_POINTS = 1 << 30
    try:
        cents, valid, _ = clustering.cluster_centroids(pro.points,
                                                       pro.labels, k)
    finally:
        clustering.SEGSUM_MAX_POINTS = switch
    require(torch.equal(valid, ppl.mask), "occupied slots differ by route")
    want = cents[:, :2]
    err = float(((want - ppl.positions).abs()
                 / want.abs().clamp_min(1.0)).max())
    require(err <= CENTROID_ROUTE_TOL, f"centroids differ by route: {err}")
    print(f"centroids of the place_dense route and the indexed route on the "
          f"same labels: {int(valid.sum())} slots, within {err:.3e} of the "
          f"coordinate (tolerance {CENTROID_ROUTE_TOL})")
    again = pipe.analyze(scan)
    check_same(host_arrays(out), host_arrays(again), True,
               "second 3M-point run")
    print("second run bit-identical: yes")
    record = run_place_checks(pro.points.device, pro.points, pro.labels, k)
    return scan, launches, record


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
    golden, launches = traced(lambda: pipe.analyze(fixture), "fixture")
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
            (262_144, JAX_REFERENCE_262144,
             ("radius_count", *COLUMN_KERNELS))):
        phase(f"{n:,}-point venue, card vs the port on the CPU")
        t0 = time.perf_counter()
        venues[n] = scaled_venue(n)
        out, launches = traced(lambda: pipe.analyze(venues[n]),
                               f"{n:,}-point")
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
    out, launches_1m = traced(lambda: pipe.analyze(big),
                              "1,000,000-point")
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

    phase("fps kernels against their plain version")
    t0 = time.perf_counter()
    import numpy as np
    layer_points = torch.from_numpy(np.ascontiguousarray(
        scaled_venue(100_000)[:, :3], dtype=np.float32)).to(dev)
    fps = run_fps_checks(dev, layer_points)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("sa_mlp_pool kernel against its plain version")
    sa = run_sa_checks(dev)

    phase("neural serving with the shipped checkpoint")
    t0 = time.perf_counter()
    launches_neural = run_neural_serving(ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("default-width CrowdNet, batch 4, card vs the port on the CPU")
    t0 = time.perf_counter()
    run_default_model(ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("100,000-point set-abstraction layer")
    t0 = time.perf_counter()
    launches_layer = run_sa_layer(dev, layer_points, ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("3,000,000-point scan on the card and place_dense")
    t0 = time.perf_counter()
    venues[3_000_000], launches_3m, placed = run_scan_3m(pipe, ident)
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
    # launches: place_dense in the 3M scan's analyze, fps_single in the
    # 100,000-point layer, fps_batched and sa_mlp_pool in one served analyze
    for k, launches, rec in (
            ("place_dense", launches_3m, placed),
            ("fps_single", launches_layer, {**fps["fps_single"],
                                            "library_ms": None}),
            ("fps_batched", launches_neural, {**fps["fps_batched"],
                                              "library_ms": None}),
            ("sa_mlp_pool", launches_neural, {**sa, "library_ms": None})):
        require(launches[k] > 0, f"{k} was not launched on its path")
        records.append(dict(name=k, route="cuda", source=KERNELS[k][0],
                            replaces=KERNELS[k][1], launches=launches[k],
                            **rec))
    require([r["name"] for r in records] == list(KERNELS), "kernel records")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
