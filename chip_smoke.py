#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It

  1. prints the card's name and power limit;
  2. builds the port's CUDA kernels from ``csrc/`` (one nvcc per source,
     all started together);
  3. holds every kernel against its plain PyTorch version on the card
     (integers bit-equal) and times both with CUDA events, and the kernel
     also replayed from a CUDA graph (the device's time without the
     wrapper's host cost): ``radius_count`` at the pipeline's three shapes
     (one kernel a call in a captured CUDA graph) and edge cases,
     ``eps_edges`` on ``synthetic.eps_edges_cases`` and at the sensor
     frame's 32,768 and the modular variant's 131,072 clustering buffers
     (the count and the fill kernel once a call), the six
     column-table kernels of the venue-scale clustering at the 262,144-,
     1M- and 3M-point scans' shapes and the temporal sequence's
     100,000-point frame, and on edge cases (an empty table, a
     full column and one past its cap, neighbours at exactly eps, a chain
     across the whole grid, a scattered mask, points at both ends of every
     x row's run of the stream, a sparse x row between two rows of full
     columns, every column full, a cap of 512, labels pointing forward,
     dropped and masked points, an empty stream, N not a multiple of the
     tile, and the fill's own: every column at or past its cap, every
     point masked, one point, runs of columns across the fill's tiles, a
     cap of 512; the fill, the propagation, the count and border-min scan
     and the tail ``dense_tail`` also captured in a CUDA graph, which a
     read back to the host would break; ``dense_tail`` also on label
     arrays fed as they are), ``table_fill`` also timed at the 10M
     ``analyze``'s buffer, ``fps`` single and batched on each
     route of its launch plan (the cloud in registers, one block with the
     cloud in shared memory, a thread-block cluster, one block streaming
     from L2; bit-equal; masks, exact ties in one warp and across the
     cluster's slices, both sides of every register instantiation),
     ``sa_mlp_pool`` at the three shapes of the neural path in float32 and
     bfloat16 (within the stated tolerances) and on the tiling's edges
     (K 16, 48 and 128, M = 1, a centroid with only its last neighbour
     valid; two runs bit-identical), and ``place_dense`` on the 3M-point
     scan's own stream and on edge cases (bit-equal; a run of 1,000,000
     invalid rows no slower than 1.5x a stream of short runs of the same
     n);
  4. runs ``Pipeline(device="cuda").analyze`` on the seed-42 fixture
     (golden values, the kernel launched, a second run bit-identical, the
     modular variant equal to the CPU);
  5. runs a 40,960-point sensor frame and a 262,144-point venue on the
     card and holds each against the port's own CPU run (integers equal,
     floats within the tests' tolerances) and against the JAX package's
     values on the CPU, recorded below;
  6. runs a 1,000,000-point venue on the card (the column-grid clustering
     and the bucketed density): the JAX package's recorded values, every
     column kernel launched, a second run bit-identical; and
     ``Pipeline.analyze_sequence`` on ``BASELINE.md`` config 3 (4 frames
     of 100,000 points): one clustering a frame, the card against the
     port's CPU run and the JAX package's recorded values, the flow's
     cosine against the generator's motion at least 0.9, a second run
     bit-identical, its warm wall time and stages;
  7. serves the shipped checkpoint through ``NeuralPipeline(device="cuda")
     .analyze`` (the card against the port's CPU run and the JAX package's
     recorded values, two ``fps_batched`` launches on the register route
     and two ``sa_mlp_pool`` launches a forward), runs the default-width
     CrowdNet on a batch of 4 and the
     100,000-point set-abstraction layer (``fps_single`` -> ``ball_group``
     -> ``group_features`` -> ``sa_mlp_pool``), each against the port's CPU
     run;
  8. runs a 3,000,000-point scan, whose centroids take the ``place_dense``
     route (one launch): the JAX package's recorded values, the centroids
     of the other route on the same labels, a second run bit-identical;
  9. drives the port's CLI (``cli.main`` in this process, and ``info`` in
     a subprocess) in a temporary directory: the 1M scan written by
     ``sample`` and as LAS and binary PCD files, read back (the LAS
     through the native parser), and ``analyze scan.las`` with JSON,
     report and store (the JAX package's recorded values, the store equal
     to the JSON, the kernels of the 1M ``Pipeline.analyze``, the CLI's
     host stages); the fixture's golden values, also under
     ``--fallback-cpu``, which must not degrade; ``--neural``;
     ``analyze-seq`` on the sequence's frames; ``train`` at its defaults,
     its checkpoint served; ``bench`` at 1M; and, in a child process,
     ``analyze sample --fallback-cpu`` after a kernel read an illegal
     address (a sticky CUDA error): raised, nothing answered from the CPU;
 10. drives the port's ``parallel/`` with four gloo ranks sharing the
     card (``parallel.mesh.spawn``, the kernels built here first):
     ``Pipeline.analyze`` of ``scaled_venue(10_000_000)`` (the JAX
     package's census), then ``sharded_dbscan`` of the buffer that run
     clustered, 4 ways, bit-equal to its single-process clustering; the
     1M venue's density (``radius_count`` on each stripe) and flow equal
     to the single card's internals; a default-width training step on a
     dp 2 x mp 2 and a dp 4 mesh against the single-process step; the
     halo round trip. Per case and rank: wall time, exchanges, staging
     through the host, launches;
 11. prints the warm wall time of ``analyze`` at every size;
 12. measures the reference's CPU baseline on the card's host with the
     port's oracle (``oracle/reference.py``, NumPy and SciPy): the
     fixture's golden values from the oracle, the card's people and
     density grid equal to it (monolith; modular within the JAX package's
     tests' tolerances); on ``bench.py``'s ``scaled_venue(100_000)`` the
     oracle's ``analyze`` once on the host's clock (``cpu_points_per_sec``
     and its stages) and the card's density grid at MAE 0 with the same
     people; then the warm 1M ``analyze``'s points/s and its ratio to
     ``cpu_points_per_sec``, beside the card and the host's CPU model.

Each pipeline run resets the launch counts just before it and reads them
just after. The line before the last is a JSON record of the kernels; the
last line is ``{"ok": true, "device": {...}}``. Any failure exits non-zero
before that line is printed. Without a CUDA device, or outside the
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

RADIUS = 2.0
PORT = "lidar_ai_recommendation_software_tpu_torch"
REPO_ROOT = str(Path(__file__).resolve().parent)
JAX_PKG = "lidar_ai_recommendation_software_tpu"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "radius_count": (f"{PORT}/csrc/radius_count.cu",
                     f"{JAX_PKG}/ops/pallas/kernels.py:76"),
    "table_fill": (f"{PORT}/csrc/column_table.cu",
                   f"{JAX_PKG}/ops/pallas/fill.py:177"),
    "dense_tail": (f"{PORT}/csrc/dense_tail.cu",
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
    # no pallas_call: the all-pairs pass of dbscan_bruteforce, tiled jnp
    "eps_edges": (f"{PORT}/csrc/eps_edges.cu",
                  f"none ({JAX_PKG}/ops/clustering.py:54-96, tiled jnp)"),
}
# the kernels every column-grid clustering launches
COLUMN_KERNELS = tuple(KERNELS)[1:6]
# H100 SXM published peaks: HBM bandwidth, FP32 outside the tensor cores,
# bf16 in the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# FP32 instructions a second outside the tensor cores (the 67 TFLOP/s count
# a fused multiply-add as two): the rate of work that cannot fuse
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2

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
# BASELINE.md config 3 (sequence_frames) through the JAX package's
# Pipeline().analyze_sequence(frames, dt=0.5) on the CPU (``python3 -m
# tools.jax_reference_values sequence``): the last frame's people, each
# frame's person-like people, the flow
JAX_REFERENCE_SEQUENCE = {"people": 3275, "tracked": [479, 469, 476, 478],
                          "avg_speed": 1.01084566116333, "direction": "E",
                          "severities": []}
# the flow's cosine against the generator's motion, as
# tests/test_temporal.py holds the JAX package
SEQUENCE_COSINE = 0.9
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
# The default-width training run (TrainConfig(): batch 4 x 8,192 points,
# seeded weights, make_batch(RandomState(0))'s batches) through the JAX
# package's train_step on the CPU, from the port's init_state weights
# carried across (``python3 -m tools.jax_reference_values train``): the
# digest of those weights, the loss of each of 3 steps on the JAX
# package's jnp path (use_pallas=False), and the first step's gradient
# norms on its kernel path (``train --fused``), whose backward the port's
# mirrors: the jnp path's ReLU gives no gradient at 0, which moves the six
# set-abstraction bias norms by up to 5.9%.
JAX_REFERENCE_TRAIN = {
    "init_sha256": "ffd24ed5c1d3f8e43bc1bc2e52b54989f40cab0c85f6d26fe4c9bf"
                   "1139068ffd",
    "losses": [1.625415325164795, 2.09482479095459, 2.060967445373535],
    "grad_norms": {
        "bev.Conv_0.bias": 0.16897141933441162,
        "bev.Conv_0.weight": 0.6320516467094421,
        "bev.Conv_1.bias": 0.2751879096031189,
        "bev.Conv_1.weight": 0.5879778861999512,
        "congestion_head.bias": 0.12768398225307465,
        "congestion_head.weight": 0.0689377412199974,
        "congestion_head_hidden.bias": 0.07254975289106369,
        "congestion_head_hidden.weight": 0.08902706205844879,
        "count_head.bias": 0.6097748279571533,
        "count_head.weight": 0.405633807182312,
        "count_head_hidden.bias": 0.3630157709121704,
        "count_head_hidden.weight": 0.44166162610054016,
        "density_head.bias": 0.0021095345728099346,
        "density_head.weight": 0.0014255908317863941,
        "density_head_hidden.bias": 0.001315953559242189,
        "density_head_hidden.weight": 0.0015841452404856682,
        "flow_head.bias": 0.7848531603813171,
        "flow_head.weight": 0.42972561717033386,
        "flow_head_hidden.bias": 0.40548622608184814,
        "flow_head_hidden.weight": 0.4933907687664032,
        "sa1.mlp0_bias": 0.007577224168926477,
        "sa1.mlp0_kernel": 0.00195671827532351,
        "sa1.mlp1_bias": 0.011747069656848907,
        "sa1.mlp1_kernel": 0.006907493807375431,
        "sa1.mlp2_bias": 0.019796334207057953,
        "sa1.mlp2_kernel": 0.009276816621422768,
        "sa2.mlp0_bias": 0.0031084760557860136,
        "sa2.mlp0_kernel": 0.0024987945798784494,
        "sa2.mlp1_bias": 0.0049230488948524,
        "sa2.mlp1_kernel": 0.0032497087959200144,
        "sa2.mlp2_bias": 0.006897623650729656,
        "sa2.mlp2_kernel": 0.003187773982062936}}
TRAIN_STEPS = 3
# Training, the card against the port's CPU run: the first step's loss and
# each gradient tensor (|g_card - g_cpu| / |g_cpu| over the whole tensor):
# the same math with sums in another order. Later losses within 1e-4
# relative, and so are the losses and first gradient norms against the
# JAX package's (its convolutions' weight gradients sum 16,384 positions
# in another order: 1.4e-5 apart from the port's on the CPU); parameters
# within 2 x lr x steps absolute: Adam turns a rounding difference in a
# near-zero gradient into an update of up to lr.
TRAIN_GRAD_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-4
# One bfloat16 step, card vs CPU: the loss within 3e-6 relative and each
# gradient tensor within 2.5e-3 relative, between the readings of a sound
# step (on an H100: the loss equal, the worst gradient 4.4e-4) and those of
# the control, the card's float32 step against the CPU's bfloat16 step
# (1.3e-5 and 1.4e-2), which must stay outside both limits
TRAIN_BF16_LOSS_TOL = 3e-6
TRAIN_BF16_GRAD_TOL = 2.5e-3
# Card runs of the training steps held bit-identical to the first. A run
# differs only when a rare rounding does (the pillar sums of a lone-row
# scan differed in 49 of 2,500 reruns on an H100,
# tools/scan_determinism.py), so more than one rerun is made
TRAIN_RERUNS = 5
# reruns of the pillar sums' float64 prefix scan of one lone row, each
# bit-identical to the first (torch.cumsum of that row differed in 65 of
# 3,000 on an H100, tools/scan_determinism.py)
PREFIX_RERUNS = 1000
# the set-abstraction layer of BASELINE.md config 2: 4,096 samples, K = 32,
# r = 0.6, MLP 3-32-32-64
LAYER_SAMPLES, LAYER_K, LAYER_R = 4096, 32, 0.6
# the pipeline's radius_count shapes: (cells a side, people capacity, live
# people, venue span) at 10,000 (the fixture), 40,960 and 262,144 points
RADIUS_SHAPES = ((64, 1280, 446, 30.0), (96, 5120, 1786, 60.7),
                 (160, 32768, 11644, 160.0))


def max_sweeps() -> int:
    """The pipeline's bound on the plain propagation's sweeps: the
    configs' ``max_cc_iters`` in units of the JAX package's 8-pass
    iterations. The kernel does not read it."""
    from lidar_ai_recommendation_software_tpu_torch import MONOLITH_CONFIG
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    return MONOLITH_CONFIG.capacity.max_cc_iters * ccl.SWEEPS_PER_CC_ITER


def require_one_pass(launches: dict, what: str) -> None:
    """Every clustering of a run (one ``table_fill`` a clustering) made
    one ``column_counts``, one ``border_min`` and the tail's launches and
    the propagation's constant number."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    runs = launches["table_fill"]
    print(f"{what}: {runs} clusterings, {launches['column_counts']} "
          f"column_counts, {launches['border_min']} border_min, "
          f"{launches['propagate']} propagation and "
          f"{launches['dense_tail']} dense_tail launches")
    for k in ("column_counts", "border_min"):
        require(launches[k] == runs, f"{what}: {launches[k]} {k} launches "
                f"in {runs} clusterings, one each expected")
    tail = C.TAIL_LAUNCHES
    require(launches["dense_tail"] == tail * runs,
            f"{what}: {launches['dense_tail']} dense_tail launches in {runs} "
            f"clusterings, {tail} each expected")
    require(launches["propagate"] == C.PROPAGATE_LAUNCHES * runs,
            f"{what}: {launches['propagate']} propagation launches in {runs} "
            f"clusterings, {C.PROPAGATE_LAUNCHES} each expected")


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
    """(name, centers, people, pmask) at the three shapes the pipeline
    gives the kernel, then the edge cases."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    def grid_centres(gx, gy, origin):
        i, j = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
        c = np.stack([origin[0] + (i.ravel() + 0.5),
                      origin[1] + (j.ravel() + 0.5)], 1)
        return c.astype(np.float32)

    def case(name, centres, people, mask):
        return (name, torch.from_numpy(centres).to(dev),
                torch.from_numpy(np.ascontiguousarray(people, np.float32)
                                 .reshape(-1, 2)).to(dev),
                torch.from_numpy(mask).to(dev))

    rng = np.random.RandomState(0)
    out = []
    for gx, k, live, span in RADIUS_SHAPES:
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
    tile = kernels.RADIUS_PEOPLE_TILE
    out.append(case("9216x5120 a dead tile between two live ones", centres,
                    people, (np.arange(5120) // tile) % 2 == 0))
    ragged = rng.uniform(-12, 12, (1000, 2)).astype(np.float32)
    out.append(case("1000x1000 (neither a multiple of its tile)",
                    ragged, rng.uniform(-12, 12, (1000, 2)),
                    np.ones(1000, bool)))
    out.append(case("1x1000 (one centre)", ragged[:1],
                    ragged[0] + rng.uniform(-3, 3, (1000, 2)),
                    np.ones(1000, bool)))
    out.append(case("1000x0 (no person)", ragged, np.zeros((0, 2)),
                    np.zeros(0, bool)))
    out.append(case("1000x5000 valid only in the last tile", ragged,
                    rng.uniform(-12, 12, (5000, 2)),
                    np.arange(5000) >= 4995))
    centre = np.float32([4.5, 4.5])
    boundary = np.stack([centre + [RADIUS, 0.0], centre + [0.0, -RADIUS],
                         centre + [RADIUS + 1e-3, 0.0], centre,
                         centre + [-RADIUS, 0.0]]).astype(np.float32)
    out.append(case("256x5 exact radius", grid_centres(16, 16, (0.0, 0.0)),
                    boundary, np.ones(5, bool)))
    # two centre tiles of a 32 x 32 grid (x 0.5-15.5 and 16.5-31.5): people
    # exactly at the radius outside each tile's bounding box, and 1e-3
    # beyond, on all four sides
    edges = []
    for x in (0.5, 15.5, 16.5, 31.5):
        side = -1.0 if x in (0.5, 16.5) else 1.0
        for extra in (0.0, 1e-3):
            edges.append([x + side * (RADIUS + extra), 7.5])
    for y in (0.5, 31.5):
        side = -1.0 if y == 0.5 else 1.0
        for extra in (0.0, 1e-3):
            edges.append([3.5, y + side * (RADIUS + extra)])
    out.append(case("1024x12 exact radius at the tiles' edges",
                    grid_centres(32, 32, (0.0, 0.0)),
                    np.float32(edges), np.ones(len(edges), bool)))
    return out


def _captured(fn, iters: int, keep_graph: bool = False):
    """A CUDA graph that captured ``iters`` calls of ``fn``, after three
    warm-up calls on a side stream (builds, attributes, allocations)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return graph


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn`` replayed from a CUDA
    graph that captured ``iters`` calls: the kernels' time without the
    wrapper's host cost. A read of the device inside ``fn`` would fail the
    capture."""
    import torch
    graph = _captured(fn, iters)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


# CUgraphNodeType values (cuda.h) of the nodes a capture makes
_NODE_KERNEL, _NODE_MEMCPY, _NODE_MEMSET = 0, 1, 2


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def device_kernels(fn) -> dict:
    """{kernel name: launches} of one call of ``fn``, read from the nodes
    of a CUDA graph that captured it (through the driver API): every
    kernel it launches, by its mangled name, memsets left out, and a copy
    as ``"memcpy"``. Exact, where ``torch.profiler``'s CUPTI trace at times
    lost a call's first kernel. ``fn`` must be capturable."""
    driver = ctypes.CDLL("libcuda.so.1")

    def call(what, *args):
        rc = getattr(driver, what)(*args)
        require(rc == 0, f"{what} returned CUresult {rc}")

    graph = _captured(fn, 1, keep_graph=True)
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(count))
    seen: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == _NODE_MEMSET:
            continue
        if kind.value == _NODE_KERNEL:
            params = _KernelNodeParams()
            call("cuGraphKernelNodeGetParams_v2", ctypes.c_void_p(node),
                 ctypes.byref(params))
            func = ctypes.c_void_p(params.func)
            if not params.func:
                call("cuKernelGetFunction", ctypes.byref(func),
                     ctypes.c_void_p(params.kern))
            name = ctypes.c_char_p()
            call("cuFuncGetName", ctypes.byref(name), func)
            key = name.value.decode()
        else:
            key = "memcpy" if kind.value == _NODE_MEMCPY else (
                f"graph node of type {kind.value}")
        seen[key] = seen.get(key, 0) + 1
    del graph
    return seen


def radius_needed_pairs(centers, people, pmask, radius) -> int:
    """The pair tests this run's data needs: for each centre tile of the
    launch plan, its centres times the valid people within the radius of
    the tile's bounding box, tested as ``csrc/radius_count.cu`` culls them
    (for every other pair the count is 0 without a test)."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    r2 = float(kernels._radius_sq(radius))
    valid = people[pmask]
    pairs = 0
    for s in range(0, centers.shape[0], kernels.RADIUS_CENTRE_TILE):
        tile = centers[s:s + kernels.RADIUS_CENTRE_TILE]
        lo, hi = tile.amin(0), tile.amax(0)
        gap = torch.where(valid < lo, lo - valid,
                          torch.where(valid > hi, hi - valid,
                                      torch.zeros_like(valid)))
        pairs += tile.shape[0] * int(((gap * gap) <= r2).all(1).sum())
    return pairs


def run_radius_checks(dev) -> dict:
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
        radius_count_work)

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
        if name.startswith("1024x12"):
            require(int(want.sum()) > 0,
                    "people exactly at the radius beyond a tile's edge")
        max_err = max(max_err, err)

    # the wrapper launches the kernel and nothing else, and reads nothing
    # back: a CUDA graph captures it, and holds one kernel node
    name, c, p, m = cases[1]
    seen = device_kernels(lambda: kernels.radius_count(c, p, m, RADIUS))
    print(f"radius_count {name}: kernels of one call {seen}")
    require(len(seen) == 1 and "radius_count_kernel" in next(iter(seen))
            and next(iter(seen.values())) == 1,
            f"radius_count launches one kernel and nothing else: {seen}")

    out = {}
    for i, (name, c, p, m) in enumerate(cases[:len(RADIUS_SHAPES)]):
        ms = cuda_ms(lambda: kernels.radius_count(c, p, m, RADIUS))
        dev_ms = graph_ms(lambda: kernels.radius_count(c, p, m, RADIUS))
        plain = cuda_ms(lambda: kernels.radius_count_reference(c, p, m,
                                                               RADIUS))
        ncent, k, live = c.shape[0], p.shape[0], int(m.sum())
        pairs = radius_needed_pairs(c, p, m, RADIUS)
        # centres and people read once, counts written once; 6 operations
        # per pair test that this run's data needs
        nbytes, ops = radius_count_work(ncent, k, pairs)
        b_ms, b_by = bound(nbytes, ops)
        print(f"radius_count {name}: kernel {ms:.6f} ms, "
              f"{dev_ms:.6f} ms from a CUDA graph, plain {plain:.6f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}), {pairs} pair tests needed; "
              f"plan {kernels.radius_plan(ncent, k)}")
        # the yardstick of earlier runs: every centre against every live
        # person, as the TPU kernel's loop counts them
        all_ms, all_by = bound(*radius_count_work(ncent, k, ncent * live))
        print(f"radius_count {name}: all-pairs bound {all_ms:.6f} ms "
              f"({all_by}), {ncent * live} pair tests")
        if i == 1:  # the 40,960-point frame's shape
            out = {"max_abs_err": max_err, "ms": ms, "graph_ms": dev_ms,
                   "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
    return out


# ---------------------------------------------------------------------------
# eps_edges
# ---------------------------------------------------------------------------

# the sensor_frame_40k deployment: one 40,960-point frame of the venue
# recipe at the reference fixture's 5.56 people per 100 m^2, whose
# clustering buffer is the all-pairs backend's largest, 32,768; and a venue
# whose non-ground points fill the modular variant's 131,072 buffer but for
# a padded tail
SENSOR_FRAME = (40_960, 5.56)
MODULAR_VENUE = 185_000


def clustering_buffer(pipe, cloud) -> tuple:
    """(points, mask, eps) that ``pipe.analyze(cloud)`` hands to
    ``eps_edges``: the clustering buffer, as the pipeline builds it."""
    from lidar_ai_recommendation_software_tpu_torch.ops import clustering
    seen = []
    real = clustering.eps_edges

    def keep(points, mask, eps):
        seen.append((points.clone(), mask.clone(), eps))
        return real(points, mask, eps)

    clustering.eps_edges = keep
    try:
        pipe.analyze(cloud)
    finally:
        clustering.eps_edges = real
    require(len(seen) == 1, f"{len(seen)} all-pairs clusterings, one "
            f"expected")
    return seen[0]


def run_eps_checks(dev) -> dict:
    """``eps_edges`` against its plain version, bit for bit, on
    ``synthetic.eps_edges_cases`` and at the pipeline's two all-pairs
    buffers; the kernels one call launches; times at both buffers."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch import (
        MODULAR_CONFIG, scaled_venue)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        eps, kernels)
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        eps_edges_cases)
    from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
        eps_edges_work)

    def same(name, p, m, e):
        kernels.reset_launch_counts()
        got = eps.eps_edges(p, m, e)
        torch.cuda.synchronize()
        launched = kernels.LAUNCHES["eps_edges"]
        want = eps.eps_edges_reference(p, m, e)
        print(f"eps_edges {name}: {p.shape[0]} points, "
              f"{int(m.sum())} valid, eps {e}, {want[1].numel()} edges, "
              f"{launched} launches")
        require(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1]),
                f"eps_edges differs from its plain version: {name}")
        require(launched == (eps.EPS_LAUNCHES if want[1].numel() else 1),
                f"eps_edges {name}: {launched} launches")
        return got

    for name, pts, mask, e in eps_edges_cases():
        same(name, torch.from_numpy(pts).to(dev),
             torch.from_numpy(mask).to(dev), e)

    n_frame, people = SENSOR_FRAME
    frame = clustering_buffer(Pipeline(device="cuda"),
                              scaled_venue(n_frame,
                                           people_per_100m2=people))
    modular = clustering_buffer(Pipeline(MODULAR_CONFIG, device="cuda"),
                                scaled_venue(MODULAR_VENUE,
                                             people_per_100m2=people))
    times = []
    for name, (p, m, e) in ((f"{n_frame:,}-point sensor frame", frame),
                            (f"modular {MODULAR_VENUE:,}-point venue",
                             modular)):
        name = f"{name}, buffer {p.shape[0]:,}"
        total = same(name, p, m, e)[1].numel()
        plan = eps.eps_plan(p.shape[0])

        def passes():
            return eps._fill_pass(p, m, e, plan,
                                  *eps._count_pass(p, m, e, plan), total)

        seen = device_kernels(passes)
        print(f"eps_edges {name}: kernels of one call, its read left out "
              f"{seen}")
        require(sum(v for k, v in seen.items() if "eps_kernel" in k) == 2
                and len([k for k in seen if "eps_kernel" in k]) == 2,
                f"eps_edges launches the count and the fill once: {seen}")
        ms = cuda_ms(lambda: eps.eps_edges(p, m, e))
        dev_ms = graph_ms(passes)
        plain = cuda_ms(lambda: eps.eps_edges_reference(p, m, e), iters=3,
                        warm=1)
        valid = int(m.sum())
        b_ms, b_by = bound(*eps_edges_work(p.shape[0], p.shape[1], valid,
                                           total),
                           ops_per_s=FP32_INSTR_PER_S)
        print(f"eps_edges {name}: kernel {ms:.6f} ms, {dev_ms:.6f} ms from "
              f"a CUDA graph, plain {plain:.6f} ms, bound {b_ms:.6f} ms "
              f"({b_by}), {valid * valid} pair tests needed, {total} edges; "
              f"plan {plan}")
        # the two passes' design bound: every pair of the buffer tested
        # twice
        two_ms = 2 * 9.0 * p.shape[0] ** 2 / FP32_INSTR_PER_S * 1e3
        print(f"eps_edges {name}: both passes over all "
              f"{p.shape[0] ** 2} pairs, bound {two_ms:.6f} ms")
        times.append({"ms": ms, "graph_ms": dev_ms, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by})
    # the record: the sensor frame's buffer; every check above is bit-equal
    return {"max_abs_err": 0, **times[0]}


# ---------------------------------------------------------------------------
# the column-table kernels
# ---------------------------------------------------------------------------

# the scans whose clustering the column kernels are timed at; the 1M-point
# scan's times are the kernels' record
COLUMN_SCANS = ((262_144, "262,144-point scan"), (1_000_000, "1M scan"),
                (3_000_000, "3M scan"))
SEQUENCE_FRAME = "100,000-point sequence frame"
# BASELINE.md config 3 as benchmarks/temporal.py builds it: 4 frames of
# 100,000 points, 500 people walking toward the exit at 1 m/s, 0.5 s apart
SEQUENCE_POINTS, SEQUENCE_FRAMES, SEQUENCE_DT = 100_000, 4, 0.5


def sequence_frames() -> tuple:
    """(extent, the frames) of the temporal sequence."""
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        venue_sequence)
    extent = (SEQUENCE_POINTS / 10_000) ** 0.5 * 15.0
    return extent, venue_sequence(
        n_frames=SEQUENCE_FRAMES, dt=SEQUENCE_DT, n_points=SEQUENCE_POINTS,
        n_people=max(10, int(50 * (extent / 15.0) ** 2)), extent=extent,
        speed=1.0)


def scan_case(name: str, venue):
    """The clustering inputs of a cloud at the capacities fit_capacity
    gives it: (name, points (N, 3) float32, mask (N,), eps, min_samples,
    ncx, ncy, column cap), the mask the non-ground points (above the 30th
    z percentile, preprocess's ground split)."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    cap = Pipeline(device="cpu").fit_capacity(venue).capacity
    ng = venue[:, 2] > np.percentile(venue[:, 2], 30.0)
    n = cap.cluster_capacity
    if len(venue) > n:
        # a buffer smaller than the cloud holds its non-ground points
        venue, ng = venue[ng], ng[ng]
    buf = np.zeros((n, 3), np.float32)
    buf[:len(venue)] = venue
    m = np.zeros(n, bool)
    m[:len(venue)] = ng
    return (name, buf, m, 0.3, 5, cap.cluster_cells_x, cap.cluster_cells_y,
            cap.cluster_column_cap)


def column_cases():
    """(name, points (N, 3) float32, mask (N,), eps, min_samples, ncx,
    ncy, column cap) as numpy, one at a time: the 262,144-, 1M- and
    3M-point scans' clustering inputs at the capacities fit_capacity gives
    them and the temporal sequence's first frame's, then the edge cases."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        column_occupancy_cases, dense_tail_cases, table_fill_cases)

    def padded(pts, n, mask=None):
        buf = np.zeros((n, 3), np.float32)
        buf[:len(pts)] = pts
        m = np.zeros(n, bool)
        m[:len(pts)] = True if mask is None else mask
        return buf, m

    for n_scan, name in COLUMN_SCANS:
        yield scan_case(name, scaled_venue(n_scan))
    yield scan_case(SEQUENCE_FRAME, sequence_frames()[1][0])

    rng = np.random.RandomState(1)
    buf, _ = padded(rng.uniform(-5, 5, (4096, 3)), 4096)
    yield ("empty table", buf, np.zeros(4096, bool), 0.3, 5, 32, 32, 8)

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
    yield ("full column and one past", buf, m, 0.3, 3, 16, 16, 8)

    # pairs at exactly float32(eps) along y and z, and just beyond
    e = np.float32(0.35)
    beyond = np.nextafter(e, np.float32(1.0))
    pts = []
    for k in range(64):
        x = np.float32(k)
        pts += [[x, 0, 0], [x, e, 0], [x, 3, 0], [x, 3, e],
                [x, 6, 0], [x, 6, beyond]]
    buf, m = padded(np.array(pts, np.float32), 512)
    yield ("neighbours at exactly eps", buf, m, 0.35, 2, 64, 32, 8)

    # one chain of points 0.285 m apart across all 1,024 columns, its
    # smallest point index at the far end of the stream order
    n_chain = 1078
    xs = (n_chain - 1 - np.arange(n_chain)) * 0.285
    buf, m = padded(np.stack([xs, np.zeros(n_chain), np.zeros(n_chain)], 1),
                    2048)
    yield ("chain across the grid", buf, m, 0.3, 2, 1024, 8, 8)

    # blobs and background, every other point masked at random
    centres = rng.uniform(0, 30, (300, 2))
    blob = centres[rng.randint(0, 300, 30000)] + rng.normal(0, 0.15,
                                                            (30000, 2))
    pts = np.concatenate([np.column_stack([blob, rng.uniform(0, 1.8, 30000)]),
                          rng.uniform(0, 30, (20000, 3))])
    buf, m = padded(pts, 65536, rng.rand(len(pts)) < 0.5)
    yield ("scattered mask", buf, m, 0.3, 5, 100, 100, 32)

    yield from column_occupancy_cases()
    yield from dense_tail_cases()
    yield from table_fill_cases()


def clustering_labels(dev, pts, mask, eps, min_samples, ncx, ncy,
                      cap) -> tuple:
    """A case's clustering on the card up to its tail, through the column
    kernels: (the final labels (N,) int32 in stream order, point_stream
    (N,) int32, the placed points)."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    t = ccl.build_table(torch.from_numpy(pts).to(dev),
                        torch.from_numpy(mask).to(dev), eps, ncx, ncy, cap)
    nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
    core = (t.stream_slot >= 0) & (C.column_counts(*nb) >= min_samples)
    labels = torch.where(core, t.order, C.INT_MAX)
    C.propagate(t.table, t.stream_slot, t.point_stream, t.py, t.cap, eps,
                labels, max_sweeps())
    labels = torch.where(core, labels, C.border_min(*nb, labels))
    return labels, t.point_stream, int((t.stream_slot >= 0).sum())


def check_column_case(dev, name, pts, mask, eps, min_samples, ncx, ncy,
                      cap, timed: tuple = ()) -> dict:
    """Every column kernel against its plain version on one case; the
    CUDA-event and graph times and bounds of those named in ``timed``."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
        column_kernel_work)

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
    want_fill = [w.view(torch.int32) if w.dtype == torch.float32 else w
                 for w in C.table_fill_reference(*fill_args)]
    for got, want in zip((tab.view(torch.int32), pst, ss, ov), want_fill):
        same("table_fill", got, want)
    # no read of the device, no allocation by the kernel: a CUDA graph
    # captures the fill, and a replay gives the same table and maps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = C.table_fill(*fill_args)
    graph.replay()
    for got, want in zip((replayed[0].view(torch.int32), *replayed[1:]),
                         want_fill):
        same("table_fill", got, want)
    del graph, replayed, want_fill
    placed = ss >= 0
    n_occ = int(placed.sum())

    nb_args = (tab, ss, cell_start, py, cap, eps)
    counts = C.column_counts(*nb_args)
    same("column_counts", counts, C.column_counts_reference(*nb_args))
    core = placed & (counts >= min_samples)
    labels0 = torch.where(core, order, C.INT_MAX)
    lab = labels0.clone()
    launched = C.propagate(tab, ss, pst, py, cap, eps, lab, bound_sweeps)
    lab_ref = labels0.clone()
    sweeps = C.propagate_reference(tab, ss, pst, py, cap, eps, lab_ref,
                                   bound_sweeps)
    same("propagate", lab, lab_ref)
    require(launched == C.PROPAGATE_LAUNCHES, f"{name}: the propagation made "
            f"{launched} launches, {C.PROPAGATE_LAUNCHES} expected")
    require(sweeps < bound_sweeps, f"{name}: the plain propagation took "
            f"{sweeps} sweeps, the bound is {bound_sweeps}")
    # a read back to the host inside the propagation would fail the capture
    graph_lab = labels0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        C.propagate(tab, ss, pst, py, cap, eps, graph_lab, bound_sweeps)
    graph.replay()
    same("propagate", graph_lab, lab_ref)
    bmin = C.border_min(*nb_args, lab)
    same("border_min", bmin, C.border_min_reference(*nb_args, lab))
    # nor does the scan: a CUDA graph captures both modes, and a replay
    # gives the same values
    for kernel, scan, want in (
            ("column_counts", lambda: C.column_counts(*nb_args), counts),
            ("border_min", lambda: C.border_min(*nb_args, lab), bmin)):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = scan()
        graph.replay()
        same(kernel, replayed, want)
    final = torch.where(core, lab, bmin)
    got = C.table_gather_reference(final, pst, C.INT_MAX)
    n_clusters = int(torch.unique(got[got != C.INT_MAX]).numel())
    dense, n_dense = C.dense_tail(final, pst)
    want_dense, want_n = C.dense_tail_reference(final, pst)
    same("dense_tail", dense, want_dense)
    same("dense_tail", n_dense, want_n)
    require(int(n_dense) == n_clusters, f"{name}: dense_tail counts "
            f"{int(n_dense)} clusters, the labels hold {n_clusters}")
    # no read of the device: a CUDA graph captures the tail, and a replay
    # gives the same ids
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed, replayed_n = C.dense_tail(final, pst)
    graph.replay()
    same("dense_tail", replayed, want_dense)
    same("dense_tail", replayed_n, want_n)
    forward = int((got[got != C.INT_MAX] > torch.arange(
        got.shape[0], device=dev)[got != C.INT_MAX]).sum())
    print(f"columns {name}: {int(mask.sum())} valid points, {n_occ} placed, "
          f"overflow {int(ov)}, {int(core.sum())} core, {n_clusters} "
          f"clusters, {forward} labels above their point's index, "
          f"{launched} propagation launches (the plain version's "
          f"sweeps: {sweeps}); max_abs_err "
          f"{max(errs.values())}")
    if name == "labels pointing forward":
        require(forward >= 20, f"{name}: {forward} labels point forward")

    if name == "full column and one past":
        require(int(ov) == 1, "one point past a full column is overflow")
    if name == "neighbours at exactly eps":
        # points 0, 1 are eps apart (y), 2, 3 too (z); 4, 5 just beyond
        c = C.table_gather_reference(counts, pst, -1)[:6].tolist()
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
        """Slots a walk of the table must read once when it knows a
        column's length only by reading it: in every column next to a column
        with threads, its occupied slots and, unless full, the empty slot
        that ends them."""
        visited = window(threads) > 0
        return int((visited * (occ + 1).clamp_max(cap)).sum())

    pairs = int((occ * win).sum())
    core_pairs = int((core_occ * win).sum())
    scan, core_scan = slots_read(occ), slots_read(core_occ)
    n_changed = int((lab != labels0).sum())
    n, s = pts.shape[0], tab.shape[0]
    # (bytes, operations): each input read once and each output written
    # once, as far as this run's data needs them; 9 operations a pair test
    work = column_kernel_work(n, s, n_occ, ncells, pairs, core_pairs,
                              core_scan, n_changed)
    # the scans' bound for a walk of the table (each column read to its end
    # marker, stream_slot read), as the scan's first design worked: the
    # yardstick that design and this one were compared on
    walked = {"column_counts": (4 * n + 16 * scan + 4 * n, 9 * pairs),
              "border_min": (4 * n + 16 * scan + 4 * n_occ + 4 * n,
                             9 * pairs)}
    print(f"columns {name}: {pairs} pair tests per neighbourhood pass, "
          f"{core_pairs} from core points; {n_occ} occupied slots, {scan} "
          f"slots and end markers walked, {core_scan} by core points; "
          f"{n_changed} labels changed")
    calls = {
        "table_fill": (lambda: C.table_fill(*fill_args),
                       lambda: C.table_fill_reference(*fill_args)),
        "dense_tail": (lambda: C.dense_tail(final, pst),
                       lambda: C.dense_tail_reference(final, pst)),
        "column_counts": (lambda: C.column_counts(*nb_args),
                          lambda: C.column_counts_reference(*nb_args)),
        "border_min": (lambda: C.border_min(*nb_args, lab),
                       lambda: C.border_min_reference(*nb_args, lab)),
        # a fresh copy of the labels each call (a propagation over labels
        # at their fixpoint would find equal keys): 0.01 ms at 1M points
        "propagate": (
            lambda: C.propagate(tab, ss, pst, py, cap, eps, labels0.clone(),
                                bound_sweeps),
            lambda: C.propagate_reference(tab, ss, pst, py, cap, eps,
                                          labels0.clone(), bound_sweeps)),
    }
    times = {}
    for kernel in timed:
        fast, plain = calls[kernel]
        ms, dev_ms = cuda_ms(fast), graph_ms(fast)
        plain_ms = cuda_ms(plain, iters=5)
        b_ms, b_by = bound(*work[kernel])
        times[kernel] = {"ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": b_ms, "bound_by": b_by}
        print(f"{kernel} at the {name}: kernel {ms:.6f} ms, {dev_ms:.6f} ms "
              f"from a CUDA graph, plain {plain_ms:.6f} ms, bound "
              f"{b_ms:.6f} ms ({b_by})")
        if kernel in walked:
            w_ms, w_by = bound(*walked[kernel])
            times[kernel]["walked_bound_ms"] = w_ms
            print(f"{kernel} at the {name}: bound of a walk to each "
                  f"column's end marker {w_ms:.6f} ms ({w_by})")
    # each wrapper launches its kernels and nothing else (memsets left out)
    for kernel, fn, want in (
            ("table_fill", calls["table_fill"][0], 1),
            ("dense_tail", calls["dense_tail"][0], C.TAIL_LAUNCHES)):
        if kernel in timed:
            seen = device_kernels(fn)
            print(f"{kernel} at the {name}: {sum(seen.values())} kernels a "
                  f"call: {seen}")
            require(all(kernel in k for k in seen)
                    and sum(seen.values()) == want,
                    f"{kernel} launches {want} kernels a call and nothing "
                    f"else, its captured graph holds {seen}")
    return {"errs": errs, "times": times}


def run_tail_label_checks(dev) -> int:
    """``dense_tail`` against its plain version on
    ``synthetic.dense_tail_label_cases`` (labels fed as they are); the
    largest error."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        dense_tail_label_cases)
    worst = 0
    for name, labels, stream in dense_tail_label_cases():
        lab = torch.from_numpy(labels).to(dev)
        pst = torch.from_numpy(stream).to(dev)
        got, got_n = C.dense_tail(lab, pst)
        want, want_n = C.dense_tail_reference(lab, pst)
        torch.cuda.synchronize()
        err = max(int_err(got, want), int_err(got_n, want_n))
        worst = max(worst, err)
        print(f"dense_tail labels {name}: {int(want_n)} representatives, "
              f"plan {C.dense_tail_plan(len(labels))}"
              f", max_abs_err {err}")
        require(torch.equal(got, want) and torch.equal(got_n, want_n),
                f"dense_tail differs from its plain version: {name}")
    return worst


def run_column_checks(dev) -> dict:
    """Every case; the times of the three scans' and the sequence frame's,
    the 1M-point scan's as the record."""
    errs = {k: 0 for k in COLUMN_KERNELS}
    times = {}
    scans = {name for _, name in COLUMN_SCANS} | {SEQUENCE_FRAME}
    for name, *args in column_cases():
        res = check_column_case(dev, name, *args,
                                timed=COLUMN_KERNELS if name in scans else ())
        for k, e in res["errs"].items():
            errs[k] = max(errs[k], e)
        if "times" in res:
            times[name] = res["times"]
    errs["dense_tail"] = max(errs["dense_tail"], run_tail_label_checks(dev))
    for kernel in COLUMN_KERNELS:
        print(f"{kernel}, ms / graph ms / bound ms: " + "; ".join(
            f"{name} {t[kernel]['ms']:.6f} / {t[kernel]['graph_ms']:.6f} / "
            f"{t[kernel]['bound_ms']:.6f}" for name, t in times.items()))
        if "walked_bound_ms" in times["1M scan"][kernel]:
            print(f"{kernel}, walked bound ms: " + "; ".join(
                f"{name} {t[kernel]['walked_bound_ms']:.6f}"
                for name, t in times.items()))
    record = {k: {f: v for f, v in t.items() if f != "walked_bound_ms"}
              for k, t in times["1M scan"].items()}
    return {"errs": errs, "times": record}


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

def place_inputs(points, labels, k: int) -> tuple:
    """What the centroid pack hands to ``place_dense`` for a clustering:
    (ids (N,) int32, valid (N,) bool, channels (C, N) float32)."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import clustering
    seg = torch.where(labels >= 0, labels.to(torch.int64), k).clamp_max(k)
    return clustering._segment_end_rows(points, seg, k)


def place_needed_bytes(ids, valid, nch: int, kp: int) -> int:
    """The bytes any ``place_dense`` must move: ``valid`` once, one 32-byte
    sector for each distinct sector of ``ids`` and of each channel row that
    holds a valid row, and the (C + 1, K') result once."""
    import torch
    n = ids.shape[0]
    rows = valid.nonzero()[:, 0]
    # ids, then channel c at element c * n of the (C, N) channels; sorted
    # rows give sorted sectors
    starts = [0] + [c * n for c in range(nch)]
    sectors = sum(int(torch.unique_consecutive((s + rows) // 8).numel())
                  for s in starts)
    return n + 32 * sectors + 4 * (nch + 1) * kp


def scan_3m_inputs(pipe) -> tuple:
    """The 3,000,000-point scan's clustering on the card and what its
    centroid pack hands to ``place_dense``: (ids, valid, channels, k)."""
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    out = pipe.analyze(scaled_venue(3_000_000))
    pro, k = out["processed"], out["people"].mask.shape[0]
    return (*place_inputs(pro.points, pro.labels, k), k)


def run_place_checks(dev, points, labels, k: int) -> dict:
    """``place_dense`` against its plain version, bit for bit: the centroid
    pack of a scan's own clustering (``points`` (N, 3), ``labels`` (N,) on
    the card, ``k`` people slots), then the edge cases, with
    ``synthetic.place_dense_cases`` (a run of 1,000,000 invalid rows,
    whose time from a CUDA graph must stay within 1.5x of the short-run
    stream of the same n; valid rows first and last in runs that cross
    every tile; n = 0; C = 1 and 9). Times and bound at the scan's
    stream; ``library_ms`` is one ``index_copy_`` into a (C + 1, K' + 1)
    buffer with a spill slot for the invalid rows."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        place_dense_cases)

    ids, valid, chans = place_inputs(points, labels, k)
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
    ] + [(name, tuple(torch.from_numpy(x).to(dev) for x in arrays), kk)
         for name, *arrays, kk in place_dense_cases()]
    # the long run and the short runs of the same n, timed together
    timed = {name for name, *_ in cases[4:6]}
    max_err, runs = 0.0, {}
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
        if name in timed:
            runs[name] = graph_ms(lambda: place.place_dense(*args, kk))
    (long_name, long_ms), (short_name, short_ms) = runs.items()
    print(f"place_dense, {long_name}: {long_ms:.6f} ms from a CUDA graph; "
          f"{short_name}: {short_ms:.6f} ms ({long_ms / short_ms:.3f}x)")
    require(long_ms <= 1.5 * short_ms, "place_dense's time grows with the "
            "length of a run")

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
    dev_ms = graph_ms(lambda: place.place_dense(ids, valid, chans, k))
    # valid read once, a 32-byte sector for each value of ids and of the
    # channels at a valid row, the (C + 1, K') result written once; no
    # arithmetic
    b_ms, b_by = bound(place_needed_bytes(ids, valid, nch, kp), 0)
    print(f"place_dense at the 3M scan's stream ({n} rows, {n_valid} valid, "
          f"{nch} channels, K' {kp}): kernel {ms:.6f} ms, {dev_ms:.6f} ms "
          f"from a CUDA graph, plain {plain:.6f} ms, index_copy_ "
          f"{lib_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    # the bound of the first design's yardstick: ids and valid whole, 4
    # bytes a channel value at a valid row
    print(f"place_dense at the 3M scan's stream, the bound that counts ids "
          f"whole and 4 bytes a channel value: "
          f"{bound(5 * n + 4 * nch * n_valid + 4 * (nch + 1) * kp, 0)[0]:.6f}"
          f" ms")
    return {"max_abs_err": max_err, "ms": ms, "graph_ms": dev_ms,
            "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


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
    """Both ``fps`` entries against the plain version, indices bit-equal,
    on every route of the launch plan and at the edges of every register
    instantiation. ``layer_points`` (100,000, 3) float32 on the card: the
    set-abstraction layer's cloud. Times: ``fps_single`` at that layer
    (4,096 samples, the cluster route) and past a cluster's capacity
    (120,000 -> 256, the streaming route); ``fps_batched`` at the four
    launches of a CrowdNet forward (served: 1 x 4,096 -> 512 and 1 x 512
    -> 128; default width: 4 x 8,192 -> 1,024 and 4 x 1,024 -> 256)."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        kernels, pointnet as P)

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

    def on_route(route, fn):
        """``fn()``, which must launch fps once, on ``route``."""
        kernels.reset_launch_counts()
        out = fn()
        require(kernels.FPS_ROUTES[route] == 1
                and sum(kernels.FPS_ROUTES.values()) == 1,
                f"fps took {kernels.FPS_ROUTES}, {route} expected")
        return out

    n_layer = layer_points.shape[0]
    plan = P.fps_plan(n_layer)
    active = P.max_active_clusters(plan)
    print(f"fps launch plan at {n_layer} points: {plan.route}, a cluster of "
          f"{plan.cluster} blocks of {plan.per_block} points, "
          f"{plan.smem_bytes} bytes of shared memory a block; "
          f"cudaOccupancyMaxActiveClusters {active}")
    ones = torch.ones(n_layer, dtype=torch.bool, device=dev)
    got = on_route("cluster", lambda: P.fps_single(layer_points, ones, 4096))
    want = P.fps_reference(layer_points, ones, 4096)
    same("fps_single", f"{n_layer} -> 4096", got, want)
    require(got.unique().numel() == 4096, "4,096 distinct samples")

    pts, mask, _, _ = venue_batch(4, 8192)
    bp, bm = dev_t(pts), dev_t(mask)
    got = on_route("registers", lambda: P.fps_batched(bp, bm, 1024))
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

    # the register route: both sides of every instantiation's capacity
    # (the last one's far side is the shared-memory body), a start owned by
    # the last thread, small and odd sizes
    rng = np.random.RandomState(3)
    sizes = [1, 31, 33, 100]
    for threads, per_thread in P.REGISTER_SHAPES:
        sizes += [threads * per_thread, threads * per_thread + 1]
    for n in sizes:
        rp = P.fps_plan(n)
        cloud = dev_t(rng.uniform(-20, 20, (2, n, 3)).astype(np.float32))
        valid = dev_t(rng.rand(2, n) > 0.25)
        m = min(n, 64) + 3
        # the last thread owns indices threads - 1 + j * threads
        start = min(rp.threads - 1, n - 1)
        got = on_route(rp.route, lambda: P.fps_batched(cloud, valid, m,
                                                       start))
        same("fps_batched", f"2 x {n} -> {m}, start {start} ({rp.route}, "
             f"{rp.threads} threads x {rp.per_thread})", got,
             P.fps_reference(cloud, valid, m, start))
    cloud = dev_t(rng.uniform(-20, 20, (1, 512, 3)).astype(np.float32))
    none = torch.zeros(1, 512, dtype=torch.bool, device=dev)
    same("fps_batched", "512, every point masked (one warp)",
         on_route("registers", lambda: P.fps_batched(cloud, none, 16)),
         P.fps_reference(cloud, none, 16))
    i, j = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
    small = dev_t(np.stack([i.ravel(), j.ravel(), np.zeros(512)], 1)
                  .astype(np.float32))[None]
    sm1 = torch.ones(1, 512, dtype=torch.bool, device=dev)
    require(P.fps_plan(512).threads == 32, "512 points take one warp")
    same("fps_batched", "16 x 32 lattice (exact ties, one warp)",
         on_route("registers", lambda: P.fps_batched(small, sm1, 256)),
         P.fps_reference(small, sm1, 256))
    # the shared-memory body between the register body and the cluster
    for n in (13_000, 13_643):
        got = on_route("block", lambda: P.fps_single(
            layer_points[:n].contiguous(), ones[:n], 256, start_index=n - 1))
        same("fps_single", f"{n} -> 256 (shared memory)", got,
             P.fps_reference(layer_points[:n], ones[:n], 256, n - 1))

    # the cluster route: its first size (2 blocks), 2 and 5 blocks
    for n in (13_644, 20_000, 60_000):
        got = on_route("cluster", lambda: P.fps_single(
            layer_points[:n].contiguous(), ones[:n], 256))
        same("fps_single", f"{n} -> 256 (a cluster of "
             f"{P.fps_plan(n).cluster})", got,
             P.fps_reference(layer_points[:n], ones[:n], 256))
    p60, plan60 = layer_points[:60_000].contiguous(), P.fps_plan(60_000)
    last_lo = (plan60.cluster - 1) * plan60.per_block
    start = last_lo + 123
    same("fps_single", f"60000 -> 512, start {start} in the last block's "
         f"slice", P.fps_single(p60, ones[:60_000], 512, start_index=start),
         P.fps_reference(p60, ones[:60_000], 512, start_index=start))
    few = torch.zeros(60_000, dtype=torch.bool, device=dev)
    few[dev_t(np.random.RandomState(2).choice(60_000, 100,
                                              replace=False))] = True
    got = P.fps_single(p60, few, 256, start_index=7)
    same("fps_single", "60000, 100 valid points, 256 samples, start 7", got,
         P.fps_reference(p60, few, 256, start_index=7))
    require(got[1:].unique().numel() == 100, "the indices repeat")
    none = torch.zeros_like(few)
    same("fps_single", "60000, every point masked",
         P.fps_single(p60, none, 16), P.fps_reference(p60, none, 16))
    # 251 x 251: five slices of 12,601 points, each boundary inside a row
    i, j = np.meshgrid(np.arange(251), np.arange(251), indexing="ij")
    big_lattice = dev_t(np.stack([i.ravel(), j.ravel(), np.zeros(251 * 251)],
                                 1).astype(np.float32))
    blm = torch.ones(251 * 251, dtype=torch.bool, device=dev)
    require(P.fps_plan(251 * 251).per_block % 251 != 0,
            "the lattice's slice boundaries must fall inside rows")
    same("fps_single", "251 x 251 lattice (exact ties across slices)",
         on_route("cluster", lambda: P.fps_single(big_lattice, blm, 1024)),
         P.fps_reference(big_lattice, blm, 1024))
    two = torch.stack([p60, layer_points[40_000:].contiguous()])
    two_mask = torch.stack([ones[:60_000], ones[:60_000]])
    two_mask[1, 50_000:] = False
    same("fps_batched", "2 x 60000 -> 256 (a cluster each)",
         on_route("cluster", lambda: P.fps_batched(two, two_mask, 256)),
         P.fps_reference(two, two_mask, 256))
    # past a cluster's capacity: one block streaming from L2
    n_big = 120_000
    big = dev_t(scaled_venue(n_big)[:, :3].astype(np.float32))
    big_ones = torch.ones(n_big, dtype=torch.bool, device=dev)
    same("fps_single", f"{n_big} -> 256 (streaming)",
         on_route("stream", lambda: P.fps_single(big, big_ones, 256)),
         P.fps_reference(big, big_ones, 256))

    def fps_bound(b, n, m):
        # points and mask read once, indices written once; per point and
        # step 3 subtractions, 3 products, 2 sums and a minimum
        return bound(b * (13 * n + 4 * m), 9.0 * b * n * (m - 1))

    out = {}
    ms = cuda_ms(lambda: P.fps_single(layer_points, ones, 4096), iters=3,
                 warm=1)
    dev_ms = graph_ms(lambda: P.fps_single(layer_points, ones, 4096),
                      iters=2, reps=1)
    plain = cuda_ms(lambda: P.fps_reference(layer_points, ones, 4096),
                    iters=1, warm=1)
    b_ms, b_by = fps_bound(1, n_layer, 4096)
    print(f"fps_single {n_layer} -> 4096 (a cluster of {plan.cluster}): "
          f"kernel {ms:.6f} ms, {dev_ms:.6f} ms from a CUDA graph, plain "
          f"{plain:.6f} ms, bound {b_ms:.6f} ms ({b_by}); the 4,095 steps "
          f"depend on each other, {ms / 4095 * 1e3:.3f} us a step")
    out["fps_single"] = {"max_abs_err": errs["fps_single"], "ms": ms,
                         "graph_ms": dev_ms, "plain_ms": plain,
                         "bound_ms": b_ms, "bound_by": b_by}
    ms = cuda_ms(lambda: P.fps_single(big, big_ones, 256), iters=3, warm=1)
    print(f"fps_single {n_big} -> 256 (streaming): kernel {ms:.6f} ms, "
          f"{ms / 255 * 1e3:.3f} us a step")

    # the launches of a forward: served, SA1 samples 512 of the 4,096
    # padded points and SA2 128 of those 512 centroids; default width, 1,024
    # of 8,192 and 256 of 1,024 on a batch of 4
    served = []
    for b, n, m in ((1, 4096, 512), (1, 512, 128), (4, 8192, 1024),
                    (4, 1024, 256)):
        sp, sm = bp[:b, :n].contiguous(), bm[:b, :n].contiguous()
        fp = P.fps_plan(n)
        ms = cuda_ms(lambda: P.fps_batched(sp, sm, m))
        dev_ms = graph_ms(lambda: P.fps_batched(sp, sm, m))
        plain = cuda_ms(lambda: P.fps_reference(sp, sm, m), iters=2, warm=1)
        b_ms, b_by = fps_bound(b, n, m)
        print(f"fps_batched {b} x {n} -> {m} ({fp.route}, "
              f"{fp.threads} threads x {fp.per_thread}): kernel "
              f"{ms:.6f} ms, {dev_ms:.6f} ms from a CUDA graph, plain "
              f"{plain:.6f} ms, bound {b_ms:.6f} ms ({b_by}); "
              f"{ms / (m - 1) * 1e3:.3f} us a step")
        if b == 1:
            served.append((ms, dev_ms, plain, b_ms, b_by))
    # per launch, the mean over a served forward's two launches, so that
    # launches x (ms - bound_ms) is the forward's loss
    out["fps_batched"] = {"max_abs_err": errs["fps_batched"],
                          **served_mean(served)}
    return out


def served_mean(served) -> dict:
    """A kernel's record from (ms, graph ms, plain ms, bound ms, bound by)
    at a served forward's two launch shapes: the mean of each time."""
    return {key: statistics.mean(s[i] for s in served) for i, key in
            enumerate(("ms", "graph_ms", "plain_ms", "bound_ms"))} | {
                "bound_by": served[0][4]}


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
    multiple of the tile; then ``synthetic.sa_mlp_pool_cases`` (K 16, 48
    and 128, M = 1, Cin = 67, a centroid with only its last neighbour
    valid), each run twice, bit-identical. Times and bounds at the served
    model's two shapes, whose mean is the kernel's record, and at the
    100,000-point layer."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        sa_mlp_pool_cases)

    require(not torch.backends.cuda.matmul.allow_tf32,
            "the plain version's products must run in full float32")
    rng = np.random.RandomState(9)
    seen = {torch.float32: 0.0, torch.bfloat16: 0.0}
    abs_err = 0.0
    timed = {}
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
        timed[name] = (g, v, w, m, cin, hidden)
    for name, g_np, v_np, w_np in sa_mlp_pool_cases():
        g, v = torch.from_numpy(g_np).to(dev), torch.from_numpy(v_np).to(dev)
        w = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
             for a, b in w_np]
        m = g.shape[0]
        for dtype, tol in ((torch.float32, SA_F32_TOL),
                           (torch.bfloat16, SA_BF16_TOL)):
            got = P.sa_mlp_pool(g, v, w, compute_dtype=dtype)
            again = P.sa_mlp_pool(g, v, w, compute_dtype=dtype)
            want = P.sa_mlp_pool_reference(g, v, w, dtype)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            seen[dtype] = max(seen[dtype], err)
            if dtype == torch.float32:
                abs_err = max(abs_err, float((got - want).abs().max()))
            plan = P.sa_plan(*g.shape, *(a.shape[1] for a, _ in w))
            print(f"sa_mlp_pool {name} ({tuple(g.shape)} -> "
                  f"{w[2][0].shape[1]}, {plan.tile} a tile, "
                  f"{str(dtype).split('.')[1]}): max relative error "
                  f"{err:.3e} (tolerance {tol})")
            require(got.shape == want.shape and err <= tol,
                    f"sa_mlp_pool off by {err}: {name}, {dtype}")
            require(torch.equal(got, again),
                    f"sa_mlp_pool: two runs differ: {name}, {dtype}")
            require(m == 1 or not got[m // 2].any(),
                    "a centroid with no valid neighbour pools to 0")
            require(bool(want[0].any()) and rel_err(got[0], want[0]) <= tol,
                    f"{name}: the centroid with only its last neighbour "
                    f"valid")
    print(f"sa_mlp_pool: worst relative error seen {seen[torch.float32]:.3e} "
          f"in float32, {seen[torch.bfloat16]:.3e} with bfloat16 operands")

    served = []
    for name, dtypes in (("served SA1", (torch.float32,)),
                         ("served SA2", (torch.float32,)),
                         ("100,000-point layer",
                          (torch.bfloat16, torch.float32))):
        g, v, w, m, cin, hidden = timed[name]
        dims = [cin] + list(hidden)
        ops = 2.0 * m * 32 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nbytes = (g.numel() * 4 + v.numel() + m * hidden[-1] * 4
                  + sum(wi.numel() * 4 + bi.numel() * 4 for wi, bi in w))
        for dtype in dtypes:
            peak = BF16_OPS_PER_S if dtype == torch.bfloat16 \
                else FP32_OPS_PER_S
            ms = cuda_ms(lambda: P.sa_mlp_pool(g, v, w, compute_dtype=dtype))
            dev_ms = graph_ms(lambda: P.sa_mlp_pool(g, v, w,
                                                    compute_dtype=dtype))
            plain = cuda_ms(lambda: P.sa_mlp_pool_reference(g, v, w, dtype),
                            iters=5)
            b_ms, b_by = bound(nbytes, ops, peak)
            print(f"sa_mlp_pool at the {name} ({m} x 32 x {cin} -> "
                  f"{hidden[-1]}, {str(dtype).split('.')[1]}): kernel "
                  f"{ms:.6f} ms, {dev_ms:.6f} ms from a CUDA graph, plain "
                  f"{plain:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
            if name.startswith("served"):
                served.append((ms, dev_ms, plain, b_ms, b_by))
    # float32, what the served model runs; per launch, the mean over a
    # served forward's two launches
    return {"max_abs_err": abs_err, **served_mean(served)}


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


def require_register_route(what: str) -> None:
    """Both ``fps_batched`` launches of the run just traced took the
    register body."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    routes = {k: v for k, v in kernels.FPS_ROUTES.items() if v}
    print(f"{what}: fps routes {routes}")
    require(routes == {"registers": 2},
            f"{what}: fps_batched must take the register route twice, "
            f"took {routes}")


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
    require_register_route("the served forward")
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
    grid 64) on a batch of 4, weights drawn from generator seed 11: the
    card against the port's CPU run."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import train

    cfg = train.TrainConfig()
    cpu_model = train.make_model(cfg, torch.Generator().manual_seed(11)
                                 ).eval()
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
    require_register_route("the default model's forward")
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
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        kernels, pointnet as P)
    from lidar_ai_recommendation_software_tpu_torch.ops.grouping import (
        ball_group, group_features)

    def layer(p, dtype):
        mask = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        w = layer_weights(p.device)
        idx = P.fps_single(p, mask, LAYER_SAMPLES)
        cents = p[idx.to(torch.int64)]
        gidx, gvalid = ball_group(cents, mask[idx.to(torch.int64)], p, mask,
                                  LAYER_R, LAYER_K)
        g = group_features(p, None, cents, gidx, gvalid)
        return idx, gidx, gvalid, P.sa_mlp_pool(g, gvalid, w,
                                                compute_dtype=dtype)

    got, launches = traced(lambda: layer(layer_points, torch.bfloat16),
                           "100,000-point layer")
    require(launches["fps_single"] == 1 and launches["sa_mlp_pool"] == 1,
            f"launches of the layer: {launches}")
    require(kernels.FPS_ROUTES["cluster"] == 1,
            f"the layer's fps must take the cluster route: "
            f"{kernels.FPS_ROUTES}")
    t0 = time.perf_counter()
    cpu_points = layer_points.cpu()
    want = layer(cpu_points, torch.bfloat16)
    print(f"the port's CPU run of the layer took "
          f"{time.perf_counter() - t0:.3f} s")
    for name, a, b in zip(("FPS indices", "neighbour indices", "validity"),
                          got, want):
        require(torch.equal(a.cpu(), b), f"layer: {name} differ, card vs CPU")
    err = rel_err(got[3].cpu(), want[3])
    require(got[3].shape == (LAYER_SAMPLES, 64) and err <= SA_BF16_TOL,
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


def train_steps(cfg, device: str, steps: int) -> tuple:
    """``steps`` of ``train.train_step`` from ``init_state(cfg)`` on
    ``device``, on ``make_batch(RandomState(cfg.seed))``'s batches, the
    launch counts set to 0 just before each step and read just after:
    (state, losses, the first step's gradients on the CPU, [(launches, fps
    routes)] a step)."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch.models import train
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    state = train.init_state(cfg, device=device)
    rng = np.random.RandomState(cfg.seed)
    losses, grads, launches = [], None, []
    for i in range(steps):
        batch = train.batch_tensors(train.make_batch(rng, cfg), device)
        kernels.reset_launch_counts()
        metrics = train.train_step(state, batch, cfg)
        losses.append(float(metrics["loss"]))  # waits for the step
        launches.append((dict(kernels.LAUNCHES), dict(kernels.FPS_ROUTES)))
        if i == 0:
            grads = {n: p.grad.detach().cpu()
                     for n, p in state.model.named_parameters()}
    return state, losses, grads, launches


def require_step_launches(launches, per_step: int, what: str) -> None:
    """Every step launched ``fps_batched`` and ``sa_mlp_pool``
    ``per_step`` times each, ``fps_batched`` on the register route, and no
    other kernel."""
    for i, (counts, routes) in enumerate(launches):
        used = {k: v for k, v in counts.items() if v}
        require(used == {"fps_batched": per_step, "sa_mlp_pool": per_step}
                and {k: v for k, v in routes.items() if v}
                == {"registers": per_step},
                f"{what}, step {i + 1}: launches {used}, fps routes "
                f"{routes}; {per_step} fps_batched on the register route "
                f"and {per_step} sa_mlp_pool expected")
    print(f"{what}: fps_batched {per_step} (register route) and sa_mlp_pool "
          f"{per_step} launches in each of {len(launches)} steps")


def grad_errors(got: dict, want: dict) -> dict:
    """|got - want| / |want| of each gradient tensor."""
    return {n: float((got[n] - want[n]).norm() / want[n].norm().clamp_min(
        1e-30)) for n in want}


def busy_share(fn, reps: int = 3) -> tuple:
    """(wall ms, device busy ms) a call of ``fn`` over ``reps`` warm calls
    under ``torch.profiler``: busy is the sum of the kernels' and copies'
    times (user annotations, such as ``Optimizer.step``'s, also appear on
    the device's timeline and are left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))
    return wall, busy / 1e3 / reps


def train_step_split(state, batch, cfg, reps: int = 5) -> dict:
    """Median ms of a training step's forward (``train.step_loss``),
    backward and optimizer update (``train.apply_update``) over ``reps``
    warm steps, the device synchronised after each."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import train
    runs = {"forward": [], "backward": [], "optimizer": []}
    for rep in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = train.step_loss(state, batch, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        train.apply_update(state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if rep:
            for key, a, b in (("forward", t0, t1), ("backward", t1, t2),
                              ("optimizer", t2, t3)):
                runs[key].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in runs.items()}


def require_prefix_reproducible(cfg) -> None:
    """The BEV head's cell sums scan one lone row (the pillar z sums) in
    float64: ``_row_prefix_sums`` of that row, from the first training
    batch, bit-identical over ``PREFIX_RERUNS`` reruns on the card.
    ``torch.cumsum``'s count of differing reruns on the same row is
    printed beside it."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import (
        crowdnet, train)
    batch = train.batch_tensors(train.make_batch(
        np.random.RandomState(cfg.seed), cfg), "cuda")
    row = (batch["points"][..., 2] * batch["mask"].to(torch.float32)
           ).reshape(1, -1).to(torch.float64)
    counts = {}
    for name, fn in (("_row_prefix_sums", crowdnet._row_prefix_sums),
                     ("torch.cumsum", lambda x: torch.cumsum(x, 1))):
        first = fn(row)
        counts[name] = sum(int(not torch.equal(fn(row), first))
                           for _ in range(PREFIX_RERUNS))
    print(f"float64 prefix of the pillar sums' lone row {tuple(row.shape)}, "
          f"reruns differing from the first in {PREFIX_RERUNS}: "
          f"_row_prefix_sums {counts['_row_prefix_sums']}, torch.cumsum "
          f"{counts['torch.cumsum']}")
    require(counts["_row_prefix_sums"] == 0,
            "training: the cell sums' prefix scan differs between reruns")


def run_training(ident: str) -> dict:
    """CrowdNet's training at the default width (``TrainConfig()``: batch
    4 x 8,192 points, 1,024 and 256 samples, grid 64, float32) from the
    seeded ``init_state``: 3 steps on the card and on the port's CPU,
    against each other, five more card runs (bit-identical, after the
    cell sums' prefix scan is held bit-identical over reruns) and the JAX
    package's recorded losses; one bfloat16 step and one remat step; warm step times. Returns
    the launch counts of one step."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import train
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)

    cfg = train.TrainConfig()
    digest = train.weights_digest(
        train.init_state(cfg, device="cuda").model.state_dict())
    require(digest == JAX_REFERENCE_TRAIN["init_sha256"],
            f"init_state's weights (sha256 {digest}) are not those the JAX "
            f"package's losses were recorded from")
    print(f"TrainConfig(): batch {cfg.batch_size} x {cfg.n_points:,} "
          f"points, {cfg.sa1_samples} and {cfg.sa2_samples} samples, grid "
          f"{cfg.grid}, lr {cfg.learning_rate}, bf16 {cfg.bf16}")
    # the backward recomputes through sa_mlp_pool_reference (no backward
    # kernel, as in the JAX package): count its calls inside and outside
    # the backward apart
    calls = {"forward": 0, "backward": 0}
    in_backward = []
    backward, reference = P._SaMlpPool.backward, P.sa_mlp_pool_reference

    def counted_backward(ctx, ct):
        in_backward.append(True)
        try:
            return backward(ctx, ct)
        finally:
            in_backward.pop()

    def counted_reference(*args, **kwargs):
        calls["backward" if in_backward else "forward"] += 1
        return reference(*args, **kwargs)

    with mock.patch.object(P, "fps_reference", wraps=P.fps_reference) as f, \
            mock.patch.object(P, "sa_mlp_pool_reference", counted_reference), \
            mock.patch.object(P._SaMlpPool, "backward",
                              staticmethod(counted_backward)):
        card, losses, grads, launches = train_steps(cfg, "cuda",
                                                    TRAIN_STEPS)
    require(f.call_count == 0 and calls["forward"] == 0,
            f"a plain forward ran on the card: fps_reference "
            f"{f.call_count}, sa_mlp_pool_reference {calls['forward']} "
            f"calls outside the backward")
    require(calls["backward"] == 2 * TRAIN_STEPS,
            f"sa_mlp_pool's backward recomputed {calls['backward']} times "
            f"in {TRAIN_STEPS} steps, {2 * TRAIN_STEPS} expected")
    require_step_launches(launches, 2, "training on the card")
    require(all(math.isfinite(x) for x in losses) and all(
        bool(torch.isfinite(p).all()) for p in card.model.parameters()),
        "training: losses and parameters finite")
    t0 = time.perf_counter()
    cpu, cpu_losses, cpu_grads, _ = train_steps(cfg, "cpu", TRAIN_STEPS)
    print(f"the port's CPU run of {TRAIN_STEPS} steps took "
          f"{time.perf_counter() - t0:.3f} s")
    print(f"losses: card {losses}, CPU {cpu_losses}, JAX package "
          f"(recorded) {JAX_REFERENCE_TRAIN['losses']}")
    first = abs(losses[0] - cpu_losses[0]) / abs(cpu_losses[0])
    require(first <= TRAIN_GRAD_TOL,
            f"training: first loss off by {first:.3e} card vs CPU")
    errs = grad_errors(grads, cpu_grads)
    worst = max(errs, key=errs.get)
    print(f"first-step gradients, card vs CPU: {len(errs)} tensors, worst "
          f"{errs[worst]:.3e} ({worst}), tolerance {TRAIN_GRAD_TOL}; "
          f"largest five: " + ", ".join(
              f"{n} {e:.2e}" for n, e in sorted(
                  errs.items(), key=lambda kv: -kv[1])[:5]))
    require(errs[worst] <= TRAIN_GRAD_TOL,
            f"training: gradient {worst} off by {errs[worst]:.3e}")
    ref = JAX_REFERENCE_TRAIN["grad_norms"]
    norm_errs = {n: abs(float(g.norm()) - ref[n]) / ref[n]
                 for n, g in grads.items()}
    worst = max(norm_errs, key=norm_errs.get)
    print(f"first-step gradient norms against the JAX package's kernel "
          f"path: worst {norm_errs[worst]:.3e} ({worst}), tolerance "
          f"{TRAIN_LOSS_TOL}")
    require(set(ref) == set(grads) and norm_errs[worst] <= TRAIN_LOSS_TOL,
            f"training: gradient norm of {worst} off the JAX package's by "
            f"{norm_errs[worst]:.3e}")
    for name, ref in (("the CPU", cpu_losses),
                      ("the JAX package", JAX_REFERENCE_TRAIN["losses"])):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        print(f"losses within {rel:.3e} relative of {name}'s "
              f"(tolerance {TRAIN_LOSS_TOL})")
        require(rel <= TRAIN_LOSS_TOL, f"training: losses off {name}'s by "
                f"{rel:.3e}")
    atol = 2 * cfg.learning_rate * TRAIN_STEPS
    cpu_params = dict(cpu.model.named_parameters())
    dp = max(float((p.detach().cpu() - cpu_params[n].detach()).abs().max())
             for n, p in card.model.named_parameters())
    print(f"parameters after {TRAIN_STEPS} steps within {dp:.3e} of the CPU "
          f"run's (tolerance {atol:.1e} = 2 lr steps)")
    require(dp <= atol, f"training: parameters off by {dp:.3e}")
    require_prefix_reproducible(cfg)
    for run in range(TRAIN_RERUNS):
        again, again_losses, _, _ = train_steps(cfg, "cuda", TRAIN_STEPS)
        require(again_losses == losses and all(
            torch.equal(p, q) for p, q in zip(card.model.parameters(),
                                              again.model.parameters())),
            f"training: card run {run + 2} differs from the first "
            f"(losses {again_losses})")
    print(f"{TRAIN_RERUNS} more card runs bit-identical to the first: "
          f"losses and every parameter")

    bf_cfg = dataclasses.replace(cfg, bf16=True)
    _, bf_losses, bf_grads, bf_launches = train_steps(bf_cfg, "cuda", 1)
    require_step_launches(bf_launches, 2, "one bfloat16 step on the card")
    _, bf_cpu_losses, bf_cpu_grads, _ = train_steps(bf_cfg, "cpu", 1)
    bf_loss = abs(bf_losses[0] - bf_cpu_losses[0]) / abs(bf_cpu_losses[0])
    bf_errs = grad_errors(bf_grads, bf_cpu_grads)
    bf_worst = max(bf_errs, key=bf_errs.get)
    print(f"bfloat16 step, card vs CPU: loss {bf_losses[0]} vs "
          f"{bf_cpu_losses[0]} ({bf_loss:.3e}, tolerance "
          f"{TRAIN_BF16_LOSS_TOL}); gradients worst {bf_errs[bf_worst]:.3e} "
          f"({bf_worst}, tolerance {TRAIN_BF16_GRAD_TOL})")
    require(bf_loss <= TRAIN_BF16_LOSS_TOL
            and bf_errs[bf_worst] <= TRAIN_BF16_GRAD_TOL,
            "training: the bfloat16 step off the CPU's")
    # the control: the card's float32 first step against the CPU's
    # bfloat16 step on the same weights and batch, the readings of a card
    # that ignored bf16=True
    ctl_loss = abs(losses[0] - bf_cpu_losses[0]) / abs(bf_cpu_losses[0])
    ctl_errs = grad_errors(grads, bf_cpu_grads)
    ctl_worst = max(ctl_errs, key=ctl_errs.get)
    print(f"control, the card's float32 step vs the CPU's bfloat16 step: "
          f"loss {ctl_loss:.3e}, gradients worst {ctl_errs[ctl_worst]:.3e} "
          f"({ctl_worst}), median "
          f"{statistics.median(ctl_errs.values()):.3e}")
    require(ctl_loss > TRAIN_BF16_LOSS_TOL
            and ctl_errs[ctl_worst] > TRAIN_BF16_GRAD_TOL,
            "training: a float32 step passes the bfloat16 step's limits")

    _, re_losses, re_grads, re_launches = train_steps(
        dataclasses.replace(cfg, remat=True), "cuda", 1)
    require_step_launches(re_launches, 4, "one remat step on the card")
    require(re_losses[0] == losses[0] and all(
        torch.equal(re_grads[n], grads[n]) for n in grads),
        "training: the remat step's loss or gradients differ")
    print("remat step: loss and every gradient equal to the plain step's")

    batch = train.batch_tensors(train.make_batch(
        np.random.RandomState(cfg.seed), cfg), "cuda")
    ms = wall_ms(lambda: train.train_step(card, batch, cfg))
    split = train_step_split(card, batch, cfg)
    wall, busy = busy_share(lambda: train.train_step(card, batch, cfg))
    print(f"training step, {cfg.batch_size} x {cfg.n_points:,} points: "
          f"median {ms:.3f} ms of 5 "
          f"(warm, synchronised), {1e3 / ms:.3f} steps/s, "
          f"{cfg.batch_size * 1e3 / ms:.3f} venues/s on {ident}")
    print("training step split (medians of 5, synchronised): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in split.items()))
    print(f"training step under the profiler: wall {wall:.3f} ms, device "
          f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    return launches[0][0]


def layer_weights(dev) -> list:
    """The 100,000-point layer's MLP 3-32-32-64 (numpy seed 0, zero
    biases)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(0)
    dims = [3, 32, 32, 64]
    return [(torch.from_numpy((rng.randn(a, b) * 0.1).astype(np.float32))
             .to(dev), torch.zeros(b, device=dev))
            for a, b in zip(dims[:-1], dims[1:])]


def run_hashgrid(dev, layer_points, ident: str) -> dict:
    """The hash-grid ball query: on the 100,000-point layer asked for by
    name, and on a 1,000,000-point layer through "auto"; the card's
    indices and validity against the port's CPU hash grid on the same
    centroids (the card's FPS), the hash grid timed against the dense
    route at 100,000 points and the whole 1M layer timed. Returns the
    launch counts of one 1M layer."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        kernels, pointnet as P)
    from lidar_ai_recommendation_software_tpu_torch.ops.grouping import (
        BRUTEFORCE_MAX_SOURCE, ball_group, group_features)

    def centroids(p):
        mask = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        idx = P.fps_single(p, mask, LAYER_SAMPLES).to(torch.int64)
        return mask, p[idx], mask[idx]

    def check_on_cpu(p, mask, cents, cmask, got, method, what):
        t0 = time.perf_counter()
        want = ball_group(cents.cpu(), cmask.cpu(), p.cpu(), mask.cpu(),
                          LAYER_R, LAYER_K, method=method)
        for name, a, b in zip(("indices", "validity"), got, want):
            require(torch.equal(a.cpu(), b),
                    f"{what}: hash-grid {name} differ, card vs CPU")
        print(f"{what}: hash-grid indices and validity equal on the card "
              f"and the CPU ({int(got[1].sum())} of {got[1].numel()} slots "
              f"valid; the CPU's query took "
              f"{time.perf_counter() - t0:.3f} s)")

    mask, cents, cmask = centroids(layer_points)
    got = ball_group(cents, cmask, layer_points, mask, LAYER_R, LAYER_K,
                     method="hashgrid")
    check_on_cpu(layer_points, mask, cents, cmask, got, "hashgrid",
                 "100,000-point layer")
    dense = ball_group(cents, cmask, layer_points, mask, LAYER_R, LAYER_K,
                       method="dense")
    fewer = int((got[1].sum(1) != dense[1].sum(1)).sum())
    print(f"100,000-point layer: {fewer} of {LAYER_SAMPLES} centroids count "
          f"other neighbours (up to K) on the hash grid than on the dense "
          f"route (a voxel past its 64-point bucket)")
    for method in ("dense", "hashgrid"):
        ms = wall_ms(lambda: ball_group(cents, cmask, layer_points, mask,
                                        LAYER_R, LAYER_K, method=method))
        print(f"ball_group {method}, 100,000 points, {LAYER_SAMPLES} "
              f"queries: median {ms:.3f} ms of 5 (warm, synchronised) on "
              f"{ident}")

    big = torch.from_numpy(np.ascontiguousarray(
        scaled_venue(1_000_000)[:, :3], dtype=np.float32)).to(dev)
    require(big.shape[0] > BRUTEFORCE_MAX_SOURCE, "the 1M layer's size")
    w = layer_weights(dev)

    def layer():
        m, c, cm = centroids(big)
        gidx, gvalid = ball_group(c, cm, big, m, LAYER_R, LAYER_K)
        g = group_features(big, None, c, gidx, gvalid)
        return m, c, cm, gidx, gvalid, P.sa_mlp_pool(
            g, gvalid, w, compute_dtype=torch.bfloat16)

    out, launches = traced(layer, "1,000,000-point layer")
    routes = {k: v for k, v in kernels.FPS_ROUTES.items() if v}
    require(launches["fps_single"] == 1 and launches["sa_mlp_pool"] == 1
            and routes == {"stream": 1},
            f"the 1M layer: launches {launches}, fps routes {routes}")
    m, c, cm, gidx, gvalid, pooled = out
    # the layer's FPS against its plain version on the card (the CPU's
    # would take minutes at 1M points)
    t0 = time.perf_counter()
    want = P.fps_reference(big, m, LAYER_SAMPLES)
    plain_s = time.perf_counter() - t0
    require(torch.equal(P.fps_single(big, m, LAYER_SAMPLES), want)
            and torch.equal(c, big[want.to(torch.int64)]),
            "the 1M layer: fps_single's samples differ from fps_reference's")
    print(f"1,000,000-point layer: fps_single's {LAYER_SAMPLES} samples "
          f"(streaming route) equal to fps_reference's on the card (the "
          f"plain version took {plain_s:.3f} s)")
    check_on_cpu(big, m, c, cm, (gidx, gvalid), "auto",
                 "1,000,000-point layer")
    g = group_features(big.cpu(), None, c.cpu(), gidx.cpu(), gvalid.cpu())
    want = P.sa_mlp_pool(g, gvalid.cpu(), [(a.cpu(), b.cpu()) for a, b in w],
                         compute_dtype=torch.bfloat16)
    err = rel_err(pooled.cpu(), want)
    require(pooled.shape == (LAYER_SAMPLES, 64) and err <= SA_BF16_TOL
            and bool(torch.isfinite(pooled).all()),
            f"the 1M layer's pooled features off by {err}")
    print(f"1,000,000-point layer: pooled features within {err:.3e} of the "
          f"CPU's on the same groups (tolerance {SA_BF16_TOL})")
    stages = {}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, c, cm = centroids(big)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gidx, gvalid = ball_group(c, cm, big, m, LAYER_R, LAYER_K)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        P.sa_mlp_pool(group_features(big, None, c, gidx, gvalid), gvalid, w,
                      compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, a, b in (("fps_single", t0, t1), ("ball_group", t1, t2),
                        ("group_features + sa_mlp_pool", t2, t3)):
            stages.setdefault(k, []).append((b - a) * 1e3)
    n = big.shape[0]
    fps_ms = statistics.median(stages["fps_single"])
    b_ms, b_by = bound(13 * n + 4 * LAYER_SAMPLES,
                       9.0 * n * (LAYER_SAMPLES - 1))
    print(f"fps_single at {n:,} points (streaming route): {fps_ms:.3f} ms, "
          f"{1e3 * fps_ms / (LAYER_SAMPLES - 1):.3f} us a step, against a "
          f"bound of {b_ms:.6f} ms ({b_by})")
    ms = wall_ms(layer, reps=3)
    print(f"1,000,000-point layer, bfloat16: median {ms:.3f} ms of 3 (warm, "
          f"synchronised) on {ident}; stages (medians of 3): " + ", ".join(
              f"{k} {statistics.median(v):.3f} ms"
              for k, v in stages.items()))
    return launches


def sequence_arrays(out) -> dict:
    """Every output of analyze_sequence as numpy, for bit comparison."""
    seq = out["tracked_people"]
    f = out["flow"]
    return {**host_arrays(out),
            "tracked_mask": seq.mask.cpu().numpy(),
            "tracked_positions": seq.positions.cpu().numpy(),
            "flow_positions": f["flow_vectors"]["positions"]}


def flow_cosine(out, extent: float) -> float:
    """The mean cosine between the measured node vectors (speed above
    0.05 m/s) and the generator's motion toward the exit at (extent, 0)."""
    import numpy as np
    f = out["flow"]
    pos = np.asarray(f["flow_vectors"]["positions"])
    vec = np.asarray(f["flow_vectors"]["vectors"])
    gt = np.stack([extent - pos[:, 0], -pos[:, 1]], 1)
    gt /= np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-9)
    vn = np.linalg.norm(vec, axis=1)
    ok = vn > 0.05
    require(ok.any(), "the sequence's flow has no moving node")
    return float(np.mean(np.sum(vec[ok] / vn[ok, None] * gt[ok], axis=1)))


def sequence_stages(pipe, frames, ident: str) -> None:
    """Where analyze_sequence's time goes: medians of 5 warm, synchronised
    runs on the host clock of the last frame's ``analyze``, each earlier
    frame's ``people_of_cloud`` (upload included), and
    ``temporal_flow_multi`` on the tracked stack; the host's share is the
    whole less those."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import temporal
    from lidar_ai_recommendation_software_tpu_torch.pipeline import (
        people_of_cloud)
    from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

    out = pipe.analyze_sequence(frames, dt=SEQUENCE_DT)
    cfg = pipe.fit_capacity(np.asarray(frames[0], np.float64))
    proc = out["processed"]
    stages = {
        "analyze, last frame": lambda: pipe.analyze(frames[-1]),
        **{f"people_of_cloud, frame {t}": (
            lambda f=f: people_of_cloud(PointCloud.from_numpy(
                np.asarray(f, np.float64), cfg.capacity.max_points,
                device=pipe.device), cfg))
           for t, f in enumerate(frames[:-1])},
        "temporal_flow_multi": lambda: temporal.temporal_flow_multi(
            out["tracked_people"], SEQUENCE_DT, proc.mins[:2],
            proc.maxs[:2], cfg),
        "whole": lambda: pipe.analyze_sequence(frames, dt=SEQUENCE_DT),
    }
    ms = {name: wall_ms(fn) for name, fn in stages.items()}
    ms["host and the rest"] = ms["whole"] - sum(
        v for k, v in ms.items() if k != "whole")
    for name, v in ms.items():
        print(f"analyze_sequence stage {name}: {v:.3f} ms (median of 5, "
              f"warm, synchronised) on {ident}")
    torch.cuda.synchronize()


def run_sequence(pipe, ident: str) -> dict:
    """``BASELINE.md`` config 3 through ``Pipeline.analyze_sequence``: 4
    frames of 100,000 points, every frame clustered on the column grid
    (one clustering a frame), the last frame's density by
    ``radius_count``. The card against the port's CPU run (integers
    exact, floats within FLOAT_TOL), against the JAX package's recorded
    values (avg_speed within 1e-4), the flow's cosine against the
    generator's motion, and a second run bit-identical. Returns the
    launch counts of one run."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    extent, frames = sequence_frames()
    out, launches = traced(
        lambda: pipe.analyze_sequence(frames, dt=SEQUENCE_DT),
        "4 x 100,000-point sequence")
    require(launches["table_fill"] == SEQUENCE_FRAMES,
            f"the sequence made {launches['table_fill']} clusterings, one a "
            f"frame ({SEQUENCE_FRAMES}) expected")
    require_one_pass(launches, "the sequence run")
    require(launches["radius_count"] == 1, f"the last frame's density "
            f"launches radius_count once, got {launches['radius_count']}")
    require(launches["eps_edges"] == 0,
            "the sequence took the all-pairs clustering")
    seq = out["tracked_people"]
    tracked = seq.mask.sum(1).tolist()
    got = {"people": out["density"]["total_people"], "tracked": tracked,
           "avg_speed": out["flow"]["avg_speed"],
           "direction": out["flow"]["dominant_direction"],
           "severities": [b["severity"] for b in out["flow"]["bottlenecks"]]}
    nodes = len(out["flow"]["flow_vectors"]["vectors"])
    print(f"card, sequence: {got}; {nodes} flow nodes, people capacity "
          f"{seq.mask.shape[1]}")
    print(f"JAX package on the CPU (recorded): {JAX_REFERENCE_SEQUENCE}")
    for key, want in JAX_REFERENCE_SEQUENCE.items():
        if key == "avg_speed":
            require(abs(got[key] - want) <= 1e-4, f"sequence: {key} "
                    f"{got[key]} vs {want}")
        else:
            require(got[key] == want, f"sequence: {key} {got[key]} vs "
                    f"{want}")
    cos = flow_cosine(out, extent)
    print(f"flow cosine against the generator's motion: {cos:.6f} (at "
          f"least {SEQUENCE_COSINE})")
    require(cos >= SEQUENCE_COSINE, f"flow cosine {cos}")
    cpu = Pipeline(device="cpu").analyze_sequence(frames, dt=SEQUENCE_DT)
    check_same(sequence_arrays(out), sequence_arrays(cpu), False,
               "sequence, card vs CPU")
    print("card equals the port on the CPU: yes")
    again = pipe.analyze_sequence(frames, dt=SEQUENCE_DT)
    check_same(sequence_arrays(out), sequence_arrays(again), True,
               "second sequence run")
    print("second run bit-identical: yes")
    ms = wall_ms(lambda: pipe.analyze_sequence(frames, dt=SEQUENCE_DT))
    print(f"analyze_sequence, {SEQUENCE_FRAMES} x {SEQUENCE_POINTS:,} "
          f"points: median {ms:.3f} ms of 5 (warm, synchronised) on {ident}; "
          f"{SEQUENCE_FRAMES * SEQUENCE_POINTS / ms * 1e3:.0f} points/s")
    sequence_stages(pipe, frames, ident)
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
    for k in COLUMN_KERNELS:
        require(launches[k] > 0, f"the 3M-point run did not launch {k}")
    require(launches["place_dense"] == 1, f"the 3M-point run launched "
            f"place_dense {launches['place_dense']} times, once expected")
    require_one_pass(launches, "the 3M-point run")
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


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_STAGES = ("cli load", "cli analyze", "cli json", "cli report",
              "cli store")
CLI_RUNS = 3  # runs of the 1M scan's command, for the stages' medians


class _Recorded:
    """The calls of ``owner.name`` (a class's method or a module's
    function) while the block runs, as (args, kwargs, result): how the
    script reads what a run computed, and with what, beyond what it
    prints. A method's instance is its first argument."""

    def __init__(self, owner, name: str):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        original = self.original = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        setattr(self.owner, self.name, wrapper)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)
        return False


def cli_run(argv, what: str, totals: dict) -> tuple:
    """``cli.main(argv)`` in this process, traced (its launches added to
    ``totals``): (stdout, the launch counts). It must exit 0 and print no
    warning of a degraded run."""
    from lidar_ai_recommendation_software_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc, launches = traced(lambda: cli.main(argv), what)
    text = out.getvalue()
    print(f"$ lidar-crowd-torch {' '.join(argv)}")
    print(text.rstrip())
    require(rc == 0, f"{what}: exit code {rc}; stderr {err.getvalue()}")
    require("WARNING" not in err.getvalue(),
            f"{what}: degraded run: {err.getvalue()}")
    for k, v in launches.items():
        totals[k] += v
    return text, launches


def write_pcd_binary(path, points) -> None:
    """A binary PCD file (x, y, z float32 records), as sensors write it."""
    import numpy as np
    n = len(points)
    with open(path, "wb") as f:
        f.write(("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\n"
                 "TYPE F F F\nCOUNT 1 1 1\n"
                 f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                 f"POINTS {n}\nDATA binary\n").encode())
        f.write(np.ascontiguousarray(points, dtype="<f4").tobytes())


def run_cli_scan(big, out_1m, launches_1m, totals, ident: str) -> None:
    """``BASELINE.md`` config 4 from files: the scan written by ``sample``
    and as LAS and binary PCD, read back (the LAS through the native
    parser), then ``analyze scan.las`` with JSON, report and store:
    the JAX package's recorded values, the store equal to the JSON, the
    1M phase's kernels, and the CLI's host stages."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.utils import io as pio
    from lidar_ai_recommendation_software_tpu_torch.utils import native
    from lidar_ai_recommendation_software_tpu_torch.utils import profiling
    from lidar_ai_recommendation_software_tpu_torch.utils.store import (
        ResultsStore)

    cli_run(["sample", "--points", "1000000", "--out", "scan.npy"],
            "sample", totals)
    scan = pio.load_points("scan.npy")
    require(np.array_equal(scan, big), "sample wrote another 1M venue")
    pio.save_points("scan.las", scan)
    write_pcd_binary("scan.pcd", scan)
    require(native.available(), "the native loader did not build")
    las = pio.load_points("scan.las")
    raw = Path("scan.las").read_bytes()
    scale = np.array(struct.unpack_from("<3d", raw, 131))
    offset = struct.unpack_from("<3d", raw, 155)
    via_native = native.parse_las_points(raw, 227, 20, len(scan), scale,
                                         offset)
    require(via_native is not None and np.array_equal(las, via_native),
            "the LAS scan was not parsed by the native library")
    err = np.abs(las - scan).max(0)
    require(bool((err <= scale).all()), f"LAS off by {err} (scale {scale})")
    pcd = pio.load_points("scan.pcd")
    require(np.array_equal(pcd, scan.astype(np.float32).astype(np.float64)),
            "the binary PCD scan differs")
    print(f"scan.npy, scan.las ({len(raw):,} bytes, native parser, within "
          f"{err.max():.3e} of the npy, scale {scale.max():.3e}) and "
          f"scan.pcd (binary, float32-exact) read back")
    info = subprocess.run(
        [sys.executable, "-m", f"{PORT}.cli", "info", "scan.las"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO_ROOT})
    print(info.stdout.rstrip())
    require(info.returncode == 0 and "1,000,000 points" in info.stdout,
            f"cli info in a subprocess: {info.returncode} {info.stderr}")

    argv = ["analyze", "scan.las", "--json", "out.json", "--report",
            "out.html", "--no-figures", "--store", "results.sqlite"]
    stages = {name: [] for name in CLI_STAGES}

    def timed_run(what):
        profiling.reset_timings()
        ran = cli_run(argv, what, totals)
        timed = profiling.timings()
        for name in CLI_STAGES:
            stages[name].append(timed[name]["last_ms"])
        return ran

    with _Recorded(Pipeline, "analyze") as calls:
        _, launches = timed_run("CLI 1M scan")
    out = calls[0][2]
    got = json.load(open("out.json"))
    check_jax_reference({"density": got["density"], "flow": got["flow"],
                         "processed": out["processed"]},
                        JAX_REFERENCE_1M, "CLI, 1M scan from LAS (JSON)")
    speed_err = abs(got["flow"]["avg_speed"] - out_1m["flow"]["avg_speed"])
    require(speed_err <= FLOAT_TOL, f"CLI 1M avg_speed off by {speed_err}")
    store = ResultsStore("results.sqlite")
    rows = {"density": store.get_density_results(1),
            "flow": store.get_flow_results(1),
            "recommendations": store.get_recommendations(1)}
    require(rows == got, "the stored results differ from the JSON")
    require(len(store.list_reports()) == 1, "the report was not stored")
    store.close()
    print("store (read back by ResultsStore) equals the JSON: yes")
    used = {k: v for k, v in launches.items() if v}
    want = {k: v for k, v in launches_1m.items() if v}
    require(used == want, f"the CLI's 1M run launched {used}, "
            f"Pipeline.analyze {want}")
    require(all(launches[k] > 0 for k in COLUMN_KERNELS),
            "the CLI's 1M run missed a column kernel")
    print(f"kernels of the CLI's 1M run equal those of Pipeline.analyze: "
          f"{used}")
    for _ in range(CLI_RUNS - 1):
        timed_run("CLI 1M scan, again")
    for name, ms in stages.items():
        require(len(ms) == CLI_RUNS, f"stage {name}: {len(ms)} timings")
        print(f"CLI host stage {name}: median {statistics.median(ms):.3f} "
              f"ms of {CLI_RUNS} ({', '.join(f'{v:.3f}' for v in ms)}) on "
              f"{ident}")


def check_fallback_raises_kernel_faults() -> None:
    """``analyze --fallback-cpu`` on the card, its pipeline failing as a
    kernel that does not launch would: the card answers the health probe,
    so the failure is raised and nothing is computed on the CPU."""
    from unittest import mock

    from lidar_ai_recommendation_software_tpu_torch import cli
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    fault = RuntimeError("simulated kernel launch failure")
    on_card = Pipeline.analyze_device

    def fails_on_card(self, cloud, cfg):
        if self.device.type == "cuda":
            raise fault
        return on_card(self, cloud, cfg)

    with mock.patch.object(Pipeline, "analyze_device", fails_on_card):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["analyze", "sample", "--fallback-cpu"])
        except RuntimeError as e:
            require(e is fault, f"--fallback-cpu raised {e!r}")
        else:
            require(False, f"--fallback-cpu answered a kernel fault on a "
                    f"healthy card from the CPU (exit {rc})")
    print("--fallback-cpu on the card: a kernel fault is raised, not "
          "degraded")


# ``analyze sample --fallback-cpu`` in a child process whose pipeline, after
# its analysis on the card, launches ``radius_count`` on people and a mask
# at a device address near 0, which nothing maps (1 << 40 was mapped on the
# card's machine): a sticky illegal-address error, which fails every later
# CUDA call of the process (an in-process probe's too).
STICKY_FAULT_CHILD = r"""
import sys
import torch
from lidar_ai_recommendation_software_tpu_torch import cli
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

on_card = Pipeline.analyze_device


def illegal_address(self, cloud, cfg):
    out = on_card(self, cloud, cfg)
    plan = kernels.radius_plan(512, 128)
    centers = torch.zeros((512, 2), device="cuda")
    counts = torch.empty(512, dtype=torch.int32, device="cuda")
    bogus = 256
    err = kernels.load_library().radius_count_launch(
        centers.data_ptr(), bogus, bogus, 4.0, 512, 128,
        plan.tiles_per_slice, *plan.grid, counts.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    return out


Pipeline.analyze_device = illegal_address
sys.exit(cli.main(["analyze", "sample", "--fallback-cpu"]))
"""


def check_fallback_raises_sticky_faults(ident: str) -> None:
    """``analyze --fallback-cpu`` in a child process whose kernel reads an
    illegal address: the probe in a fresh process answers, so the child
    raises the fault, exits non-zero and prints no degraded result."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", STICKY_FAULT_CHILD],
                         cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=300)
    took = time.perf_counter() - t0
    tail = res.stderr.strip().splitlines()[-3:]
    print(f"--fallback-cpu child with a planted illegal address: exit "
          f"{res.returncode} in {took:.3f} s on {ident}; stderr ends "
          f"{tail}")
    require(res.returncode != 0, "the sticky fault was not raised")
    require("people detected" not in res.stdout
            and "CPU oracle fallback" not in res.stderr
            and "falling back to the CPU" not in res.stderr,
            f"the sticky fault was answered from the CPU: {res.stdout} "
            f"{res.stderr[-2000:]}")
    require("illegal memory access" in res.stderr,
            f"the child failed otherwise: {res.stderr[-2000:]}")


def run_cli(big, out_1m, launches_1m, ident: str) -> dict:
    """The port's CLI on the card, in a temporary directory: the 1M scan
    from files, the fixture (also under ``--fallback-cpu``, which must not
    degrade), ``--neural``, ``analyze-seq`` on the sequence's frames,
    ``train`` at its defaults and ``bench`` at 1M. Returns the launches of
    all its runs."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import NeuralPipeline
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.utils import resilience

    totals = {k: 0 for k in kernels.LAUNCHES}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            run_cli_scan(big, out_1m, launches_1m, totals, ident)

            with _Recorded(Pipeline, "analyze") as calls:
                _, launches = cli_run(["analyze", "sample"], "CLI fixture",
                                      totals)
            check_golden(calls[0][2])
            require(launches["radius_count"] == 1, f"the fixture launched "
                    f"radius_count {launches['radius_count']} times")
            with _Recorded(resilience.FallbackPipeline, "analyze") as calls:
                _, launches = cli_run(["analyze", "sample",
                                       "--fallback-cpu"],
                                      "CLI fixture, --fallback-cpu", totals)
            (fallback, *_), _, fout = calls[0]
            require("degraded" not in fout and fallback.fallbacks == 0
                    and launches["radius_count"] == 1,
                    "--fallback-cpu degraded on a healthy card")
            check_golden(fout)
            print("--fallback-cpu on the card: not degraded, 0 fallbacks")
            check_fallback_raises_kernel_faults()
            check_fallback_raises_sticky_faults(ident)

            with _Recorded(NeuralPipeline, "analyze") as calls:
                _, launches = cli_run(["analyze", "sample", "--neural"],
                                      "CLI neural fixture", totals)
            check_neural_reference(calls[0][2], JAX_NEURAL_FIXTURE,
                                   "CLI, neural fixture")
            require(launches["fps_batched"] == 2
                    and launches["sa_mlp_pool"] == 2,
                    f"the CLI's forward launched {launches}")

            _, frames = sequence_frames()
            for t, f in enumerate(frames):
                np.save(f"f{t}.npy", f)
            with _Recorded(Pipeline, "analyze_sequence") as calls:
                _, launches = cli_run(
                    ["analyze-seq", *(f"f{t}.npy" for t in range(len(frames))),
                     "--dt", str(SEQUENCE_DT)], "CLI sequence", totals)
            seq = calls[0][2]
            got = {"people": seq["density"]["total_people"],
                   "direction": seq["flow"]["dominant_direction"],
                   "avg_speed": seq["flow"]["avg_speed"]}
            ref = JAX_REFERENCE_SEQUENCE
            print(f"CLI sequence: {got}")
            require(got["people"] == ref["people"]
                    and got["direction"] == ref["direction"]
                    and abs(got["avg_speed"] - ref["avg_speed"]) <= 1e-4,
                    f"CLI sequence {got} vs {ref}")
            require(launches["table_fill"] == SEQUENCE_FRAMES
                    and launches["radius_count"] == 1,
                    f"the CLI's sequence launched {launches}")

            text, launches = cli_run(
                ["train", "--steps", "3", "--eval-venues", "2", "--out",
                 "ckpt.npz"], "CLI train", totals)
            nums = [float(v) for v in re.findall(
                r"(?:final loss|density MAE|flow MSE) (\S+?)[,;]?\s",
                text + " ")]
            require(len(nums) == 3 and all(math.isfinite(v) for v in nums),
                    f"training: losses and metrics {nums}")
            require(launches["fps_batched"] > 0
                    and launches["sa_mlp_pool"] > 0,
                    f"training launched {launches}")
            served = NeuralPipeline(checkpoint="ckpt.npz", device="cuda")
            cfg = served.train_config
            require((cfg.n_points, cfg.grid, cfg.sa1_samples,
                     cfg.sa2_samples) == (4096, 32, 512, 128),
                    f"the trained checkpoint's config {cfg}")
            sout = served.analyze(big[:50_000])
            require(np.isfinite(sout["density"]["density_map"]).all()
                    and sout["density"]["density_map"].shape == (32, 32),
                    "the trained checkpoint serves finite maps")
            print(f"trained checkpoint served by NeuralPipeline: people "
                  f"{sout['density']['total_people']}")

            text, _ = cli_run(["bench", "--points", "1000000"], "CLI bench",
                              totals)
            require(re.search(r"steady-state : \S+ ms/cloud -> [\d,]+ "
                              r"points/s", text) is not None,
                    "bench printed no steady-state rate")
        finally:
            os.chdir(cwd)
    print(f"launches over the CLI's runs: "
          f"{ {k: v for k, v in totals.items() if v} }")
    return totals


# ---------------------------------------------------------------------------
# parallel/: four gloo ranks sharing the card
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4
SCAN_10M = 10_000_000
# the JAX package's census of scaled_venue(10_000_000) (README.md:331-333,
# benchmarks/profile_10m.py): the clusters of ``dbscan_labels`` over the
# whole padded cloud, ground included, under the fitted capacities; the
# people of the pipeline
JAX_CENSUS_10M = {"clusters": 634_179, "people": 443_907}
PARALLEL_TRAIN = (("dp2 x mp2", (("dp", 2), ("mp", 2))),
                  ("dp4", (("dp", 4), ("mp", 1))))
PARALLEL_TRAIN_STEPS = 2
# a sharded update against the single-process AdamW update of the same
# reduced gradients: the same formula, rounded in another order
# (``tests/test_torch_train.py``'s bound on one AdamW update)
UPDATE_RTOL, UPDATE_ATOL_LR = 1e-6, 1e-4


def parallel_rank(rank: int, outdir: str, inp: dict) -> None:
    """One rank of the parallel phase (``parallel.mesh.spawn``: gloo, every
    rank on the one card): each case with the launch counts set to 0 just
    before it and read just after. Its wall time, its exchanges (their
    seconds, the staging through the host apart) and its launches go to
    ``rank{r}.json``, its results to ``rank{r}.npz`` (the 10M labels
    from rank 0; the others' digest)."""
    import hashlib

    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import train
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.parallel import (
        cluster, spatial, trainer)
    from lidar_ai_recommendation_software_tpu_torch.parallel import (
        mesh as pmesh)

    sp = pmesh.spatial_mesh()
    arrays, records = {}, {}

    def case(name, mesh, fn):
        torch.cuda.synchronize()
        before = dataclasses.replace(mesh.stats)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = mesh.stats
        records[name] = {
            "wall_s": wall, "exchanges": st.calls - before.calls,
            "exchange_s": st.seconds - before.seconds,
            "staging_s": st.staging_seconds - before.staging_seconds,
            "staged_bytes": st.staged_bytes - before.staged_bytes,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}
        return out

    x = torch.arange(32.0, device=sp.device).reshape(32, 1)
    arrays["halo"] = case("halo", sp, lambda: spatial.gather_stripes(
        spatial.halo_exchange_x(x[8 * rank:8 * rank + 8], 2, sp)[None],
        sp)).cpu().numpy()

    scan = np.load(inp["scan"], mmap_mode="r")
    labels = case("sharded DBSCAN, 10M", sp, lambda: cluster.sharded_dbscan(
        scan, inp["eps"], inp["min_samples"], sp))
    arrays["labels_digest"] = np.array(
        hashlib.sha256(labels.tobytes()).hexdigest())
    if rank == 0:
        arrays["labels"] = labels

    d = inp["density"]
    arrays["density"] = case("density, 1M", sp, lambda: spatial.gather_stripes(
        spatial.sharded_radius_density(
            d["people"], d["people_mask"], d["origin"], d["nx"], d["ny"],
            inp["cfg"], sp), sp)).cpu().numpy()
    flow = case("flow, 1M", sp, lambda: [
        spatial.gather_stripes(v, sp) for v in
        spatial.sharded_flow_and_bottlenecks(d["mins"], d["maxs"],
                                             d["uniforms"], inp["cfg"], sp)])
    for name, v in zip(("vectors", "mags", "valid", "sev", "ok"), flow):
        arrays[f"flow_{name}"] = v.cpu().numpy()

    tcfg, batch = inp["train_cfg"], inp["batch"]
    for tag, axes in PARALLEL_TRAIN:
        tm = pmesh.make_mesh(axes)
        step = trainer.make_sharded_train_step(tcfg, tm)
        state = trainer.sharded_init(tcfg, tm)
        arrays[f"{tag}_digest"] = np.array(train.weights_digest(
            state.model.state_dict()))
        # the first step warms up; the second, whose update reads the
        # sliced moments, is the case
        for t in range(PARALLEL_TRAIN_STEPS):
            metrics = (case(f"train {tag}", tm, lambda: step(state, batch))
                       if t == PARALLEL_TRAIN_STEPS - 1
                       else step(state, batch))
            arrays[f"{tag}_loss{t}"] = metrics["loss"].cpu().numpy()
            for name, p in state.model.named_parameters():
                arrays[f"{tag}_grad{t}:{name}"] = p.grad.cpu().numpy()
                arrays[f"{tag}_param{t}:{name}"] = p.detach().cpu().numpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(records, f)


def check_dp_shard_kernels(model, batch, cfg) -> dict:
    """``fps_batched`` and ``sa_mlp_pool`` against their plain versions at
    the shapes a dp rank's step gives them: the forward of the first dp
    shard's rows of ``batch`` for each dp size of ``PARALLEL_TRAIN``, the
    wrappers' calls recorded. Returns the largest error of each."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.models import (
        crowdnet, train)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)

    errs = {"fps_batched": 0, "sa_mlp_pool": 0}
    for dp in sorted({dict(axes)["dp"] for _, axes in PARALLEL_TRAIN}):
        rows = {k: v[:cfg.batch_size // dp] for k, v in batch.items()}
        with _Recorded(crowdnet, "fps_batched") as fps, \
                _Recorded(P, "sa_mlp_pool") as sa:
            train.loss_fn(model, train.batch_tensors(rows, "cuda"), cfg)
        require(len(fps) == 2 and len(sa) == 2,
                f"dp {dp}: {len(fps)} fps_batched and {len(sa)} sa_mlp_pool "
                f"calls in a forward, 2 each expected")
        for args, kw, got in fps:
            want = P.fps_reference(*args, **kw)
            torch.cuda.synchronize()
            err = int_err(got, want)
            errs["fps_batched"] = max(errs["fps_batched"], err)
            require(torch.equal(got, want), f"fps_batched differs from its "
                    f"plain version on dp {dp}'s rows {tuple(args[0].shape)}")
            print(f"fps_batched on a dp {dp} rank's rows: "
                  f"{tuple(args[0].shape)} -> {tuple(got.shape)}, max_abs_err "
                  f"{err}")
        for args, kw, got in sa:
            dtype = args[3] if len(args) > 3 else kw.get(
                "compute_dtype", torch.float32)
            tol = SA_BF16_TOL if dtype == torch.bfloat16 else SA_F32_TOL
            with torch.no_grad():
                want = P.sa_mlp_pool_reference(*args, **kw)
            got = got.detach()  # the autograd function's output
            torch.cuda.synchronize()
            err = rel_err(got, want)
            errs["sa_mlp_pool"] = max(errs["sa_mlp_pool"],
                                      float((got - want).abs().max()))
            require(got.shape == want.shape and err <= tol,
                    f"sa_mlp_pool off by {err} on dp {dp}'s rows "
                    f"{tuple(args[0].shape)}")
            print(f"sa_mlp_pool on a dp {dp} rank's rows: "
                  f"{tuple(args[0].shape)} -> {tuple(got.shape)}, max "
                  f"relative error {err:.3e} (tolerance {tol})")
    return errs


def run_parallel(pipe, big, ident: str) -> tuple:
    """The port's ``parallel/`` with four gloo ranks on the card (the
    kernels already built here): the 10M scan clustered 4 ways against
    this process's clustering of the same buffer, the 1M venue's density
    and flow against the single card's internals, a default-width step on
    a dp 2 x mp 2 and a dp 4 mesh against the single-process step, and the
    halo round trip. Every kernel of these paths is held against its plain
    version at a rank's shapes. Returns the ranks' launches, summed, and
    the largest error of each kernel held here."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.models import flow as fm
    from lidar_ai_recommendation_software_tpu_torch.models import train
    from lidar_ai_recommendation_software_tpu_torch.ops import (
        ccl, clustering)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.parallel import (
        cluster as pcluster)
    from lidar_ai_recommendation_software_tpu_torch.parallel import (
        mesh as pmesh)
    from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

    dev = torch.device("cuda", 0)
    errs = {}

    def h(t):
        return t.cpu().numpy()

    def held(res):
        for k, e in res["errs"].items():
            errs[k] = max(errs.get(k, 0), e)

    t0 = time.perf_counter()
    scan = scaled_venue(SCAN_10M)
    print(f"scaled_venue({SCAN_10M:,}) in {time.perf_counter() - t0:.3f} "
          f"s (host)")
    with _Recorded(ccl, "dbscan_gs") as calls:
        t0 = time.perf_counter()
        out, launches = traced(lambda: pipe.analyze(scan), "10M-point")
        first = time.perf_counter() - t0
    require_one_pass(launches, "the 10M-point run")
    t0 = time.perf_counter()
    pipe.analyze(scan)
    torch.cuda.synchronize()
    print(f"analyze of the 10M scan: {first:.3f} s first, "
          f"{time.perf_counter() - t0:.3f} s warm (synchronised) on {ident}")
    cap = pipe.fit_capacity(scan).capacity
    pre = pipe.config.preprocess
    whole = PointCloud.from_numpy(scan, cap.max_points, device="cuda")
    _, n_whole, ov_whole = clustering.dbscan_labels(
        whole.points, whole.mask, pre.dbscan_eps, pre.dbscan_min_samples,
        ncx=cap.cluster_cells_x, ncy=cap.cluster_cells_y,
        column_cap=cap.cluster_column_cap, max_iters=cap.max_cc_iters)
    census = {"clusters": int(n_whole),
              "people": out["density"]["total_people"]}
    print(f"10M census {census} (the whole cloud's clusters, "
          f"{int(ov_whole)} points past a column's cap of "
          f"{cap.cluster_column_cap}; the pipeline's people, of its "
          f"{int(out['processed'].n_clusters):,} non-ground clusters); the "
          f"JAX package's (recorded) {JAX_CENSUS_10M}")
    require(census == JAX_CENSUS_10M, f"10M census {census}")
    del whole
    (pts, mask, eps, min_samples), kw, (single, n_single, ov) = calls[-1]
    require(int(ov) == 0, "the recorded clustering overflowed")
    pts, valid, single = h(pts), h(mask), h(single)
    require((single[~valid] == -1).all(), "a masked point has a label")
    print(f"its clustering: {int(valid.sum()):,} of {len(valid):,} buffer "
          f"points, {int(n_single):,} clusters, {kw}")
    del out, scan, calls, mask
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the fill alone timed there: its table is the largest of the path
    held(check_column_case(
        dev, "10M analyze's buffer", pts, valid, eps,
        min_samples, kw["ncx"], kw["ncy"], kw["column_cap"],
        timed=("table_fill",)))
    print(f"the column kernels at the 10M buffer against their plain "
          f"versions, table_fill timed: {time.perf_counter() - t0:.3f} s")

    cfg = pipe.fit_capacity(big)
    cloud = PointCloud.from_numpy(big, cfg.capacity.max_points,
                                  device="cuda")
    (processed, people, res), cfg = pipe._run_exact(pipe.analyze_device,
                                                     cloud, cfg)
    require(int(res.density.radius_overflow) == 0, "bucket overflow at 1M")
    u = pipe._uniforms
    _, mag1, valid1, _, _ = fm.synthesize_flow(processed, u, cfg)
    sev1, ok1 = fm._bottlenecks_monolith(mag1, valid1, cfg)

    tcfg = train.TrainConfig()
    batch = train.make_batch(np.random.RandomState(tcfg.seed), tcfg)
    ref = train.init_state(tcfg, device="cuda")
    digest = train.weights_digest(ref.model.state_dict())
    held({"errs": check_dp_shard_kernels(ref.model, batch, tcfg)})
    tensors = train.batch_tensors(batch, "cuda")
    ref_losses = []
    for t in range(PARALLEL_TRAIN_STEPS):
        ref_losses.append(float(train.train_step(ref, tensors, tcfg)["loss"]))
        if t == 0:
            ref_grads = {n: h(p.grad) for n, p in
                         ref.model.named_parameters()}

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "scan.npy"),
                np.ascontiguousarray(pts[valid]))
        inp = {"scan": os.path.join(tmp, "scan.npy"), "eps": eps,
               "min_samples": min_samples, "cfg": cfg, "train_cfg": tcfg,
               "batch": batch,
               "density": {"people": h(people.positions),
                           "people_mask": h(people.mask),
                           "origin": h(processed.mins[:2]),
                           "nx": int(res.density.nx),
                           "ny": int(res.density.ny),
                           "mins": h(processed.mins[:2]),
                           "maxs": h(processed.maxs[:2]),
                           "uniforms": h(u)}}
        t0 = time.perf_counter()
        pmesh.spawn(parallel_rank, PARALLEL_RANKS, tmp, inp)
        print(f"{PARALLEL_RANKS} gloo ranks on the card, spawned to ended: "
              f"{time.perf_counter() - t0:.3f} s")
        got = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
               for r in range(PARALLEL_RANKS)]
        records = []
        for r in range(PARALLEL_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                records.append(json.load(f))

    totals = {k: 0 for k in kernels.LAUNCHES}
    for name in records[0]:
        for r, rec in enumerate(records):
            c = rec[name]
            print(f"parallel {name}, rank {r}: wall {c['wall_s'] * 1e3:.3f} "
                  f"ms, {c['exchanges']} exchanges {c['exchange_s'] * 1e3:.3f}"
                  f" ms of which staging through the host "
                  f"{c['staging_s'] * 1e3:.3f} ms "
                  f"({c['staged_bytes'] / 1e6:.3f} MB), launches "
                  f"{c['launches']} on {ident}")
            for k, v in c["launches"].items():
                totals[k] += v
    for r, rec in enumerate(records):
        lc = rec["sharded DBSCAN, 10M"]["launches"]
        tries = lc.get("table_fill", 0)
        require(tries >= 1 and lc.get("column_counts") == tries
                and lc.get("border_min") == tries
                and lc.get("propagate") == 3 * tries
                and set(lc) == {"table_fill", "column_counts", "propagate",
                                "border_min"},
                f"rank {r}'s sharded clustering launched {lc}")
        require(rec["density, 1M"]["launches"] == {"radius_count": 1},
                f"rank {r}'s density launched "
                f"{rec['density, 1M']['launches']}")
        for tag, _ in PARALLEL_TRAIN:
            lt = rec[f"train {tag}"]["launches"]
            require(lt == {"fps_batched": 2, "sa_mlp_pool": 2},
                    f"rank {r}'s {tag} step launched {lt}")
    require(len({rec["sharded DBSCAN, 10M"]["launches"].get("table_fill")
                 for rec in records}) == 1, "ranks retried apart")

    halo = got[0]["halo"][:, :, 0]
    require(np.array_equal(halo[1], [6, 7, *range(8, 16), 16, 17])
            and (halo[0, :2] == 0).all() and (halo[3, -2:] == 0).all()
            and np.array_equal(halo[2], [14, 15, *range(16, 24), 24, 25]),
            f"halo round trip {halo}")
    print("halo round trip on the card: equal to the JAX package's rule")

    lab = got[0]["labels"]
    require(all(str(g["labels_digest"]) == str(got[0]["labels_digest"])
                for g in got), "ranks' 10M labels differ")
    n = len(lab)
    reps = np.unique(lab[lab >= 0])
    dense = np.full(n + 1, -1, np.int64)
    dense[reps] = np.arange(len(reps))
    sharded = np.where(lab >= 0, dense[np.clip(lab, 0, n)], -1)
    require(np.array_equal(sharded, single[valid]) and len(reps) == int(
        n_single), "4-rank labels differ from the single-process clustering")
    print(f"sharded DBSCAN, 10M: {n:,} points, {len(reps):,} clusters, "
          f"labels bit-equal to the single-process clustering of the same "
          f"buffer")
    # the column kernels at an interior rank's table: its stripe and
    # halo, the grid and the cap its last try took
    t0 = time.perf_counter()
    stripes = pts[valid]
    bufs, bvalid, _, _ = pcluster.partition_stripes(stripes, PARALLEL_RANKS,
                                                    halo=eps)
    ncx, ncy, cap0 = pcluster.column_grid(stripes, PARALLEL_RANKS, eps,
                                          bufs.shape[1])
    tries = records[1]["sharded DBSCAN, 10M"]["launches"]["table_fill"]
    held(check_column_case(
        dev, "rank 1's table of the 10M scan", bufs[1], bvalid[1], eps,
        min_samples, ncx, ncy, cap0 << (tries - 1)))
    print(f"the column kernels at rank 1's table ({bufs.shape[1]:,} slots, "
          f"{ncx} x {ncy} columns, cap {cap0 << (tries - 1)} after {tries} "
          f"tries) against their plain versions: "
          f"{time.perf_counter() - t0:.3f} s")
    del stripes, bufs, bvalid

    grid1 = h(res.density.density_grid)
    derr = max(float(np.abs(g["density"] - grid1).max()) for g in got)
    require(derr <= 1e-6, f"sharded density off by {derr}")
    print(f"sharded density, 1M: {grid1.shape} grid, max |sharded - single "
          f"card (bucketed)| {derr}, max density {grid1.max()}")
    mag1, valid1, sev1, ok1 = (h(mag1), h(valid1), h(sev1), h(ok1))
    merr = max(float(np.abs(g["flow_mags"] - mag1).max()) for g in got)
    require(merr <= 1e-5, f"sharded flow: mags off by {merr}")
    for g in got:
        require(np.array_equal(g["flow_valid"], valid1)
                and np.array_equal(g["flow_ok"], ok1)
                and np.array_equal(g["flow_sev"][ok1], sev1[ok1]),
                "sharded flow: valid nodes, bottlenecks or severities "
                "differ")
    print(f"sharded flow, 1M: max |mags - single card| {merr}, valid, "
          f"{int(ok1.sum())} bottleneck nodes and their severities equal")

    for tag, _ in PARALLEL_TRAIN:
        g0 = got[0]
        require(str(g0[f"{tag}_digest"]) == digest, f"{tag}: other weights")
        losses = [float(g0[f"{tag}_loss{t}"])
                  for t in range(PARALLEL_TRAIN_STEPS)]
        worst = 0.0
        for name, want in ref_grads.items():
            rel = float(np.linalg.norm(g0[f"{tag}_grad0:{name}"] - want)
                        / np.linalg.norm(want))
            worst = max(worst, rel)
            require(rel <= TRAIN_GRAD_TOL, f"{tag}: gradient {name} {rel}")
        for loss, want in zip(losses, ref_losses):
            require(abs(loss - want) <= TRAIN_LOSS_TOL * abs(want),
                    f"{tag}: losses {losses} vs {ref_losses}")
        # each step's parameters: the single-process AdamW update of the
        # step's reduced gradients, from the parameters before it, so the
        # second update holds the sliced moments to the whole ones
        replay = train.init_state(tcfg, device="cuda")
        worst_update = 0.0
        for t in range(PARALLEL_TRAIN_STEPS):
            lr = replay.schedule(replay.step)
            for name, p in replay.model.named_parameters():
                p.grad = torch.from_numpy(g0[f"{tag}_grad{t}:{name}"]).to(
                    p.device)
            train.apply_update(replay)
            for name, p in replay.model.named_parameters():
                want = h(p.detach())
                diff = np.abs(g0[f"{tag}_param{t}:{name}"] - want)
                worst_update = max(worst_update, float(diff.max()) / lr)
                require(bool((diff <= UPDATE_RTOL * np.abs(want)
                              + UPDATE_ATOL_LR * lr).all()),
                        f"{tag}: step {t}'s update of {name} off the "
                        f"single-process update by {float(diff.max())}")
        for g in got[1:]:
            require(all(np.array_equal(g[k], g0[k]) for k in g0
                        if k.startswith(tag)), f"{tag}: ranks differ")
        print(f"train {tag}, default width: losses {losses} vs "
              f"single-process {ref_losses}; worst first-step gradient "
              f"{worst:.3e} relative; {PARALLEL_TRAIN_STEPS} updates within "
              f"{worst_update:.3e} x lr of the single-process AdamW update "
              f"of the same gradients (tolerance {UPDATE_RTOL} relative + "
              f"{UPDATE_ATOL_LR} x lr); every rank the same")
    return totals, errs


# ---------------------------------------------------------------------------
# the reference's CPU baseline
# ---------------------------------------------------------------------------

def host_cpu() -> str:
    """The host's CPU as its first ``/proc/cpuinfo`` entry names it (a
    virtual machine may hide the model name, not the family and model
    numbers), and its logical cores."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"CPU '{info.get('model name', '?')}' ({info.get('vendor_id')} "
            f"family {info.get('cpu family')} model {info.get('model')}, "
            f"{info.get('cpu MHz')} MHz), {os.cpu_count()} logical cores")


def check_modular_against_oracle(card, oracle) -> None:
    """The card's modular ``analyze`` against the oracle's, to the
    tolerances of ``tests/test_pipeline.py::TestModularParity``."""
    import numpy as np
    d, od = card["density"], oracle["density"]
    f, of = card["flow"], oracle["flow"]
    g, og = d["density_map"], od["density_map"]
    require(d["total_people"] == od["total_people"], "modular: people")
    require(g.shape == og.shape and float(np.abs(g - og).mean()) < 0.01,
            "modular: density_map")
    require(abs(d["avg_density"] - od["avg_density"]) < 1e-3,
            "modular: avg_density")
    require(abs(d["max_density"] - od["max_density"]) < 1e-6,
            "modular: max_density")
    require(abs(f["avg_speed"] - of["avg_speed"]) < 1e-5,
            "modular: avg_speed")
    require(f["dominant_direction"] == of["dominant_direction"],
            "modular: direction")
    require([b["severity"] for b in f["bottlenecks"]]
            == [b["severity"] for b in of["bottlenecks"]],
            "modular: bottleneck severities")


def run_oracle_baseline(pipe, fixture, ms_1m: float, ident: str) -> None:
    """The reference's CPU baseline on this host: the port's oracle
    (NumPy and SciPy, ``oracle/reference.py``) gives the fixture's golden
    values, and the card's ``analyze`` its people and density grid
    exactly (monolith) and within the JAX package's tests' tolerances
    (modular); on ``bench.py``'s 100,000-point cloud the oracle's
    ``analyze`` is timed once on the host's clock (``cpu_points_per_sec``)
    and the card's density grid, through ``radius_count`` and the column
    kernels, must equal it (MAE 0) with the same people; the warm 1M
    ``analyze``'s points/s are set against it."""
    import numpy as np
    from lidar_ai_recommendation_software_tpu_torch import (
        MODULAR_CONFIG, scaled_venue)
    from lidar_ai_recommendation_software_tpu_torch.oracle import (
        reference as ref)
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from tools.oracle_stages import POINTS, stages

    cpu = host_cpu()
    print(f"host: {cpu}")
    oracle = ref.analyze(fixture, variant="monolith")
    print("the port's oracle on the seed-42 fixture:")
    check_golden(oracle)
    card = pipe.analyze(fixture)
    require(card["density"]["total_people"]
            == oracle["density"]["total_people"], "fixture: people")
    require(np.array_equal(card["density"]["density_grid"],
                           oracle["density"]["density_grid"]),
            "fixture: the card's density grid differs from the oracle's")
    modular = Pipeline(MODULAR_CONFIG, device="cuda").analyze(fixture)
    check_modular_against_oracle(modular,
                                 ref.analyze(fixture, variant="modular"))
    print("fixture: the card's monolith people and density grid equal the "
          "oracle's; its modular run within tests/test_pipeline.py's "
          "tolerances of the oracle's")

    cloud = scaled_venue(POINTS)
    seconds, out = stages(ref, cloud)
    density = out["density"]
    cpu_pps = POINTS / seconds["whole"]
    print(f"oracle analyze of scaled_venue({POINTS:,}), once, host "
          "clock: " + ", ".join(f"{k} {v:.3f} s" for k, v in seconds.items())
          + f"; cpu_points_per_sec {cpu_pps:.1f} on {cpu}, beside {ident}")
    card, launches = traced(lambda: pipe.analyze(cloud),
                            f"{POINTS:,}-point")
    for k in ("radius_count", *COLUMN_KERNELS):
        require(launches[k] > 0, f"the {POINTS:,}-point run did not "
                f"launch {k}")
    g, og = card["density"]["density_grid"], density["density_grid"]
    require(g.shape == og.shape, f"100,000 points: density grid shape "
            f"{g.shape} vs the oracle's {og.shape}")
    mae = float(np.abs(g - og).mean())
    people = card["density"]["total_people"]
    parity = people == density["total_people"]
    print(f"card analyze of the same cloud on {ident}: "
          f"density_mae_vs_oracle_100k {mae}, people_parity_100k {parity} "
          f"({people} people, the oracle {density['total_people']})")
    require(mae == 0.0, f"density_mae_vs_oracle_100k {mae}")
    require(parity, "people_parity_100k")
    pps = 1e9 / ms_1m
    print(f"1,000,000-point analyze, warm median {ms_1m:.3f} ms: "
          f"{pps:.1f} points/s on {ident}; {pps / cpu_pps:.3f} x the "
          f"oracle's cpu_points_per_sec ({cpu_pps:.1f}) on {cpu}")


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
        report = log.read_text().strip()
        print(report)
        spills = [ln.strip() for ln in report.splitlines() if "spill" in ln]
        require(len(spills) >= len(KERNELS) and all(
            "0 bytes spill stores, 0 bytes spill loads" in ln
            for ln in spills), "a kernel spills registers")
        print(f"ptxas: {len(spills)} kernel bodies, 0 bytes of spill")

    phase("radius_count kernel against its plain version")
    radius = run_radius_checks(dev)

    phase("eps_edges kernel against its plain version")
    t0 = time.perf_counter()
    eps_rec = run_eps_checks(dev)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

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
            (40_960, JAX_REFERENCE_40960, ("radius_count", "eps_edges")),
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
        require_one_pass(launches, f"the {n:,}-point run")
        cpu = Pipeline(device="cpu").analyze(venues[n])
        check_same(host_arrays(out), host_arrays(cpu), False,
                   f"{n:,} points, card vs CPU")
        print("card equals the port on the CPU: yes")
        check_jax_reference(out, ref, f"card, {n:,} points")
        if n == 40_960:
            radius["launches"] = launches["radius_count"]
            eps_rec["launches"] = launches["eps_edges"]
        print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("1,000,000-point venue on the card")
    t0 = time.perf_counter()
    venues[1_000_000] = big = scaled_venue(1_000_000)
    out, launches_1m = traced(lambda: pipe.analyze(big),
                              "1,000,000-point")
    for k in COLUMN_KERNELS:
        require(launches_1m[k] > 0, f"the 1M-point run did not launch {k}")
    require_one_pass(launches_1m, "the 1M-point run")
    require(launches_1m["eps_edges"] == 0,
            "the 1M-point run took the all-pairs clustering")
    check_jax_reference(out, JAX_REFERENCE_1M, "card, 1,000,000 points")
    out_1m = out
    again = pipe.analyze(big)
    check_same(host_arrays(out), host_arrays(again), True,
               "second 1M-point run")
    print("second run bit-identical: yes")
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase(f"temporal sequence, {SEQUENCE_FRAMES} x {SEQUENCE_POINTS:,} "
          f"points")
    t0 = time.perf_counter()
    run_sequence(pipe, ident)
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

    phase("CrowdNet training at the default width, card vs the port on the "
          "CPU")
    t0 = time.perf_counter()
    launches_train = run_training(ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("hash-grid ball query: the 100,000- and 1,000,000-point layers")
    t0 = time.perf_counter()
    launches_layer_1m = run_hashgrid(dev, layer_points, ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("3,000,000-point scan on the card and place_dense")
    t0 = time.perf_counter()
    venues[3_000_000], launches_3m, placed = run_scan_3m(pipe, ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("the CLI on the card")
    t0 = time.perf_counter()
    launches_cli = run_cli(big, out_1m, launches_1m, ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase(f"parallel/: {PARALLEL_RANKS} gloo ranks on the card")
    t0 = time.perf_counter()
    launches_parallel, errs_parallel = run_parallel(pipe, big, ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    phase("warm wall time of analyze on the card")
    warm_ms = {}
    for name, pts in (("10,000-point fixture", fixture),
                      *((f"{n:,}-point venue", v)
                        for n, v in venues.items())):
        t0 = time.perf_counter()
        warm_ms[name] = ms = wall_ms(lambda: pipe.analyze(pts))
        print(f"analyze {name}: median {ms:.3f} ms of 5 (warm, "
              f"synchronised) on {ident}; phase "
              f"{time.perf_counter() - t0:.3f} s")

    phase("the reference's CPU baseline on the card's host")
    t0 = time.perf_counter()
    run_oracle_baseline(pipe, fixture, warm_ms["1,000,000-point venue"],
                        ident)
    print(f"phase took {time.perf_counter() - t0:.3f} s")

    records = [dict(name="radius_count", route="cuda",
                    source=KERNELS["radius_count"][0],
                    replaces=KERNELS["radius_count"][1],
                    launches=radius["launches"],
                    max_abs_err=radius["max_abs_err"], ms=radius["ms"],
                    graph_ms=radius["graph_ms"], plain_ms=radius["plain_ms"],
                    bound_ms=radius["bound_ms"],
                    bound_by=radius["bound_by"], library_ms=None,
                    cli_launches=launches_cli["radius_count"],
                    parallel_launches=launches_parallel["radius_count"])]
    for k in COLUMN_KERNELS:
        records.append(dict(name=k, route="cuda", source=KERNELS[k][0],
                            replaces=KERNELS[k][1], launches=launches_1m[k],
                            max_abs_err=max(cols["errs"][k],
                                            errs_parallel.get(k, 0)),
                            **cols["times"][k],
                            library_ms=None, cli_launches=launches_cli[k],
                            parallel_launches=launches_parallel[k]))
    # launches: place_dense in the 3M scan's analyze, fps_single in the
    # 100,000-point layer, fps_batched and sa_mlp_pool in one served analyze
    # (their times and bounds: the mean over that analyze's two launch
    # shapes); beside them, the launches of one default-width training
    # step and of the 1,000,000-point layer
    for k, launches, rec in (
            ("place_dense", launches_3m, placed),
            ("fps_single", launches_layer, {**fps["fps_single"],
                                            "library_ms": None}),
            ("fps_batched", launches_neural, {**fps["fps_batched"],
                                              "library_ms": None}),
            ("sa_mlp_pool", launches_neural, {**sa, "library_ms": None})):
        require(launches[k] > 0, f"{k} was not launched on its path")
        extra = {f"{path}_launches": counts[k] for path, counts in (
            ("train_step", launches_train), ("layer_1m", launches_layer_1m))
            if counts[k]}
        rec = {**rec, "max_abs_err": max(rec["max_abs_err"],
                                         errs_parallel.get(k, 0))}
        records.append(dict(name=k, route="cuda", source=KERNELS[k][0],
                            replaces=KERNELS[k][1], launches=launches[k],
                            **rec, **extra, cli_launches=launches_cli[k],
                            parallel_launches=launches_parallel[k]))
    records.append(dict(name="eps_edges", route="cuda",
                        source=KERNELS["eps_edges"][0],
                        replaces=KERNELS["eps_edges"][1], **eps_rec,
                        library_ms=None,
                        cli_launches=launches_cli["eps_edges"],
                        parallel_launches=launches_parallel["eps_edges"]))
    require([r["name"] for r in records] == list(KERNELS), "kernel records")
    require(all(r["graph_ms"] > 0 for r in records),
            "every kernel timed from a CUDA graph")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
