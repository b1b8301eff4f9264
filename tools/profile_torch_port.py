#!/usr/bin/env python3
"""Where the time goes in the PyTorch port on one NVIDIA GPU:
``Pipeline.analyze``, ``NeuralPipeline.analyze``, the default-width
CrowdNet and the 100,000-point set-abstraction layer.

    python3 -m tools.profile_torch_port [analyze] [neural] [train]

(from the repository root; all three sections by default).

It prints the card's name and power limit. Then, for the seed-42 fixture
(10,000 points), a 40,960-point sensor frame and venues of 262,144,
1,000,000 and 3,000,000 points, of ``Pipeline.analyze``

  - the median wall time of each stage over 5 warm runs, on the host clock
    with the device synchronised after every stage: the scan's upload
    and the capacity fit on the device (``Pipeline._ingest``), then the
    device program's stages (clustering is timed inside preprocess);
  - from ``torch.profiler``, over 3 warm ``analyze`` calls: the device's
    busy time (the sum of its kernels' times) against the wall time, and
    the kernels that take the most device time.

The same two readings follow for neural serving (the shipped checkpoint on
a 4,096-point cloud), for the default-width CrowdNet on a batch of 4
(weights drawn from generator seed 11) and for the 100,000-point set-abstraction layer
(4,096 samples, K = 32, r = 0.6, MLP 3-32-32-64, bfloat16 operands), by
stage: sampling (``fps``), grouping (``ball_group``, ``group_features``;
at 100,000 points both routes, dense and hash grid), the fused MLP
(``sa_mlp_pool``), the BEV trunk and heads, and the host; the same layer
on a 1,000,000-point venue (the hash grid, ``fps`` streaming); and a
default-width training step (``TrainConfig()``): forward, backward and the
AdamW update.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch import (
    NeuralPipeline, sample_venue, scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.models import (
    density, flow, train)
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.pointnet import (
    fps_single, sa_mlp_pool)
from lidar_ai_recommendation_software_tpu_torch.ops.grouping import (
    ball_group, group_features)
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.preprocess import preprocess

STAGES = ("ingest (upload, fit, cloud)", "preprocess",
          "  clustering (in preprocess)", "extract_people",
          "analyze_density", "analyze_flow", "to_host_dict")


def _sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def stage_times(pipe: Pipeline, points: np.ndarray, reps: int = 5) -> dict:
    points = np.asarray(points, np.float64)
    inner = {}
    plain = clustering.dbscan_labels

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(*args, **kw)
        inner["ms"] = _sync_ms(t0)
        return out

    runs = {name: [] for name in STAGES}
    with mock.patch.object(clustering, "dbscan_labels", timed):
        for rep in range(reps + 1):  # the first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cloud, cfg, _ = pipe._ingest(points)
            row = [_sync_ms(t0)]
            t0 = time.perf_counter()
            proc = preprocess(cloud, cfg)
            row += [_sync_ms(t0), inner["ms"]]
            t0 = time.perf_counter()
            ppl = density.extract_people(proc, cfg)
            row.append(_sync_ms(t0))
            t0 = time.perf_counter()
            dres = density.analyze_density(proc, ppl, cfg)
            row.append(_sync_ms(t0))
            t0 = time.perf_counter()
            fres = flow.analyze_flow(proc, ppl, pipe._uniforms, cfg)
            row.append(_sync_ms(t0))
            t0 = time.perf_counter()
            dres.to_host_dict()
            fres.to_host_dict()
            row.append(_sync_ms(t0))
            if rep:
                for name, ms in zip(STAGES, row):
                    runs[name].append(ms)
    return {name: statistics.median(v) for name, v in runs.items()}


def device_profile(fn, reps: int = 3):
    """(wall ms, device busy ms, [(ms, launches, kernel)]) per call of
    ``fn``, over ``reps`` warm calls under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        wall = _sync_ms(t0) / reps
    # user annotations (Optimizer.step's) also appear on the device's
    # timeline; they are not device work
    notes = {e.name for e in prof.events()
             if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.key not in notes]
    rows = sorted(((e.self_device_time_total / 1e3 / reps, e.count // reps,
                    e.key) for e in kernels), reverse=True)
    return wall, sum(r[0] for r in rows), rows


def print_profile(what: str, fn) -> None:
    wall, busy, rows = device_profile(fn)
    if not rows:
        print(f"{what} under the profiler: wall {wall:.3f} ms; the "
              f"profiler reported no kernel times (device busy share "
              f"not measured)")
        return
    print(f"{what} under the profiler: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 - 100 * busy / wall:.1f}%")
    for ms, count, key in rows[:10]:
        print(f"  {ms:9.4f} ms {count:6d} launches  {key[:80]}")


def print_stages(stages, reps: int = 5) -> None:
    """``stages()`` yields (name, milliseconds) pairs of one run; prints
    each stage's median over ``reps`` warm runs."""
    runs = {}
    for rep in range(reps + 1):  # the first run warms up
        for name, ms in stages():
            if rep:
                runs.setdefault(name, []).append(ms)
    for name, v in runs.items():
        print(f"{name:30s} {statistics.median(v):10.3f} ms")


def model_stages(model, inputs):
    """Stage times of one CrowdNet forward on device inputs (points, mask,
    venue_min, venue_size)."""
    points, mask, vmin, vsize = inputs
    levels, feats, cur, cur_mask = [], None, points, mask
    with torch.no_grad():
        for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = sa.sample(cur, cur_mask)
            yield f"{name} sample (fps_batched)", _sync_ms(t0)
            t0 = time.perf_counter()
            cents, cmask, _, gvalid, grouped = sa.group(cur, feats, cur_mask,
                                                        idx)
            yield f"{name} group (ball_group)", _sync_ms(t0)
            t0 = time.perf_counter()
            feats = sa.pool(grouped, gvalid, cmask)
            yield f"{name} pool (sa_mlp_pool)", _sync_ms(t0)
            levels.append((cents, feats, cmask))
            cur, cur_mask = cents, cmask
        t0 = time.perf_counter()
        h = model.bev(levels, points, mask, vmin, vsize).permute(0, 3, 1, 2)
        yield "bev planes and trunk", _sync_ms(t0)
        t0 = time.perf_counter()
        for name, _ in model.HEADS:
            model._head(name, h)
        yield "heads", _sync_ms(t0)


def neural_sections() -> None:
    pipe = NeuralPipeline(device="cuda")
    cloud = sample_venue(n_points=4096, n_people=50, seed=42)
    print("== neural serving, 4,096 points (the shipped checkpoint)")

    def serving():
        t0 = time.perf_counter()
        pts, mask = pipe.padded_cloud(cloud[:, :3])
        vmin = cloud[:, :2].min(axis=0).astype(np.float32)
        vsize = np.float32(np.ptp(cloud[:, :2], axis=0).max() + 1e-6)
        inputs = [torch.from_numpy(np.asarray(x)).to(pipe.device)[None]
                  for x in (pts, mask, vmin, vsize)]
        yield "pad and upload (host)", _sync_ms(t0)
        yield from model_stages(pipe.model, inputs)
        t0 = time.perf_counter()
        pipe.analyze(cloud)
        yield "analyze, whole", _sync_ms(t0)

    print_stages(serving)
    print_profile("NeuralPipeline.analyze", lambda: pipe.analyze(cloud))

    print("== default-width CrowdNet, 4 x 8,192 points")
    cfg = train.TrainConfig()
    model = train.make_model(cfg, torch.Generator().manual_seed(11)).eval()
    model.to("cuda")
    pts = np.stack([sample_venue(n_points=cfg.n_points, n_people=80,
                                 seed=100 + i)
                    for i in range(cfg.batch_size)]).astype(np.float32)
    inputs = [torch.from_numpy(x).to("cuda") for x in (
        pts, np.ones(pts.shape[:2], bool),
        pts[..., :2].min(axis=1),
        np.ptp(pts[..., :2], axis=1).max(axis=1) + np.float32(1e-6))]
    print_stages(lambda: model_stages(model, inputs))

    def forward():
        with torch.no_grad():
            model(*inputs)

    print_profile("CrowdNet forward", forward)

    print("== 100,000-point set-abstraction layer, bfloat16 operands")
    p = torch.from_numpy(np.ascontiguousarray(
        scaled_venue(100_000)[:, :3], dtype=np.float32)).to("cuda")
    mask = torch.ones(p.shape[0], dtype=torch.bool).to("cuda")
    dims = [3, 32, 32, 64]
    rng = np.random.RandomState(0)
    w = [(torch.from_numpy((rng.randn(a, b) * 0.1).astype(np.float32)
                           ).to("cuda"), torch.zeros(b).to("cuda"))
         for a, b in zip(dims[:-1], dims[1:])]

    def layer(p, mask, methods=("auto",)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = fps_single(p, mask, 4096).to(torch.int64)
        yield "fps_single", _sync_ms(t0)
        for method in methods:
            t0 = time.perf_counter()
            gidx, gvalid = ball_group(p[idx], mask[idx], p, mask, 0.6, 32,
                                      method=method)
            yield f"ball_group ({method})", _sync_ms(t0)
        t0 = time.perf_counter()
        g = group_features(p, None, p[idx], gidx, gvalid)
        yield "group_features", _sync_ms(t0)
        t0 = time.perf_counter()
        sa_mlp_pool(g, gvalid, w, compute_dtype=torch.bfloat16)
        yield "sa_mlp_pool", _sync_ms(t0)

    print_stages(lambda: layer(p, mask, ("dense", "hashgrid")), reps=3)
    print_profile("the layer", lambda: list(layer(p, mask)))

    print("== 1,000,000-point set-abstraction layer (the hash grid), "
          "bfloat16 operands")
    big = torch.from_numpy(np.ascontiguousarray(
        scaled_venue(1_000_000)[:, :3], dtype=np.float32)).to("cuda")
    big_mask = torch.ones(big.shape[0], dtype=torch.bool).to("cuda")
    print_stages(lambda: layer(big, big_mask), reps=3)


def training_sections() -> None:
    """A default-width training step (``TrainConfig()``: 4 x 8,192
    points) by stage, and under the profiler."""
    print("== CrowdNet training step, 4 x 8,192 points")
    cfg = train.TrainConfig()
    state = train.init_state(cfg, device="cuda")
    batch = train.batch_tensors(train.make_batch(
        np.random.RandomState(cfg.seed), cfg), "cuda")

    def step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = train.step_loss(state, batch, cfg)
        yield "forward (the loss)", _sync_ms(t0)
        t0 = time.perf_counter()
        loss.backward()
        yield "backward", _sync_ms(t0)
        t0 = time.perf_counter()
        train.apply_update(state)
        yield "optimizer (AdamW)", _sync_ms(t0)

    print_stages(step)
    print_profile("train_step", lambda: train.train_step(state, batch, cfg))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(ident)
    sections = sys.argv[1:] or ["analyze", "neural", "train"]
    if "analyze" in sections:
        pipe = Pipeline(device="cuda")
        for name, pts in (("10,000-point fixture", sample_venue()),
                          ("40,960-point frame", scaled_venue(40_960)),
                          ("262,144-point venue", scaled_venue(262_144)),
                          ("1,000,000-point venue", scaled_venue(1_000_000)),
                          ("3,000,000-point scan",
                           scaled_venue(3_000_000))):
            print(f"== {name}")
            for stage, ms in stage_times(pipe, pts).items():
                print(f"{stage:30s} {ms:10.3f} ms")
            print_profile("analyze", lambda: pipe.analyze(pts))
    if "neural" in sections:
        neural_sections()
    if "train" in sections:
        training_sections()
    return 0


if __name__ == "__main__":
    sys.exit(main())
