#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's ``Pipeline.analyze`` on one
NVIDIA GPU.

    python3 -m tools.profile_torch_port     (from the repository root)

For the seed-42 fixture (10,000 points), a 40,960-point sensor frame and
venues of 262,144 and 1,000,000 points it prints the card's name and
power limit, then

  - the median wall time of each stage over 5 warm runs, on the host clock
    with the device synchronised after every stage: the host's capacity
    fit and upload, then the device program's stages (clustering is timed
    inside preprocess);
  - from ``torch.profiler``, over 3 warm ``analyze`` calls: the device's
    busy time (the sum of its kernels' times) against the wall time, and
    the kernels that take the most device time.

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
    sample_venue, scaled_venue)
from lidar_ai_recommendation_software_tpu_torch.models import density, flow
from lidar_ai_recommendation_software_tpu_torch.ops import clustering
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.preprocess import preprocess
from lidar_ai_recommendation_software_tpu_torch.types import PointCloud

STAGES = ("fit_capacity (host)", "upload (from_numpy)", "preprocess",
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
            cfg = pipe.fit_capacity(points)
            row = [_sync_ms(t0)]
            t0 = time.perf_counter()
            cloud = PointCloud.from_numpy(points, cfg.capacity.max_points,
                                          device=pipe.device)
            row.append(_sync_ms(t0))
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


def device_profile(pipe: Pipeline, points: np.ndarray, reps: int = 3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe.analyze(points)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pipe.analyze(points)
        wall = _sync_ms(t0) / reps
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    rows = sorted(((e.self_device_time_total / 1e3 / reps, e.count // reps,
                    e.key) for e in kernels), reverse=True)
    return wall, sum(r[0] for r in rows), rows


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    ident = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(ident)
    pipe = Pipeline(device="cuda")
    for name, pts in (("10,000-point fixture", sample_venue()),
                      ("40,960-point frame", scaled_venue(40_960)),
                      ("262,144-point venue", scaled_venue(262_144)),
                      ("1,000,000-point venue", scaled_venue(1_000_000))):
        print(f"== {name}")
        for stage, ms in stage_times(pipe, pts).items():
            print(f"{stage:30s} {ms:10.3f} ms")
        wall, busy, rows = device_profile(pipe, pts)
        if not rows:
            print(f"analyze under the profiler: wall {wall:.3f} ms; the "
                  f"profiler reported no kernel times (device busy share "
                  f"not measured)")
            continue
        print(f"analyze under the profiler: wall {wall:.3f} ms, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%), idle "
              f"{100 - 100 * busy / wall:.1f}%")
        for ms, count, key in rows[:10]:
            print(f"  {ms:9.4f} ms {count:6d} launches  {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
