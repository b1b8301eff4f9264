#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It

  1. prints the card's name and power limit;
  2. builds the port's CUDA kernels from ``csrc/``;
  3. holds each kernel against its plain PyTorch version on the card
     (int32 counts, bit-equal) and times both with CUDA events;
  4. runs ``Pipeline(device="cuda").analyze`` on the seed-42 fixture and
     checks the golden values, that the kernel was launched, and that a
     second run is bit-identical;
  5. runs a 40,960-point sensor frame on the card and holds it against the
     port's own CPU run (integers equal, floats within the tests'
     tolerances);
  6. prints the warm wall time of ``analyze`` at both sizes.

The line before the last is a JSON record of the kernels; the last line
is ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line is printed. Without a CUDA device, or outside the checkout, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

RADIUS = 2.0
KERNEL_SOURCE = ("lidar_ai_recommendation_software_tpu_torch/csrc/"
                 "radius_count.cu")
KERNEL_REPLACES = ("lidar_ai_recommendation_software_tpu/ops/pallas/"
                   "kernels.py:76")

# seed-42 fixture, monolith (the CPU oracle's values)
GOLDEN = {"people": 446, "max_density": 3.5, "avg_density": 0.4958,
          "avg_speed": 1.2617, "direction": "E",
          "first_hotspot": (5.5, -10.5, 3.5), "n_hotspots": 5,
          "severities": [8, 8, 8, 7, 7]}
# scaled_venue(40_960) through the JAX package on the CPU
JAX_REFERENCE_40960 = {"people": 1786, "max_density": 3.75,
                       "direction": "E", "severities": [9, 9, 9]}
# flow vectors, speeds and centroids: sin/cos and sums differ in the last
# ulps between the CPU and CUDA
FLOAT_TOL = 1e-5


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
                              (128, 14336, 9000, 120.0)):
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


def run_kernel_checks(dev) -> dict:
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    max_err = 0
    for name, c, p, m in radius_cases(dev):
        got = kernels.radius_count(c, p, m, RADIUS)
        want = kernels.radius_count_reference(c, p, m, RADIUS)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        print(f"radius_count {name}: max_abs_err {err}, total count "
              f"{int(want.sum())}")
        require(torch.equal(got, want), f"radius_count differs: {name}")
        if name == "256x5 exact radius":
            require(int(got[4 * 16 + 4]) == 4,
                    "people exactly at the radius must count")
        max_err = max(max_err, err)

    timings = {}
    for name, c, p, m in radius_cases(dev)[:2]:
        ms = cuda_ms(lambda: kernels.radius_count(c, p, m, RADIUS))
        plain = cuda_ms(
            lambda: kernels.radius_count_reference(c, p, m, RADIUS))
        print(f"radius_count {name}: kernel {ms:.6f} ms, plain "
              f"{plain:.6f} ms")
        timings[name] = (ms, plain)
    return {"max_abs_err": max_err, "timings": timings}


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
    kres = run_kernel_checks(dev)

    phase("seed-42 fixture on the card")
    fixture = sample_venue()
    pipe = Pipeline(device="cuda")
    kernels.reset_launch_counts()
    golden = pipe.analyze(fixture)
    torch.cuda.synchronize()
    launches_golden = kernels.LAUNCHES["radius_count"]
    print(f"radius_count launches in the fixture run: {launches_golden}")
    require(launches_golden > 0, "the fixture run did not launch the kernel")
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

    phase("40,960-point sensor frame, card vs the port on the CPU")
    frame = scaled_venue(40_960)
    kernels.reset_launch_counts()
    big = pipe.analyze(frame)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["radius_count"]
    print(f"radius_count launches in the 40,960-point run: {launches}")
    require(launches > 0, "the 40,960-point run did not launch the kernel")
    big_cpu = Pipeline(device="cpu").analyze(frame)
    check_same(host_arrays(big), host_arrays(big_cpu), False,
               "40,960 points, card vs CPU")
    for name, out in (("card", big), ("port on CPU", big_cpu)):
        d, f = out["density"], out["flow"]
        print(f"{name}: people {d['total_people']}, max_density "
              f"{d['max_density']}, direction {f['dominant_direction']}, "
              f"severities {[b['severity'] for b in f['bottlenecks']]}")
    print(f"JAX package on the CPU (recorded): {JAX_REFERENCE_40960}")
    ref = JAX_REFERENCE_40960
    require(big["density"]["total_people"] == ref["people"], "people")
    require(big["density"]["max_density"] == ref["max_density"],
            "max_density")
    require(big["flow"]["dominant_direction"] == ref["direction"],
            "direction")
    require([b["severity"] for b in big["flow"]["bottlenecks"]]
            == ref["severities"], "severities")

    phase("warm wall time of analyze on the card")
    for name, pts in (("10,000-point fixture", fixture),
                      ("40,960-point frame", frame)):
        ms = wall_ms(lambda: pipe.analyze(pts))
        print(f"analyze {name}: median {ms:.3f} ms of 5 (warm, "
              f"synchronised) on {ident}")

    ms, plain = kres["timings"]["9216x5120 live prefix 1786"]
    print(json.dumps({"kernels": [{
        "name": "radius_count", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": kres["max_abs_err"], "ms": ms, "plain_ms": plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
