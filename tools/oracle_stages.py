#!/usr/bin/env python3
"""Per-stage seconds of the CPU oracle's ``analyze`` (monolith) on
``bench.py``'s baseline cloud, ``scaled_venue(100_000)``, on this host's
clock: the JAX package's oracle (NumPy and scikit-learn) and the port's
(NumPy and SciPy), in turns (jax, port, port, jax, ...), so both are
measured on one host in one process.

    python3 -m tools.oracle_stages

Each run prints preprocess, density and flow (the three calls ``analyze``
makes) and the whole; then ``people_positions`` alone, which density and
flow each call once. The last line is the medians as JSON. It needs the
JAX package and scikit-learn, so it runs where they are installed, not on
the card's machine; there ``chip_smoke.py`` times the port's oracle
through ``stages`` below.
"""

from __future__ import annotations

import json
import statistics
import time

# bench.py's CPU baseline cloud: scaled_venue(LIDAR_BENCH_CPU_POINTS)
POINTS = 100_000
REPS = 4


def stages(ref, cloud) -> tuple[dict, dict]:
    """``ref.analyze(cloud, "monolith")`` one stage at a time: the seconds
    of each stage and of the whole, and ``analyze``'s result."""
    t0 = time.perf_counter()
    processed = ref.preprocess(cloud, variant="monolith")
    t1 = time.perf_counter()
    density = ref.density_analysis(processed, mode="radius")
    t2 = time.perf_counter()
    flow = ref.flow_analysis(processed, variant="monolith")
    t3 = time.perf_counter()
    seconds = {"preprocess": t1 - t0, "density": t2 - t1, "flow": t3 - t2,
               "whole": t3 - t0}
    return seconds, {"processed": processed, "density": density,
                     "flow": flow}


def main() -> None:
    from lidar_ai_recommendation_software_tpu.oracle import (
        reference as jax_ref)
    from lidar_ai_recommendation_software_tpu_torch.oracle import (
        reference as port_ref)
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        scaled_venue)

    oracles = {"jax": jax_ref, "port": port_ref}
    cloud = scaled_venue(POINTS)
    runs = {name: [] for name in oracles}
    order = list(oracles)
    for rep in range(REPS):
        for name in (order if rep % 2 == 0 else order[::-1]):
            got, out = stages(oracles[name], cloud)
            t0 = time.perf_counter()
            oracles[name].people_positions(out["processed"])
            got["people_positions"] = time.perf_counter() - t0
            runs[name].append(got)
            print(f"{name} oracle, {POINTS:,} points: "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in got.items()),
                  flush=True)
    medians = {name: {k: statistics.median(r[k] for r in rs)
                      for k in rs[0]} for name, rs in runs.items()}
    print(json.dumps({"points": POINTS, "reps": REPS, "median_s": medians}))


if __name__ == "__main__":
    main()
