#!/usr/bin/env python3
"""The JAX package's answers that ``chip_smoke.py`` records as
``JAX_REFERENCE_*``: the machine with the card has no JAX, so they are
taken once on a CPU and written into the script.

    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values neural
    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values scan 3000000

``neural`` serves the shipped checkpoint through the JAX package's
``NeuralPipeline(use_pallas=False)``, a fresh pipeline for each cloud (the
over-capacity subset is the first draw of its numpy stream). ``scan N``
runs the JAX package's ``Pipeline().analyze(scaled_venue(N))``; at
3,000,000 points it needs about 15 GB and some minutes.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def neural() -> None:
    from lidar_ai_recommendation_software_tpu.neural import NeuralPipeline
    from lidar_ai_recommendation_software_tpu.synthetic import sample_venue
    for name, pts in (
            ("4096", sample_venue(n_points=4096, n_people=50, seed=42)),
            ("fixture", sample_venue())):
        out = NeuralPipeline(use_pallas=False).analyze(pts)
        d, f = out["density"], out["flow"]
        print(name, json.dumps({
            "people": d["total_people"], "max_density": d["max_density"],
            "avg_density": d["avg_density"], "n_hotspots": len(d["hotspots"]),
            "avg_speed": f["avg_speed"], "direction": f["dominant_direction"],
            "severities": [b["severity"] for b in f["bottlenecks"]],
            "max_congestion": out["congestion"]["max"],
            "density_sum": float(d["density_map"].sum(dtype=np.float64))}))


def scan(n: int) -> None:
    from lidar_ai_recommendation_software_tpu.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu.synthetic import scaled_venue
    pts = scaled_venue(n)
    t0 = time.time()
    out = Pipeline().analyze(pts)
    d, f = out["density"], out["flow"]
    print(n, json.dumps({
        "people": d["total_people"],
        "n_clusters": int(out["processed"].n_clusters),
        "max_density": d["max_density"], "avg_density": d["avg_density"],
        "direction": f["dominant_direction"],
        "severities": [b["severity"] for b in f["bottlenecks"]],
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["neural"]:
        neural()
    elif sys.argv[1:2] == ["scan"] and len(sys.argv) == 3:
        scan(int(sys.argv[2]))
    else:
        sys.exit(__doc__)
