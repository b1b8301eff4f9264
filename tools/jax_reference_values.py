#!/usr/bin/env python3
"""The JAX package's answers that ``chip_smoke.py`` records as
``JAX_REFERENCE_*``: the machine with the card has no JAX, so they are
taken once on a CPU and written into the script.

    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values neural
    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values scan 3000000
    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values sequence
    JAX_PLATFORMS=cpu python3 -m tools.jax_reference_values train [--fused]

``neural`` serves the shipped checkpoint through the JAX package's
``NeuralPipeline(use_pallas=False)``, a fresh pipeline for each cloud (the
over-capacity subset is the first draw of its numpy stream). ``scan N``
runs the JAX package's ``Pipeline().analyze(scaled_venue(N))``; at
3,000,000 points it needs about 15 GB and some minutes. ``sequence`` runs
``Pipeline().analyze_sequence`` on ``BASELINE.md`` config 3 as
``benchmarks/temporal.py`` builds it (4 frames of 100,000 points, 500
people, dt 0.5 s), and each frame's person-like people under the capacity
config that ``analyze_sequence`` fits to the largest frame. ``train``
takes 3 steps of the JAX package's ``train_step`` at the default
``TrainConfig`` (4 x 8,192 points) from the port's seeded weights
(``init_state`` of the port, carried across by ``flax_from_params``; their
``weights_digest`` is printed) with
``optax.adamw`` on ``make_batch(RandomState(0))``'s batches, and prints
each step's loss and the first step's gradient norms; ``--fused`` runs the
JAX package's kernel path (``use_pallas=True``, its Pallas kernels in
interpret mode), the path the port's CrowdNet mirrors, instead of its jnp
path.
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


def sequence() -> None:
    from lidar_ai_recommendation_software_tpu.pipeline import (
        Pipeline, people_of_cloud)
    from lidar_ai_recommendation_software_tpu.synthetic import venue_sequence
    from lidar_ai_recommendation_software_tpu.types import PointCloud
    n, dt = 100_000, 0.5
    extent = (n / 10_000) ** 0.5 * 15.0
    frames = venue_sequence(n_frames=4, dt=dt, n_points=n, n_people=500,
                            extent=extent, speed=1.0)
    pipe = Pipeline()
    t0 = time.time()
    out = pipe.analyze_sequence(frames, dt=dt)
    seconds = time.time() - t0
    f = out["flow"]
    # the frames' person-like people, as analyze_sequence extracts them
    # (no frame of this sequence overflows a capacity)
    offset = out["coordinate_offset"]
    cfg = pipe.fit_capacity(np.asarray(frames[0], np.float64) - offset)
    tracked = []
    for fr in frames:
        cloud = PointCloud.from_numpy(np.asarray(fr, np.float64) - offset,
                                      cfg.capacity.max_points)
        proc, ppl = people_of_cloud(cloud, cfg)
        assert int(proc.cluster_overflow) == 0 and int(ppl.overflow) == 0
        keep = ppl.person_like(pipe.config.flow.track_min_height,
                               proc.mins[2])
        tracked.append(int(keep.count))
    pos = np.asarray(f["flow_vectors"]["positions"])
    vec = np.asarray(f["flow_vectors"]["vectors"])
    gt = np.stack([extent - pos[:, 0], -pos[:, 1]], 1)
    gt /= np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-9)
    vn = np.linalg.norm(vec, axis=1)
    ok = vn > 0.05
    print("sequence", json.dumps({
        "people": out["density"]["total_people"], "tracked": tracked,
        "avg_speed": f["avg_speed"], "direction": f["dominant_direction"],
        "severities": [b["severity"] for b in f["bottlenecks"]],
        "flow_nodes": int(len(vec)),
        "cosine": float(np.mean(np.sum(vec[ok] / vn[ok, None] * gt[ok],
                                       axis=1))),
        "seconds": round(seconds, 1)}))


def train(fused: bool) -> None:
    import jax
    import jax.numpy as jnp
    import optax
    from lidar_ai_recommendation_software_tpu.models import train as jt
    from lidar_ai_recommendation_software_tpu_torch.models import (
        train as tt)
    cfg = jt.TrainConfig(use_pallas=fused)
    weights = tt.init_state(tt.TrainConfig(), device="cpu").model.state_dict()
    params = jax.tree_util.tree_map(jnp.asarray,
                                    tt.flax_from_params(weights))
    state = jt.TrainState.create(
        apply_fn=jt.make_model(cfg).apply, params=params,
        tx=optax.adamw(cfg.learning_rate, weight_decay=cfg.weight_decay))
    rng = np.random.RandomState(cfg.seed)
    losses, norms = [], {}
    t0 = time.time()
    for step in range(3):
        batch = {k: jnp.asarray(v) for k, v in jt.make_batch(rng, cfg).items()}
        if step == 0:
            _, grads = jax.jit(jax.value_and_grad(jt.loss_fn, has_aux=True),
                               static_argnums=(1, 3))(
                state.params, state.apply_fn, batch, cfg)
            norms = {"/".join(str(getattr(k, "key", k)) for k in path):
                     float(jnp.linalg.norm(g.ravel()))
                     for path, g in
                     jax.tree_util.tree_leaves_with_path(grads)}
        state, metrics = jt.train_step(state, batch, cfg)
        losses.append(float(metrics["loss"]))
    print("train", json.dumps({"fused": fused, "losses": losses,
                               "init_sha256": tt.weights_digest(weights),
                               "grad_norms": norms,
                               "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["neural"]:
        neural()
    elif sys.argv[1:2] == ["scan"] and len(sys.argv) == 3:
        scan(int(sys.argv[2]))
    elif sys.argv[1:2] == ["sequence"]:
        sequence()
    elif sys.argv[1:2] == ["train"] and sys.argv[2:] in ([], ["--fused"]):
        train(sys.argv[2:] == ["--fused"])
    else:
        sys.exit(__doc__)
