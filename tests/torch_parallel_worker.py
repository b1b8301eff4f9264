"""The rank cases of ``tests/test_torch_parallel.py``: run by each of the
ranks that ``parallel.mesh.spawn`` starts, on the CPU over gloo. The
module imports numpy, torch and the port only, so a rank imports nothing
of JAX, though the test that starts it does. Each rank writes its results
to ``rank{r}.npz`` in the output directory."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.parallel import (
    cluster, mesh as pmesh, spatial, trainer)


def _density(m, inp, cfg):
    return spatial.gather_stripes(spatial.sharded_radius_density(
        inp["people"], inp["people_mask"], inp["origin"], inp["nx"],
        inp["ny"], cfg, m), m).numpy()


# steps of the sharded training cases: the second and third update read
# the sliced AdamW moments
TRAIN_STEPS = 3


def _train(out, tag, cfg, axes, params, batch):
    m = pmesh.make_mesh(axes, device="cpu")
    state = trainer.sharded_init(cfg, m, params)
    out[f"{tag}_shard_numel"] = np.array(
        [state.shards[n].numel() for n in state.dims])
    step = trainer.make_sharded_train_step(cfg, m)
    for t in range(TRAIN_STEPS):
        metrics = step(state, batch)
        out[f"{tag}_loss{t}"] = metrics["loss"].numpy()
        for name, p in state.model.named_parameters():
            # copies: the next step writes the parameters in place
            out[f"{tag}_grad{t}:{name}"] = p.grad.numpy().copy()
            out[f"{tag}_param{t}:{name}"] = p.detach().numpy().copy()


def run_cases(rank: int, outdir: str, inp: dict) -> None:
    out = {"jax_modules": np.array(sorted(
        k for k in sys.modules
        if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                               "lidar_ai_recommendation_software_tpu")))}
    sp = pmesh.spatial_mesh(device="cpu")
    out["sp_coord"] = np.array(sp.coords["sp"])
    tm = pmesh.train_mesh(device="cpu")
    out["train_mesh"] = np.array([tm.shape["dp"], tm.shape["mp"]])

    # the halo round trip: rows 8r..8r+7 of 0..31 on rank r
    x = torch.arange(32.0).reshape(32, 1)[8 * rank:8 * rank + 8]
    out["halo"] = spatial.gather_stripes(
        spatial.halo_exchange_x(x, 2, sp)[None], sp).numpy()

    cfg = inp["cfg"]
    out["density"] = _density(sp, inp, cfg)
    out["density_rounding"] = _density(sp, inp["rounding"],
                                       inp["rounding_cfg"])
    flow = spatial.sharded_flow_and_bottlenecks(
        inp["mins"], inp["maxs"], inp["uniforms"], cfg, sp)
    for name, v in zip(("vectors", "mags", "valid", "sev", "ok"), flow):
        out[f"flow_{name}"] = spatial.gather_stripes(v, sp).numpy()

    venue, rope = inp["venue"], inp["rope"]
    out["venue"] = cluster.sharded_dbscan(venue, 0.4, 5, sp)
    out["venue_cap64"] = cluster.sharded_dbscan(venue, 0.4, 5, sp,
                                                column_cap=64)
    out["rope"] = cluster.sharded_dbscan(rope, 0.3, 3, sp)
    out["venue_200k"] = cluster.sharded_dbscan(inp["venue_200k"], 0.3, 5,
                                               sp)
    part = cluster.partition_stripes(rope, 4, 0.3)
    row = [a[rank] for a in part + cluster.boundary_maps(rope, 4, 0.3,
                                                           part[3])]
    try:
        cluster.sharded_dbscan_labels(*row, 0.3, 3, sp, "sp", 128, 32, 8,
                                      max_rounds=1)
    except RuntimeError as e:  # the case's expected outcome
        out["round_budget"] = np.array(str(e))
    out["exchanges"] = np.array(sp.stats.calls)

    tcfg, params, batch = inp["train_cfg"], inp["params"], inp["batch"]
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    _train(out, "dp2mp2", tcfg, (("dp", 2), ("mp", 2)), params, batch)
    _train(out, "dp4", tcfg, (("dp", 4), ("mp", 1)), params, batch)
    steps = trainer.run_sharded_steps(tcfg, tm, n_steps=TRAIN_STEPS)
    out["run_sharded_steps"] = np.array([steps[k] for k in sorted(steps)])
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
