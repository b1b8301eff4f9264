#!/usr/bin/env python3
"""Run-to-run variance of CrowdNet's BEV cell sums on one NVIDIA GPU:
each prefix scan they use, reruns of it on the same input compared bit
for bit with its first result.

    python3 -m tools.scan_determinism      (from the repository root)

The cell sums (``models/crowdnet.py::_segment_sums``) take a float64
inclusive prefix of the cell-sorted values and differences at the cells'
ends. The pillar z sums give it one lone row of batch x points values.
Two scans of such a row are compared:

  - ``torch.cumsum`` of the lone row, which PyTorch hands to CUB's
    device-wide scan;
  - ``_row_prefix_sums``, which scans it beside a row of zeros, in
    PyTorch's row-scan kernel.

For each: the float64 prefix of one lone row (the pillar z values of the
first ``TrainConfig()`` batch, 4 x 8,192), ``PREFIX_RERUNS`` reruns; the
float32 pillar sums of ``BATCHES`` batches, ``SUM_RERUNS`` reruns each;
``RUNS`` training runs of 3 steps from the seeded ``init_state``, losses
and every parameter against the first run's. One JSON line a scan, after
the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.models import crowdnet, train

PREFIX_RERUNS = 3000
BATCHES, SUM_RERUNS = 25, 100
RUNS, STEPS = 12, 3


def _lone_row_cumsum(cols: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(cols.contiguous(), 1)


def _differing(fn, reruns: int) -> int:
    first = fn()
    return sum(int(not torch.equal(fn(), first)) for _ in range(reruns))


def _pillar_inputs(batch):
    flat = crowdnet._bev_cells(batch["points"][..., :2], batch["mask"],
                               train.TrainConfig().grid, batch["venue_min"],
                               batch["venue_size"])
    z = batch["points"][..., 2] * batch["mask"].to(torch.float32)
    return z[..., None], flat


def _training_run(cfg):
    state = train.init_state(cfg, device="cuda")
    rng = np.random.RandomState(cfg.seed)
    losses = [float(train.train_step(state, train.batch_tensors(
        train.make_batch(rng, cfg), "cuda"), cfg)["loss"])
        for _ in range(STEPS)]
    return losses, [p.detach().clone() for p in state.model.parameters()]


def measure(scan) -> dict:
    """The three readings with ``scan`` as the cell sums' row scan."""
    cfg = train.TrainConfig()
    crowdnet._row_prefix_sums, kept = scan, crowdnet._row_prefix_sums
    try:
        rng = np.random.RandomState(cfg.seed)
        batches = [train.batch_tensors(train.make_batch(rng, cfg), "cuda")
                   for _ in range(BATCHES)]
        z, _ = _pillar_inputs(batches[0])
        row = z.reshape(1, -1).to(torch.float64)
        prefix = _differing(lambda: scan(row), PREFIX_RERUNS)
        sums = 0
        for batch in batches:
            z, flat = _pillar_inputs(batch)
            sums += _differing(
                lambda: crowdnet._segment_sums(z, flat, cfg.grid),
                SUM_RERUNS)
        t0 = time.perf_counter()
        first_losses, first_params = _training_run(cfg)
        runs = 0
        for _ in range(RUNS - 1):
            losses, params = _training_run(cfg)
            runs += int(losses != first_losses or not all(
                torch.equal(p, q) for p, q in zip(params, first_params)))
        return {"prefix_rows": list(row.shape),
                "prefix_differing": prefix, "prefix_reruns": PREFIX_RERUNS,
                "pillar_sums_differing": sums,
                "pillar_sums_reruns": BATCHES * SUM_RERUNS,
                "training_runs_differing": runs,
                "training_runs_compared": RUNS - 1,
                "training_runs_s": time.perf_counter() - t0}
    finally:
        crowdnet._row_prefix_sums = kept


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    for name, scan in (("torch.cumsum, lone row", _lone_row_cumsum),
                       ("_row_prefix_sums", crowdnet._row_prefix_sums)):
        print(json.dumps({"scan": name, **measure(scan)}), flush=True)


if __name__ == "__main__":
    main()
