#!/usr/bin/env python3
"""``sa_mlp_pool`` and ``place_dense`` of two checkouts timed in turns on
one NVIDIA GPU: a checkout given on the command line (the older one) and
this one, in the order older, this, this, older, each in its own process
with its own kernels, wrappers and ``chip_smoke.py`` timing functions.

    python3 -m tools.kernel_ab OLDER_CHECKOUT      (from the repository root)

In each turn it takes the card's name and power limit, then graph ms
(``chip_smoke.graph_ms``), event ms (``chip_smoke.cuda_ms``) and the host
ms to issue a call (the wrapper's own cost) of:

  - ``sa_mlp_pool`` at the served model's two shapes in float32 and the
    100,000-point layer's in float32 and with bfloat16 operands, inputs
    from numpy seed 9;
  - ``place_dense`` on the 3,000,000-point scan's centroid pack (that
    checkout's own clustering of ``scaled_venue(3_000_000)``, by this
    checkout's ``chip_smoke.scan_3m_inputs``) and on the two streams of
    the same n of this checkout's ``synthetic.place_dense_cases``.

Then a table of the four turns. (``chip_smoke.py`` prints the kernels'
bounds.) Each turn runs in a subprocess from its checkout's root, which
must be the package it imports. Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SA_TIMED = (("served SA1", ("float32",)), ("served SA2", ("float32",)),
            ("100,000-point layer", ("float32", "bfloat16")))


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _host_ms(fn, iters: int = 20) -> float:
    """Mean host milliseconds to issue one call of ``fn`` (no wait for the
    device between calls), after a warm-up."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return host


def _turn() -> dict:
    """The times of the checkout this process runs in (its root is the
    working directory)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S
    import lidar_ai_recommendation_software_tpu_torch as port
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        place, pointnet as P)
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline

    here = _load("synthetic_here", HERE / S.PORT / "synthetic.py")
    dev = torch.device("cuda", 0)
    out = {"card": S.gpu_identity(), "package": port.__file__}
    rng = np.random.RandomState(9)
    shapes = {name: (m, cin, hidden) for name, m, cin, hidden in S.SA_SHAPES}
    for name, dtypes in SA_TIMED:
        m, cin, hidden = shapes[name]
        g = torch.from_numpy((rng.randn(m, 32, cin) * 0.3)
                             .astype(np.float32)).to(dev)
        v = torch.from_numpy(rng.rand(m, 32) > 0.3).to(dev)
        w = S.sa_weights(rng, cin, hidden, dev)
        for dtype in dtypes:
            dt = getattr(torch, dtype)

            def call(g=g, v=v, w=w, dt=dt):
                return P.sa_mlp_pool(g, v, w, compute_dtype=dt)

            out[f"sa_mlp_pool {name} {dtype}"] = (
                S.graph_ms(call), S.cuda_ms(call), _host_ms(call))

    # this checkout's helper, run on the turn's package
    smoke = _load("smoke_here", HERE / "chip_smoke.py")
    streams = [("3M scan", *smoke.scan_3m_inputs(Pipeline(device="cuda")))]
    for name, *arrays, kk in here.place_dense_cases()[:2]:
        streams.append((name, *(torch.from_numpy(x).to(dev)
                                for x in arrays), kk))
    for name, ids, valid, chans, kk in streams:
        def call(ids=ids, valid=valid, chans=chans, kk=kk):
            return place.place_dense(ids, valid, chans, kk)

        out[f"place_dense {name}"] = (S.graph_ms(call), S.cuda_ms(call),
                                      _host_ms(call))
    return out


def main() -> int:
    if len(sys.argv) == 2 and sys.argv[1] == "--turn":
        print(json.dumps(_turn()))
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    older = Path(sys.argv[1]).resolve()
    turns = []
    for root in (older, HERE, HERE, older):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--turn"], cwd=root, capture_output=True,
                             text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        turns.append(json.loads(res.stdout.strip().splitlines()[-1]))
        if not Path(turns[-1]["package"]).is_relative_to(root):
            print(f"kernel_ab: the turn in {root} imported "
                  f"{turns[-1]['package']}", file=sys.stderr)
            return 1
        print(f"turn {len(turns)}: {root}, {turns[-1]['card']}", flush=True)
    names = ("older", "this", "this", "older")
    print("graph ms (events ms; host ms to issue) | " + " | ".join(names))
    for key in turns[0]:
        if key in ("card", "package"):
            continue
        print(f"{key} | " + " | ".join(
            f"{t[key][0]:.6f} ({t[key][1]:.6f}; {t[key][2]:.6f})"
            for t in turns))
    return 0


if __name__ == "__main__":
    sys.exit(main())
