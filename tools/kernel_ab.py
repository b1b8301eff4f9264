#!/usr/bin/env python3
"""``sa_mlp_pool``, ``place_dense`` and ``table_fill`` of two checkouts
timed in turns on one NVIDIA GPU: a checkout given on the command line (the
older one) and this one, in the order older, this, this, older, each in its
own process with its own kernels, wrappers and ``chip_smoke.py`` timing
functions.

    python3 -m tools.kernel_ab OLDER_CHECKOUT [KERNEL ...]   (from the root)

KERNEL names the kernels to time (all three by default).

In each turn it takes the card's name and power limit, then graph ms
(``chip_smoke.graph_ms``), event ms (``chip_smoke.cuda_ms``) and the host
ms to issue a call (the wrapper's own cost) of:

  - ``sa_mlp_pool`` at the served model's two shapes in float32 and the
    100,000-point layer's in float32 and with bfloat16 operands, inputs
    from numpy seed 9;
  - ``place_dense`` on the 3,000,000-point scan's centroid pack (that
    checkout's own clustering of ``scaled_venue(3_000_000)``, by this
    checkout's ``chip_smoke.scan_3m_inputs``) and on the two streams of
    the same n of this checkout's ``synthetic.place_dense_cases``;
  - ``table_fill`` on the clustering inputs of the 262,144-, 1M- and
    3M-point scans, the temporal sequence's first frame and the 10M-point
    scan's buffer (this checkout's ``chip_smoke.scan_case``, made once and
    handed to every turn), held bit-equal to the turn's own plain version
    first.

Then a table of the four turns, and ``table_fill``'s bound (this
checkout's ``column_kernel_work``) and each turn's share of it. Each turn
runs in a subprocess from its checkout's root, which must be the package
it imports. Needs a CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SA_TIMED = (("served SA1", ("float32",)), ("served SA2", ("float32",)),
            ("100,000-point layer", ("float32", "bfloat16")))
TIMED = ("sa_mlp_pool", "place_dense", "table_fill")


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


def _fill_cases(out_dir: Path) -> list:
    """The clustering inputs ``table_fill`` is timed on, saved once as
    ``.npz`` files for the turns: their paths."""
    import numpy as np

    import chip_smoke as S
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    cases = [(n, name) for n, name in S.COLUMN_SCANS]
    cases += [(None, S.SEQUENCE_FRAME), (10_000_000, "10M scan's buffer")]
    paths = []
    for n, name in cases:
        cloud = scaled_venue(n) if n else S.sequence_frames()[1][0]
        _, pts, mask, eps, _, ncx, ncy, cap = S.scan_case(name, cloud)
        paths.append(out_dir / f"fill{len(paths)}.npz")
        np.savez(paths[-1], name=name, pts=pts, mask=mask, eps=eps, ncx=ncx,
                 ncy=ncy, cap=cap)
    return paths


def _fill_turn(S, dev, fill_cases: list) -> dict:
    """``table_fill``'s times in the turn's checkout, and the sizes of its
    cases (stream positions, slots, placed points, columns)."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    out = {"sizes": {}}
    for path in fill_cases:
        case = np.load(path)
        name, cap = str(case["name"]), int(case["cap"])
        ncx, ncy = int(case["ncx"]), int(case["ncy"])
        p = torch.from_numpy(case["pts"]).to(dev)
        m = torch.from_numpy(case["mask"]).to(dev)
        order, scid, cell_start = ccl.sorted_stream(p, m, float(case["eps"]),
                                                    ncx, ncy)
        ncells = (ncx + 2) * (ncy + 2)
        args = (p, order, scid, cell_start, ncells, cap)
        got = C.table_fill(*args)
        want = C.table_fill_reference(*args)
        S.require(torch.equal(got[0].view(torch.int32),
                              want[0].view(torch.int32)) and all(
            torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
            f"table_fill differs from its plain version: {name}")
        out["sizes"][name] = (p.shape[0], ncells * cap,
                              int((want[2] >= 0).sum()), ncells)
        del got, want

        def call(args=args):
            return C.table_fill(*args)

        out[f"table_fill {name}"] = (S.graph_ms(call), S.cuda_ms(call),
                                     _host_ms(call))
        del call, args, p, m, order, scid, cell_start
        torch.cuda.empty_cache()
    return out


def _sa_turn(S, dev) -> dict:
    """``sa_mlp_pool``'s times in the turn's checkout."""
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)
    out = {}
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
    return out


def _place_turn(S, dev) -> dict:
    """``place_dense``'s times in the turn's checkout."""
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    out = {}
    here = _load("synthetic_here", HERE / S.PORT / "synthetic.py")
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


def _turn(timed: list, fill_cases: list) -> dict:
    """The times of the checkout this process runs in (its root is the
    working directory)."""
    import torch

    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as S
    import lidar_ai_recommendation_software_tpu_torch as port

    dev = torch.device("cuda", 0)
    out = {"card": S.gpu_identity(), "package": port.__file__, "sizes": {}}
    if "table_fill" in timed:
        out.update(_fill_turn(S, dev, fill_cases))
    if "sa_mlp_pool" in timed:
        out.update(_sa_turn(S, dev))
    if "place_dense" in timed:
        out.update(_place_turn(S, dev))
    return out


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--turn":
        job = json.loads(sys.argv[2])
        print(json.dumps(_turn(job["timed"], job["fill_cases"])))
        return 0
    timed = sys.argv[2:] or list(TIMED)
    if len(sys.argv) < 2 or not set(timed) <= set(TIMED):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
        column_kernel_work)

    import chip_smoke as S
    older = Path(sys.argv[1]).resolve()
    tmp = tempfile.TemporaryDirectory()
    fill_cases = (_fill_cases(Path(tmp.name)) if "table_fill" in timed
                  else [])
    job = json.dumps({"timed": timed,
                      "fill_cases": [str(p) for p in fill_cases]})
    turns = []
    for root in (older, HERE, HERE, older):
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--turn", job], cwd=root, capture_output=True,
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
    tmp.cleanup()
    names = ("older", "this", "this", "older")
    print("graph ms (events ms; host ms to issue) | " + " | ".join(names))
    for key in turns[0]:
        if key in ("card", "package", "sizes"):
            continue
        print(f"{key} | " + " | ".join(
            f"{t[key][0]:.6f} ({t[key][1]:.6f}; {t[key][2]:.6f})"
            for t in turns))
    for name, (n, slots, placed, ncells) in turns[0]["sizes"].items():
        b_ms, b_by = S.bound(*column_kernel_work(
            n, slots, placed, ncells, 0, 0, 0, 0)["table_fill"])
        shares = [b_ms / t[f"table_fill {name}"][0] for t in turns]
        print(f"table_fill {name}: N {n}, {slots} slots, {placed} placed; "
              f"bound {b_ms:.6f} ms ({b_by}); share of it on the graph clock "
              + " | ".join(f"{x:.1%}" for x in shares))
    return 0


if __name__ == "__main__":
    sys.exit(main())
