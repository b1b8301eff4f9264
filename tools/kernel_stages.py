#!/usr/bin/env python3
"""Where the time of ``sa_mlp_pool`` and ``place_dense`` goes on one NVIDIA
GPU: each kernel replayed from a CUDA graph (``chip_smoke.graph_ms``) with
its source cut short after each of its stages.

    python3 -m tools.kernel_stages [--root CHECKOUT] [KERNEL ...]

(from the repository root; KERNEL is ``sa_mlp_pool`` or ``place_dense``,
both when none is named). ``--root``
reads the kernels' sources from another checkout of the repository, so
that an earlier design can be cut with the same inputs; the cuts are
picked by which design's anchors the source holds.

It prints the card's name and power limit, then graph ms of each variant:

  - ``sa_mlp_pool`` at the served model's two shapes (512 x 32 x 3 -> 64,
    128 x 32 x 67 -> 128) and the 100,000-point layer's (4,096 x 32 x 3 ->
    64), float32: the weights and the tile's rows staged only, then each
    layer more, then the whole kernel, and the whole kernel with another
    tiling;
  - ``place_dense`` on the 3,000,000-point scan's centroid pack and on
    ``synthetic.place_dense_cases``' two streams of the same n (one with a
    run of 1,000,000 invalid rows): the zeros alone, the rows alone, the
    whole kernel, with the bound of what any implementation must move
    beside it and the first design's bound.

Each variant is the source with one change made in its text (an anchor
that is not found exactly once stops the run), built by its own ``nvcc``,
all at once, into ``_build/kernel_stages/`` inside the package. The whole
kernel is held to its plain version before it is timed (``place_dense``
bit-equal, ``sa_mlp_pool`` within ``chip_smoke.SA_F32_TOL``); the cut
ones are timed only. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tools.variants import build, swap


def _cut_after(anchor: str, alive: str, out: str = "out",
               wait: str = "") -> tuple:
    """(anchor, replacement): the kernel ends right after ``anchor`` (and
    ``wait``); what was computed is kept alive by a store to ``out`` that
    never happens."""
    return anchor, (f"{anchor}{wait}  if ({alive} < -1.0f) {out}[0] = 0.0f;"
                    f"\n  return;\n")


_LANDED = "  cp_wait<0>();\n  __syncthreads();\n"


# source -> design -> stage -> (anchor, its replacement), or None for the
# whole kernel
DESIGNS = {
    "sa_mlp_pool.cu": {
        "one block a tile of 128 rows in shared memory": {
            "staging": _cut_after(
                "  for (int i = tid; i < rows; i += kThreads) sval[i] = v[i];"
                "\n  __syncthreads();\n", "buf_a[tid] + sval[0]"),
            "layer 1": _cut_after(
                "  layer<kBf16>(buf_a, l.lda, cin, sw1, sb1, h1, buf_b, "
                "l.ldb, rows);\n  __syncthreads();\n", "buf_b[tid]"),
            "layers 1-3": _cut_after(
                "  layer<false>(buf_a, l.lda, h2, sw3, sb3, cout, buf_b, "
                "l.ldb, rows);\n  __syncthreads();\n", "buf_b[tid]"),
            "whole": None,
        },
        "tiles of 32 or 128 rows, the pool in registers": {
            "staging": _cut_after("  cp_commit();\n\n", "smem[l.x + "
                                  "threadIdx.x]", "a.out", _LANDED),
            "layer 1": _cut_after("h1, smem + l.a1, l.ld1, rows);\n",
                                  "smem[l.a1 + threadIdx.x]", "a.out",
                                  _LANDED),
            "layer 2": _cut_after("h2, smem + l.x, l.ld2, rows);\n",
                                  "smem[l.x + threadIdx.x]", "a.out",
                                  _LANDED),
            "whole": None,
            "whole, no wide tiles": (
                "constexpr int kSplitBlocks = 1056;",
                "constexpr int kSplitBlocks = 1 << 30;"),
            "whole, wide items of 4 pieces": (
                "constexpr int kWideRows = 2;",
                "constexpr int kWideRows = 4;"),
        },
    },
    "place_dense.cu": {
        "a zero pass and a row pass": {
            "zero pass": ("  if (n > 0 && kp > 0) {",
                          "  if (false && n > 0 && kp > 0) {"),
            "row pass": ("  if (total > 0) {", "  if (false && total > 0) {"),
            "whole": None,
        },
        "one launch: zero blocks, then row blocks that wait to store": {
            "zero blocks": (
                "  const int row_blocks = (n + kBlockRows - 1) / kBlockRows;",
                "  const int row_blocks = 0;"),
            "row blocks": (
                "    zeros(out, static_cast<int64_t>(nch + 1) * kp, "
                "zero_blocks);",
                "    if (threadIdx.x == 0) atomicAdd(&g_zeros_done, 1u);"),
            "whole": None,
            "whole, zeros by 1,056 blocks": (
                "constexpr int kZeroBlocks = 264;",
                "constexpr int kZeroBlocks = 1056;"),
        },
    },
}
# a stage whose name starts so computes the whole function
WHOLE = "whole"
LAUNCH = {"sa_mlp_pool.cu": "sa_mlp_pool_launch",
          "place_dense.cu": "place_dense_launch"}
SA_TIMED = ("served SA1", "served SA2", "100,000-point layer")


def design_of(name: str, src: str) -> str:
    """The design of ``DESIGNS[name]`` whose every anchor is in ``src``
    exactly once."""
    for design, stages in DESIGNS[name].items():
        if all(cut is None or src.count(cut[0]) == 1
               for cut in stages.values()):
            return design
    raise SystemExit(f"kernel_stages: {name} matches no known design")


def variants(name: str, src: str) -> dict:
    """stage -> (source, computes the whole function) of the design
    ``src`` holds."""
    stages = DESIGNS[name][design_of(name, src)]
    return {stage: (swap(src, *cut, "kernel_stages") if cut else src,
                    stage.startswith(WHOLE))
            for stage, cut in stages.items()}


def _sa(S, libs, dev) -> None:
    import numpy as np
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        pointnet as P)
    rng = np.random.RandomState(9)
    for name, m, cin, hidden in S.SA_SHAPES:
        if name not in SA_TIMED:
            continue
        g = torch.from_numpy((rng.randn(m, 32, cin) * 0.3)
                             .astype(np.float32)).to(dev)
        v = torch.from_numpy(rng.rand(m, 32) > 0.3).to(dev)
        w = S.sa_weights(rng, cin, hidden, dev)
        flat = [t.data_ptr() for wb in w for t in wb]
        out = torch.empty((m, hidden[-1]), dtype=torch.float32, device=dev)
        want = P.sa_mlp_pool_reference(g, v, w)
        times = {}
        for stage, lib in libs.items():
            def launch(lib=lib):
                err = lib.sa_mlp_pool_launch(
                    g.data_ptr(), v.data_ptr(), *flat, m, 32, cin, *hidden,
                    0, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{stage}: launch error {err}")
            if stage.startswith(WHOLE):
                launch()
                torch.cuda.synchronize()
                err = S.rel_err(out, want)
                S.require(err <= S.SA_F32_TOL,
                          f"sa_mlp_pool at the {name} off by {err}")
            times[stage] = S.graph_ms(launch)
        print(f"sa_mlp_pool {name} ({m} x 32 x {cin} -> {hidden[-1]}, "
              f"float32): " + ", ".join(f"{k} {t:.6f}"
                                        for k, t in times.items())
              + " ms (graph)", flush=True)


def _place(S, libs, dev) -> None:
    import torch
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
    from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
    from lidar_ai_recommendation_software_tpu_torch.synthetic import (
        place_dense_cases)
    streams = [("the 3M scan's centroid pack",
                *S.scan_3m_inputs(Pipeline(device="cuda")))]
    for name, ids, valid, chans, k in place_dense_cases()[:2]:
        streams.append((name, *(torch.from_numpy(x).to(dev)
                                for x in (ids, valid, chans)), k))
    for name, ids, valid, chans, k in streams:
        n, nch, kp = ids.shape[0], chans.shape[0], place.padded_slots(k)
        out = torch.empty((nch + 1, kp), dtype=torch.float32, device=dev)
        want = torch.cat([t[None] if t.ndim == 1 else t for t in
                          place.place_dense_reference(ids, valid, chans, k)])
        times = {}
        for stage, lib in libs.items():
            def launch(lib=lib):
                err = lib.place_dense_launch(
                    ids.data_ptr(), valid.data_ptr(), chans.data_ptr(), n,
                    nch, kp, out.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if err:
                    raise RuntimeError(f"{stage}: launch error {err}")
            if stage.startswith(WHOLE):
                launch()
                torch.cuda.synchronize()
                S.require(torch.equal(out.view(torch.int32),
                                      want.view(torch.int32)),
                          f"place_dense differs at {name}")
            times[stage] = S.graph_ms(launch)
        n_valid = int(valid.sum())
        needed = S.bound(S.place_needed_bytes(ids, valid, nch, kp), 0)[0]
        old = S.bound(5 * n + 4 * nch * n_valid + 4 * (nch + 1) * kp, 0)[0]
        print(f"place_dense {name} ({n} rows, {n_valid} valid, {nch} "
              f"channels, K' {kp}): " + ", ".join(
                  f"{k} {t:.6f}" for k, t in times.items())
              + f" ms (graph); bound {old:.6f} ms, needed {needed:.6f} ms",
              flush=True)
        del ids, valid, chans, out, want
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    args = argparse.ArgumentParser()
    args.add_argument("--root", type=Path, default=None)
    args.add_argument("kernels", nargs="*",
                      choices=["sa_mlp_pool", "place_dense"])
    opts = args.parse_args()
    if not torch.cuda.is_available():
        print("kernel_stages: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    print(S.gpu_identity())
    csrc = (opts.root / S.PORT / "csrc" if opts.root else kernels.CSRC_DIR)
    wanted = opts.kernels or ["sa_mlp_pool", "place_dense"]
    dev = torch.device("cuda", 0)
    built = {}
    for kernel in wanted:  # every variant of both, built at once
        src = (csrc / f"{kernel}.cu").read_text()
        print(f"{kernel}: {csrc / f'{kernel}.cu'}, design "
              f"\"{design_of(f'{kernel}.cu', src)}\"")
        built[kernel] = variants(f"{kernel}.cu", src)
    libs = build("kernel_stages", {f"{k} {s}": v for k, vs in built.items()
                                   for s, v in vs.items()},
                 tuple(LAUNCH.values()))
    for kernel in wanted:
        mine = {s: libs[f"{kernel} {s}"] for s in built[kernel]}
        (_sa if kernel == "sa_mlp_pool" else _place)(S, mine, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
