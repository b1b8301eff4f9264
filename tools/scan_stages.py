#!/usr/bin/env python3
"""Where the column scan's time goes on one NVIDIA GPU: the graph times of
``column_counts`` and ``border_min`` (``csrc/column_neighbours.cu``,
``scan_kernel``) with the scan cut short after each of its stages, and at
other tile widths and windows.

    python3 -m tools.scan_stages     (from the repository root)

It prints the card's name and power limit. Then, on the clustering inputs
of ``chip_smoke.py``'s 262,144-, 1M- and 3M-point scans, the time of each
variant replayed from a CUDA graph (``chip_smoke.graph_ms``):

  - stages, each variant doing what the one before does and one stage
    more: ``launch`` (the blocks start and end), ``cell_start`` (each
    block reads cell_start over its three rows), ``prefix`` (the prefix
    sums of the occupancies and the stores of the unplaced positions),
    ``staged`` (the sub-tiles staged into shared memory, no pair test) and
    ``full`` (the pair tests: the scan as built);
  - tiles of 256 (as built), 512 and 1,024 columns, with the least window
    of 1,024 (as built), 2,048 or 4,096 slots.

Each variant is the source with one change made in its text (an anchor
that is not found exactly once stops the run), built by its own ``nvcc``,
all at once, into ``_build/scan_stages/`` inside the package. A variant
that computes the whole function is held bit-equal to the plain versions
before it is timed; the cut ones are timed only.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

# stage -> the text it replaces in the scan and what it puts there; each
# stage keeps the cuts of the stages after it out
_STAGES = {
    "launch": ("  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n  return;\n"),
    "cell_start": ("  __syncthreads();\n  auto occ = [&]",
                   "  __syncthreads();\n  if (cs[tid] < 0) out[0] = none;"
                   "\n  return;\n  auto occ = [&]"),
    "prefix": ("  for (int a = 1; a <= len;) {",
               "  return;\n  for (int a = 1; a <= len;) {"),
    "staged": ("    const int centres = cen[b + 1] - first;",
               "    a = b + 1;\n    continue;\n"
               "    const int centres = cen[b + 1] - first;"),
    "full": None,
}
# (tile columns, least window) variants; the scan as built, (256, 1024),
# is the stage "full"
_TILES = ((512, 1024), (512, 2048), (1024, 2048), (1024, 4096))
_SCANS = ("262,144-point scan", "1M scan", "3M scan")


def _variants(src: str) -> dict:
    """name -> (source, computes the whole function)."""

    def swap(text, old, new):
        if text.count(old) != 1:
            raise SystemExit(f"scan_stages: {old!r} is not in the source "
                             f"exactly once")
        return text.replace(old, new)

    out = {}
    for name, cut in _STAGES.items():
        out[f"stage {name}"] = (swap(src, *cut) if cut else src,
                                cut is None)
    for tile, window in _TILES:
        text = swap(src, "constexpr int kTileCols = 256;",
                    f"constexpr int kTileCols = {tile};")
        text = swap(text, "constexpr int kWindow = 1024;",
                    f"constexpr int kWindow = {window};")
        out[f"tile {tile} window {window}"] = (text, True)
    return out


def _build(variants: dict) -> dict:
    """name -> the loaded library of each variant, built all at once."""
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    out_dir = kernels.BUILD_DIR / "scan_stages"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = kernels._nvcc()
    jobs = {}
    for i, (name, (text, _)) in enumerate(variants.items()):
        src, so = out_dir / f"v{i}.cu", out_dir / f"v{i}.so"
        src.write_text(text)
        jobs[name] = (so, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"scan_stages: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn in ("column_counts_launch", "border_min_launch"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_stages: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels

    print(S.gpu_identity())
    variants = _variants(
        (kernels.CSRC_DIR / "column_neighbours.cu").read_text())
    libs = _build(variants)
    dev = torch.device("cuda", 0)
    for name, pts, mask, eps, min_samples, ncx, ncy, cap in S.column_cases():
        if name not in _SCANS:
            break
        p, m = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
        t = ccl.build_table(p, m, eps, ncx, ncy, cap)
        nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
        counts = C.column_counts_reference(*nb)
        labels = torch.where((t.stream_slot >= 0) & (counts >= min_samples),
                             t.order, C.INT_MAX)
        C.propagate(t.table, t.stream_slot, t.point_stream, t.py, cap, eps,
                    labels, S.max_sweeps())
        want = {"column_counts": counts,
                "border_min": C.border_min_reference(*nb, labels)}
        n = t.stream_slot.shape[0]
        r2 = float(C.eps_sq(eps))
        out = torch.empty(n, dtype=torch.int32, device=dev)
        times = {}
        for vname, lib in libs.items():
            for kernel in want:
                fn = getattr(lib, f"{kernel}_launch")

                def launch(fn=fn):
                    err = fn(t.table.data_ptr(), t.cell_start.data_ptr(), n,
                             ncx, t.py, cap, r2, labels.data_ptr(),
                             out.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"{vname}: {kernel} launch "
                                           f"error {err}")

                if variants[vname][1]:
                    launch()
                    torch.cuda.synchronize()
                    S.require(torch.equal(out, want[kernel]),
                              f"{vname}: {kernel} differs from its plain "
                              f"version at the {name}")
                times[vname, kernel] = S.graph_ms(launch)
            print(f"{name} {vname}: column_counts "
                  f"{times[vname, 'column_counts']:.6f} ms, border_min "
                  f"{times[vname, 'border_min']:.6f} ms (graph)")
        del p, m, t, nb, counts, labels, want, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
