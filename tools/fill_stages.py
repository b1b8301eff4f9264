#!/usr/bin/env python3
"""Where the column table's fill spends its time on one NVIDIA GPU:
``table_fill`` (``csrc/column_table.cu``) as built, with its tile store
made another way, at other tile sizes and grids, and cut short after its
stages.

    python3 -m tools.fill_stages     (from the repository root)

It prints the card's name and power limit. Then, on the clustering inputs
of ``chip_smoke.py``'s 262,144-, 1M- and 3M-point scans, the first frame
of its 100,000-point temporal sequence and the 10M-point scan's buffer
(``chip_smoke.scan_case``), the time of each variant replayed from a CUDA
graph (``chip_smoke.graph_ms``) and with CUDA events over direct calls
(``chip_smoke.cuda_ms``):

  - the tile's store: one bulk asynchronous copy marked evict-first in L2
    (as built), the same copy with no cache hint, or the block's threads
    storing it with streaming 16-byte stores (``__stcs``);
  - tiles of 1,024 or 512 slots, and 3, 6 or 8 blocks an SM (as built:
    2,048 slots, 3 blocks);
  - ``point_stream`` scattered with each tile (as built up to 2^21
    stream positions) or in a second walk after the tiles (as built above),
    the second walk over 1, 4 (as built) or 8 of the block's tiles at once;
  - each block's share of the points array prefetched into L2 (one bulk
    prefetch a block, evict-last or evict-normal) before its tiles;
  - stages: the tiles alone (every slot empty, no stream position read),
    no scatter of ``point_stream`` (the kernel's second loop), no gather
    of the points' coordinates, and no store of the table;

beside the kernel's bound (``utils/profiling.column_kernel_work``: bytes
over 3.35 TB/s) and, for scale, three PyTorch calls on the same data:
``fill_`` of a tensor of the table's bytes (the card's streaming store),
the gather ``points[order]`` and the scatter ``point_stream[order] = k``
(the kernel's two random accesses, each alone). Each variant is the source
with one change made in its text (``tools/variants.py``; an anchor that is
not found exactly once stops the run), built by its own ``nvcc``, all at
once. A variant that computes the whole function is held bit-equal to
``table_fill_reference`` on all four outputs before it is timed; the cut
ones are timed only. The last line is a JSON record of every number.

Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from tools.variants import build, swap

SHIPPED = "bulk copy, evict-first (as built)"
_BULK_HINTED = (
    '      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"\n'
    '      " [%0], [%1], %2, %3;"\n'
    '      :: "l"(dst), "r"(s), "r"(bytes), "l"(policy) : "memory");')
_BULK_PLAIN = (
    '      "cp.async.bulk.global.shared::cta.bulk_group"\n'
    '      " [%0], [%1], %2;"\n'
    '      :: "l"(dst), "r"(s), "r"(bytes) : "memory");')
_BULK_STORE = ("    if (tid == 0) {\n"
               "      bulk_store(a.table + static_cast<int64_t>(c0) * a.cap,"
               " buf,\n")
_STCS_STORE = ("    for (int s = threadIdx.x; s < slots; s += kThreads) {\n"
               "      __stcs(a.table + static_cast<int64_t>(c0) * a.cap + s,"
               " buf[s]);\n    }\n    if (false) {\n"
               "      bulk_store(a.table + static_cast<int64_t>(c0) * a.cap,"
               " buf,\n")
_GATHER = "  return make_float3(p[0], p[1], p[2]);\n"
# the stages' cuts: (first text cut, the text the cut ends before)
_PLACE = ("    for (int32_t k = kf; k < k1; k += kThreads) {",
          "    // the tile's shared-memory writes")
_AFTER = ("  // 2. point_stream of the large streams",
          "  if (tid == 0) {\n    asm volatile(\"cp.async.bulk.wait_group 0;\"")
_INLINE = ("        if (!kScatterAfter) a.point_stream[i] = k;\n",
           "        if (!kScatterAfter) a.point_stream[i] = -1;\n",
           "    if (!kScatterAfter) masked_chunk(a, t, valid_end);\n")
_UNROLL = "constexpr int kUnroll = 4;"
_START = "  int dropped = 0;  // the block's points past their column's cap\n"
# each block's share of the points array prefetched into L2 by one bulk
# prefetch before its tiles, under an L2 eviction priority
_PREFETCH = (
    "  if (tid == 0) {\n"
    "    uint64_t keep;\n"
    "    asm volatile(\"createpolicy.fractional.L2::%s.b64 %%0, 1.0;\"\n"
    "                 : \"=l\"(keep));\n"
    "    const int64_t bytes = 12 * static_cast<int64_t>(a.n);\n"
    "    const int64_t per = (bytes / gridDim.x + 15) / 16 * 16;\n"
    "    const int64_t lo = per * blockIdx.x;\n"
    "    const int64_t end = lo + per < bytes ? lo + per : bytes;\n"
    "    const uint32_t size = static_cast<uint32_t>((end - lo) / 16 * 16);\n"
    "    if (lo < bytes && size > 0) {\n"
    "      asm volatile(\n"
    "          \"cp.async.bulk.prefetch.L2.global.L2::cache_hint [%%0], %%1,"
    " %%2;\"\n"
    "          :: \"l\"(reinterpret_cast<const char*>(a.points) + lo),\n"
    "          \"r\"(size), \"l\"(keep) : \"memory\");\n"
    "    }\n"
    "  }\n")
_SWITCH = "constexpr int kScatterInlineMax = 1 << 21;"


def _sized(slots: int, per_sm: int) -> list:
    return [("swap", "constexpr int kTileSlots = 2048;",
             f"constexpr int kTileSlots = {slots};"),
            ("swap", "constexpr int kBlocksPerSm = 3;",
             f"constexpr int kBlocksPerSm = {per_sm};")]


# name -> (edits of the built source, tile slots, blocks an SM); an edit
# is ("swap", old, new) or ("cut", first text cut, the text it ends before)
_VARIANTS = {
    SHIPPED: ([], 2048, 3),
    "bulk copy, no cache hint": (
        [("swap", _BULK_HINTED, _BULK_PLAIN)], 2048, 3),
    "streaming stores (__stcs) by the block": (
        [("swap", _BULK_STORE, _STCS_STORE)], 2048, 3),
    "tiles of 1,024 slots, 3 blocks an SM": (_sized(1024, 3), 1024, 3),
    "tiles of 1,024 slots, 6 blocks an SM": (_sized(1024, 6), 1024, 6),
    "tiles of 512 slots, 8 blocks an SM": (_sized(512, 8), 512, 8),
    "point_stream scattered with each tile": (
        [("swap", _SWITCH, "constexpr int kScatterInlineMax = 1 << 30;")],
        2048, 3),
    "point_stream scattered after the tiles": (
        [("swap", _SWITCH, "constexpr int kScatterInlineMax = -1;")],
        2048, 3),
    "scatter after the tiles, 1 tile at once": (
        [("swap", _UNROLL, "constexpr int kUnroll = 1;")], 2048, 3),
    "scatter after the tiles, 8 tiles at once": (
        [("swap", _UNROLL, "constexpr int kUnroll = 8;")], 2048, 3),
    "points prefetched into L2, evict-last": (
        [("swap", _START, _START + _PREFETCH % "evict_last")], 2048, 3),
    "points prefetched into L2, evict-normal": (
        [("swap", _START, _START + _PREFETCH % "evict_normal")], 2048, 3),
    "stage: tiles only (no stream position)": (
        [("cut", *_PLACE), ("cut", *_AFTER)], 2048, 3),
    "stage: no scatter of point_stream": (
        [("cut", *_AFTER)] + [("swap", x, "") for x in _INLINE], 2048, 3),
    "stage: no gather of the points": (
        [("swap", _GATHER,
          "  return make_float3(0.f, 0.f, __int_as_float(i));\n")],
         2048, 3),
    "stage: no table store": ([("swap", _BULK_STORE, _BULK_STORE.replace(
        "if (tid == 0)", "if (false)"))], 2048, 3),
}
# the variants that compute the whole function
_WHOLE = {name for name in _VARIANTS if not name.startswith("stage: ")}


def _edited(src: str, edits: list) -> str:
    """``src`` with ``edits`` made in turn; a text not found exactly once
    stops the run."""
    for kind, old, new in edits:
        if kind == "swap":
            src = swap(src, old, new, "fill_stages")
            continue
        if src.count(old) != 1 or src.count(new) != 1:
            raise SystemExit(f"fill_stages: {old!r} or {new!r} is not in "
                             f"the source exactly once")
        src = src[:src.index(old)] + src[src.index(new):]
    return src


def _variants(src: str) -> dict:
    """name -> (source, tile slots, blocks an SM, computes the whole
    function)."""
    return {name: (_edited(src, edits), slots, per_sm, name in _WHOLE)
            for name, (edits, slots, per_sm) in _VARIANTS.items()}


def _blocks(ncells: int, cap: int, sms: int, slots: int, per_sm: int
            ) -> int:
    """The persistent grid of a variant: ``columns.fill_plan``'s rule at
    its tile size and blocks an SM."""
    tiles = -(-ncells // max(1, min(255, slots // cap)))
    return min(tiles, sms * per_sm)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fill_stages: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from lidar_ai_recommendation_software_tpu_torch import scaled_venue
    from lidar_ai_recommendation_software_tpu_torch.ops import ccl
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
        columns as C)
    from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
    from lidar_ai_recommendation_software_tpu_torch.utils.profiling import (
        column_kernel_work)

    dev = torch.device("cuda", 0)
    ident = S.gpu_identity()
    print(ident)
    sms = kernels._sm_count(dev)
    src = (Path(kernels.CSRC_DIR) / "column_table.cu").read_text()
    variants = _variants(src)
    libs = build("fill_stages", variants, ("table_fill_launch",))
    cases = [S.scan_case(name, scaled_venue(n)) for n, name in S.COLUMN_SCANS]
    cases.append(S.scan_case(S.SEQUENCE_FRAME, S.sequence_frames()[1][0]))
    cases.append(S.scan_case("10M scan's buffer", scaled_venue(10_000_000)))
    record = {"card": ident}
    for name, pts, mask, eps, _, ncx, ncy, cap in cases:
        p = torch.from_numpy(pts).to(dev)
        m = torch.from_numpy(mask).to(dev)
        order, scid, cell_start = ccl.sorted_stream(p, m, eps, ncx, ncy)
        ncells, n = (ncx + 2) * (ncy + 2), pts.shape[0]
        args = (p, order, scid, cell_start, ncells, cap)
        want = [w.view(torch.int32) if w.dtype == torch.float32 else w
                for w in C.table_fill_reference(*args)]
        n_occ = int((want[2] >= 0).sum())
        b_ms, b_by = S.bound(*column_kernel_work(
            n, ncells * cap, n_occ, ncells, 0, 0, 0, 0)["table_fill"])
        table = torch.empty((ncells * cap, 4), dtype=torch.float32,
                            device=dev)
        pst, ss = (torch.empty(n, dtype=torch.int32, device=dev)
                   for _ in range(2))
        ov = torch.empty((), dtype=torch.int32, device=dev)
        rec = {"n": n, "placed": n_occ, "slots": ncells * cap, "cap": cap,
               "bound_ms": b_ms, "bound_by": b_by,
               "plan": str(C.fill_plan(ncells, cap, n, sms))}
        fill = torch.empty_like(table)
        rec["fill_ of the table's bytes"] = {
            "graph_ms": S.graph_ms(lambda: fill.fill_(C.EMPTY_COORD))}
        del fill
        idx = order.long()
        ks = torch.arange(n, dtype=torch.int32, device=dev)
        rec["PyTorch gather points[order]"] = {
            "graph_ms": S.graph_ms(lambda: p.index_select(0, idx))}
        rec["PyTorch scatter point_stream[order] = k"] = {
            "graph_ms": S.graph_ms(lambda: pst.index_copy_(0, idx, ks))}
        del idx, ks
        wrapper = (lambda: C.table_fill(*args))
        rec["the wrapper"] = {"graph_ms": S.graph_ms(wrapper),
                              "ms": S.cuda_ms(wrapper)}
        for variant, lib in libs.items():
            _, slots, per_sm, whole = variants[variant]
            blocks = _blocks(ncells, cap, sms, slots, per_sm)

            def launch(lib=lib, blocks=blocks):
                kernels._raise_on(lib.table_fill_launch(
                    p.data_ptr(), order.data_ptr(), cell_start.data_ptr(),
                    n, ncells, cap, blocks, table.data_ptr(), pst.data_ptr(),
                    ss.data_ptr(), ov.data_ptr(), kernels._stream(dev)),
                    f"table_fill variant {variant}")

            if whole:
                launch()
                torch.cuda.synchronize()
                for got, w in zip((table.view(torch.int32), pst, ss, ov),
                                  want):
                    S.require(torch.equal(got, w), f"{variant} differs from "
                              f"the plain version: {name}")
            rec[variant] = {"graph_ms": S.graph_ms(launch),
                            "ms": S.cuda_ms(launch), "blocks": blocks}
        for what in rec:
            if isinstance(rec[what], dict):
                t = rec[what]
                print(f"{name}, {what}: {t['graph_ms']:.6f} ms from a CUDA "
                      f"graph" + (f", {t['ms']:.6f} ms with events"
                                  if "ms" in t else "")
                      + f"; {b_ms / t['graph_ms']:.1%} of the bound")
        print(f"{name}: N {n}, {n_occ} placed, {ncells * cap} slots of cap "
              f"{cap}; bound {b_ms:.6f} ms ({b_by}); plan {rec['plan']}; "
              f"on {ident}")
        record[name] = rec
        del p, m, order, scid, cell_start, want, table, pst, ss, ov
        torch.cuda.empty_cache()
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
