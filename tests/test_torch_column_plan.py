"""The launch plans of the port's column scan (``column_counts`` and
``border_min``, ``ops/cuda/columns.py::neighbour_plan``) and of the column
table's fill (``fill_plan``): which block takes which columns (and, for
the fill, which stream positions), what it stages and how much shared
memory that needs. The plans are plain Python, so they are held here on
the CPU; the kernels they launch are held against their plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

The scan's split of a block's tile into sub-tiles depends on the data, so
``_subtiles`` below walks it as the kernel does, from ``cell_start``
alone, and the window bound is checked on occupancies made up as numbers
(every column at its cap) at the scans' grids, with no cloud built.
"""

import dataclasses
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.ops import ccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import columns as C
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    lattice_points, table_fill_cases)
from port_helpers import imported_modules

T = C.NEIGHBOUR_TILE_COLS
# (ncx, ncy, cap): the clustering grids of the 262,144-, 1M- and 3M-point
# scans (PERF.md section 4), the pipeline's largest cap on each, then edge
# shapes: one column, one x row, one y column, a row of exactly one tile
# and one past it
SCAN_GRIDS = [(544, 544, 16), (1024, 1024, 16), (1280, 1280, 16)]
EDGE_GRIDS = [(1024, 1024, 512), (1, 1, 8), (1, 1000, 16), (1000, 1, 16),
              (3, T, 8), (3, T + 1, 8), (7, 300, 64)]


def _tile(plan, block, ncy):
    """The padded x row and padded y columns block ``block`` takes."""
    row = block // plan.tiles_per_row
    y0 = 1 + (block % plan.tiles_per_row) * T
    return row + 1, range(y0, min(y0 + T, ncy + 1))


@pytest.mark.parametrize("ncx,ncy,cap", SCAN_GRIDS + EDGE_GRIDS)
def test_every_column_in_one_tile_and_its_neighbours_staged(ncx, ncy, cap):
    """Every interior column belongs to exactly one block's tile, and the
    three staged ranges of that tile, rows x - 1 .. x + 1 over its columns
    and one more on each side, hold the 3 x 3 columns around it (where
    every eps-neighbour of its points lies)."""
    plan = C.neighbour_plan(ncx, ncy, cap, 1)
    assert plan.blocks == ncx * plan.tiles_per_row
    owner = np.zeros((ncx + 2, ncy + 2), np.int64)
    for block in range(plan.blocks):
        x, ys = _tile(plan, block, ncy)
        assert len(ys) >= 1  # no block without a column
        owner[x, ys.start:ys.stop] += 1
        staged_x = range(x - 1, x + 2)
        staged_y = range(ys.start - 1, ys.stop + 1)
        assert staged_x[0] >= 0 and staged_x[-1] <= ncx + 1
        assert staged_y[0] >= 0 and staged_y[-1] <= ncy + 1
        for y in (ys.start, ys.stop - 1):
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    assert x + dx in staged_x and y + dy in staged_y
    assert (owner[1:-1, 1:-1] == 1).all()
    assert owner.sum() == ncx * ncy


def _subtiles(cell_start, plan, ncx, ncy, cap, block):
    """The kernel's sub-tiles of ``block``: (first and last centre column,
    tile-local from 1, slots staged), the most columns that fit the window
    each, from ``cell_start`` alone."""
    py = ncy + 2
    x, ys = _tile(plan, block, ncy)
    cols = np.arange(ys.start - 1, ys.stop + 2)  # staged columns and end
    cs = cell_start[(x - 1 + np.arange(3))[:, None] * py + cols[None, :]]
    occ = np.minimum(np.diff(cs, axis=1), cap)
    pre = np.concatenate([[0], np.cumsum(occ.sum(0))])
    out, a = [], 1
    while a <= len(ys):
        fits = pre[a + 2:len(ys) + 3] - pre[a - 1] <= plan.window
        b = a + int(np.nonzero(fits)[0].max())
        out.append((a, b, int(pre[b + 2] - pre[a - 1])))
        a = b + 1
    return out


def _cell_start(occupancy):
    """cell_start of a stream whose padded columns hold ``occupancy``
    (ncx + 2, ncy + 2) points each, none masked."""
    return np.concatenate([[0], np.cumsum(occupancy.ravel())]).astype(
        np.int64)


@pytest.mark.parametrize("ncx,ncy,cap", SCAN_GRIDS + EDGE_GRIDS)
def test_window_fits_shared_memory_with_every_column_full(ncx, ncy, cap):
    """With every interior column at its cap (and one past it), each
    sub-tile stages at most the plan's window, which fits the shared
    memory a block may use in both modes; the sub-tiles of a block take
    each of its columns once."""
    plan = C.neighbour_plan(ncx, ncy, cap, 1)
    assert plan.window >= 9 * cap
    assert plan.smem_bytes == (plan.window * C.NEIGHBOUR_SLOT_BYTES
                               + 4 * C.NEIGHBOUR_BLOCK_WORDS)
    assert plan.smem_bytes <= kernels.SMEM_PER_BLOCK
    occupancy = np.zeros((ncx + 2, ncy + 2), np.int64)
    occupancy[1:-1, 1:-1] = cap + 1
    cell_start = _cell_start(occupancy)
    step = max(1, plan.blocks // 64)
    for block in range(0, plan.blocks, step):
        tiles = _subtiles(cell_start, plan, ncx, ncy, cap, block)
        assert [c for a, b, _ in tiles for c in range(a, b + 1)] == list(
            range(1, len(_tile(plan, block, ncy)[1]) + 1))
        assert max(staged for _, _, staged in tiles) <= plan.window


def test_empty_stream_launches_nothing():
    plan = C.neighbour_plan(1024, 1024, 16, 0)
    assert plan.blocks == 0 and plan.tiles_per_row == 4


def test_cap_past_shared_memory_raises():
    """A cap whose nine columns cannot fit a block's shared memory is
    refused by the plan (the pipeline's caps stop at 512)."""
    C.neighbour_plan(8, 8, 1402, 1)
    with pytest.raises(ValueError, match="shared memory"):
        C.neighbour_plan(8, 8, 1403, 1)


def test_plan_constants_are_the_kernel_sources():
    """The layout the plan mirrors is the one ``csrc/column_neighbours.cu``
    declares (its entry points derive the plan from the shapes)."""
    src = (Path(kernels.__file__).resolve().parents[2] / "csrc" /
           "column_neighbours.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == C.NEIGHBOUR_THREADS
    assert int(const("kTileCols")) == C.NEIGHBOUR_TILE_COLS
    assert int(const("kWindow")) == C.NEIGHBOUR_WINDOW
    assert const("kWarps") == "kThreads / 32"
    assert const("kColumnWords") == "kTileCols + 3"
    assert const("kBlockWords") == "5 * kColumnWords + 2 * kWarps + 1"
    assert C.NEIGHBOUR_BLOCK_WORDS == 5 * (C.NEIGHBOUR_TILE_COLS + 3) + \
        2 * (C.NEIGHBOUR_THREADS // 32) + 1
    assert int(const("kSmemPerBlock")) == kernels.SMEM_PER_BLOCK
    assert int(const("kSlotBytes")) == C.NEIGHBOUR_SLOT_BYTES
    assert [f.name for f in dataclasses.fields(C.NeighbourPlan)] == [
        "tiles_per_row", "blocks", "window", "smem_bytes"]


def _numpy_scan(pts, placed, eps, labels):
    """An independent oracle: all pairs of placed points, float32
    differences, products and sums each rounded by numpy, against
    float32(eps) squared in float32 (the columns are at least eps wide, so
    every eps-neighbour lies in the 3 x 3 columns around a point)."""
    r2 = np.float32(eps) * np.float32(eps)
    p = pts[placed]
    d = p[None, :, :] - p[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[
        ..., 2]
    hit = d2 <= r2
    lab = np.where(hit, labels[placed][None, :], C.INT_MAX)
    return hit.sum(1), lab.min(1, initial=C.INT_MAX)


def _full(nx, ny, per_column):
    counts = np.full((nx, ny), per_column)
    counts[0, 0] -= 1  # the origin's point completes column (0, 0)
    return counts


# name -> (points a column, ncx, ncy, cap, every point masked)
EDGE_CLOUDS = {
    "one_column": (np.full((1, 1), 6), 1, 1, 8, False),
    "one_x_row": (np.tile([2, 0, 3, 1], (1, 75)), 1, 300, 4, False),
    "every_column_full": (_full(6, 6, 8), 6, 6, 8, False),
    "one_past_every_cap": (_full(5, 7, 5), 5, 7, 4, False),
    "every_point_masked": (np.full((4, 4), 3), 4, 4, 8, True),
}


@pytest.mark.parametrize("name", sorted(EDGE_CLOUDS))
def test_cpu_tensor_never_builds_the_library(monkeypatch, name):
    """A CPU tensor takes the plain versions at the edge shapes, without
    the CUDA build (which this machine cannot do) or a launch count, and
    they give the independent oracle's counts and minima."""
    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernels")
    monkeypatch.setattr(C, "load_library", no_build)
    counts, ncx, ncy, cap, masked = EDGE_CLOUDS[name]
    eps = 0.3
    pts = lattice_points(counts, eps, len(name))
    mask = np.full(len(pts), not masked)
    t = ccl.build_table(torch.from_numpy(pts), torch.from_numpy(mask), eps,
                        ncx, ncy, cap)
    order = t.order.numpy()
    labels = np.where(np.arange(len(pts)) % 3 == 0, order, C.INT_MAX)
    before = dict(kernels.LAUNCHES)
    nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
    got = C.column_counts(*nb).numpy()
    got_min = C.border_min(*nb, torch.from_numpy(labels.astype(
        np.int32))).numpy()
    assert kernels.LAUNCHES == before
    placed = t.stream_slot.numpy() >= 0
    want, want_min = _numpy_scan(pts[order], placed, eps, labels)
    np.testing.assert_array_equal(got[placed], want)
    np.testing.assert_array_equal(got_min[placed], want_min)
    assert (got[~placed] == 0).all() and (got_min[~placed] == C.INT_MAX).all()
    assert (int(t.overflow) > 0) == (name == "one_past_every_cap")
    assert placed.any() != masked


@pytest.mark.parametrize("seed", [0, 1])
def test_build_table_keeps_cell_start(seed):
    """``build_table``'s ``cell_start`` is each column's first stream
    position, a ``torch.searchsorted`` of the sorted column ids, and a
    column's placed points are the first min(count, cap) of its run."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(0.0, 6.0, (3000, 3)).astype(np.float32)
    mask = rng.rand(3000) > 0.1
    ncx, ncy, cap = 20, 20, 8
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    t = ccl.build_table(p, m, 0.3, ncx, ncy, cap)
    ncells = (ncx + 2) * (ncy + 2)
    ids = torch.sort(ccl.cell_ids(p, m, 0.3, ncx, ncy), stable=True).values
    want = torch.searchsorted(ids, torch.arange(ncells + 1, dtype=ids.dtype),
                              out_int32=True)
    assert t.cell_start.dtype == torch.int32
    assert torch.equal(t.cell_start, want)
    assert int(t.cell_start[-1]) == int(m.sum())
    ss = t.stream_slot
    occ = torch.bincount(ss[ss >= 0].long() // cap, minlength=ncells)
    assert torch.equal(occ, torch.diff(t.cell_start).clamp_max(cap).long())
    k = torch.arange(len(pts))
    first = t.cell_start[(ss.clamp_min(0) // cap).long()]
    assert bool((k[ss >= 0] - first[ss >= 0] < cap).all())
    assert int(t.overflow) > 0


def test_scan_stage_variants_find_their_anchors():
    """``tools/scan_stages.py`` cuts the scan's source in text: every
    anchor is in today's source once, each variant differs from it, only
    the stage ``full`` is the source itself, and the tool imports nothing
    of the JAX package."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "scan_stages", repo / "tools" / "scan_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (Path(kernels.CSRC_DIR) / "column_neighbours.cu").read_text()
    variants = tool._variants(src)
    assert len(variants) == len(tool._STAGES) + len(tool._TILES)
    for name, (text, whole) in variants.items():
        assert (text == src) == (name == "stage full"), name
        assert whole == (not name.startswith("stage ")
                         or name == "stage full"), name
    names = imported_modules(repo / "tools" / "scan_stages.py")
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "lidar_ai_recommendation_software_tpu")]


# ---------------------------------------------------------------------------
# the fill's plan (``columns.fill_plan``, ``csrc/column_table.cu``)
# ---------------------------------------------------------------------------

# name -> (ncx, ncy, cap, stream positions, valid points): the clustering
# buffers of the 262,144-, 1M- and 3M-point scans, the temporal sequence's
# frame and the 10M scan (PERF.md section 4), then edge shapes
FILL_SHAPES = {
    "262,144-point scan": (544, 544, 16, 262_144, 183_501),
    "1M scan": (1024, 1024, 16, 1_048_576, 700_000),
    "3M scan": (1280, 1280, 16, 3_145_728, 2_100_000),
    "sequence frame": (320, 320, 56, 114_688, 70_000),
    "10M buffer": (1280, 1280, 24, 8_388_608, 6_989_636),
    "cap of 512": (6, 6, 512, 16_384, 10_000),
    "columns not a multiple of a tile": (7, 300, 64, 4_096, 3_000),
    "empty stream": (32, 32, 16, 0, 0),
    "every point masked": (32, 32, 16, 4_096, 0),
}
# an H100 SXM's multiprocessors and the shared memory of one of them
H100_SMS = 132
SMEM_PER_SM = 233_472


def _made_up_cell_start(ncx, ncy, valid, seed):
    """cell_start of a stream of ``valid`` points spread at random over
    the interior columns (some past any cap), the masked points after."""
    rng = np.random.RandomState(seed)
    occupancy = np.zeros((ncx + 2, ncy + 2), np.int64)
    occupancy[1:-1, 1:-1] = rng.multinomial(
        valid, np.full(ncx * ncy, 1.0 / (ncx * ncy))).reshape(ncx, ncy)
    return _cell_start(occupancy)


@pytest.mark.parametrize("name", sorted(FILL_SHAPES))
def test_fill_tiles_cover_every_column_and_stream_position_once(name):
    """The fill's tiles take every column once and, through the columns'
    starts and the masked chunks, every stream position once; the blocks'
    walks take every tile once; a tile's column starts have a thread
    each; the large streams scatter point_stream after their tiles; two tile buffers fit a block's shared memory, and the
    persistent grid's blocks fit an SM together."""
    ncx, ncy, cap, n, valid = FILL_SHAPES[name]
    ncells = (ncx + 2) * (ncy + 2)
    plan = C.fill_plan(ncells, cap, n, H100_SMS)
    cs = _made_up_cell_start(ncx, ncy, valid, len(name))
    assert cs[-1] == valid
    assert plan.tile_cols == max(1, min(C.FILL_THREADS - 1,
                                        C.FILL_TILE_SLOTS // cap))
    assert plan.smem_bytes == (2 * plan.tile_cols * cap * 16
                               + 4 * (plan.tile_cols + 1 + C.FILL_WARPS))
    assert plan.smem_bytes <= kernels.SMEM_PER_BLOCK
    assert C.FILL_BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= SMEM_PER_SM
    c0 = np.arange(plan.tiles) * plan.tile_cols
    c1 = np.minimum(c0 + plan.tile_cols, ncells)
    assert (c1 > c0).all() and c0[0] == 0 and c1[-1] == ncells
    assert (c1[:-1] == c0[1:]).all()
    assert ((c1 - c0) * cap <= max(C.FILL_TILE_SLOTS, cap)).all()
    assert plan.tile_cols + 1 <= C.FILL_THREADS
    # the columns' stream ranges, then the masked chunks, in tile order
    lo, hi = cs[c0], cs[c1]
    assert lo[0] == 0 and hi[-1] == valid and (hi[:-1] == lo[1:]).all()
    m0 = np.arange(plan.tiles, dtype=np.int64) * plan.masked_chunk
    m_lo, m_hi = np.maximum(m0, valid), np.minimum(m0 + plan.masked_chunk, n)
    assert np.clip(m_hi - m_lo, 0, None).sum() == n - valid
    assert plan.masked_chunk * plan.tiles >= n
    walked = np.concatenate([np.arange(b, plan.tiles, plan.blocks)
                             for b in range(plan.blocks)])
    assert np.array_equal(np.sort(walked), np.arange(plan.tiles))
    assert plan.scatter_after == (n > C.FILL_SCATTER_INLINE_MAX) == (
        name in ("3M scan", "10M buffer"))
    assert plan.blocks == min(plan.tiles, H100_SMS * C.FILL_BLOCKS_PER_SM)
    if name == "columns not a multiple of a tile":
        assert ncells % plan.tile_cols and (ncells * cap) % (
            plan.tile_cols * cap)


def _fill_by_plan(pts, order, cell_start, ncells, cap, plan):
    """The fill as the kernel computes it, tile by tile, from the plan,
    ``cell_start`` and ``order`` alone (no cell ids): a stream position's
    column is the last of the tile's columns that starts at or before it.
    Returns its four outputs and how often each slot and each stream
    position was written."""
    n = len(order)
    table = np.zeros((ncells * cap, 4), np.float32)
    point_stream = np.zeros(n, np.int32)
    stream_slot = np.zeros(n, np.int32)
    slot_writes, stream_writes = np.zeros(ncells * cap, np.int64), \
        np.zeros(n, np.int64)
    overflow = 0
    for t in range(plan.tiles):
        c0 = t * plan.tile_cols
        ncols = min(plan.tile_cols, ncells - c0)
        cs = cell_start[c0:c0 + ncols + 1]
        tile = np.full((ncols * cap, 4), C.EMPTY_COORD, np.float32)
        tile.view(np.int32)[:, 3] = -1
        k = np.arange(cs[0], cs[-1])
        col = np.searchsorted(cs[:-1], k, side="right") - 1
        r = k - cs[col]
        placed = r < cap
        slot = col * cap + r
        tile[slot[placed], :3] = pts[order[k[placed]]]
        tile.view(np.int32)[slot[placed], 3] = k[placed]
        stream_slot[k] = np.where(placed, c0 * cap + slot, -1)
        point_stream[order[k]] = np.where(placed, k, -1)
        overflow += int((~placed).sum())
        m0 = t * plan.masked_chunk
        masked = np.arange(max(m0, cell_start[ncells]),
                           min(m0 + plan.masked_chunk, n))
        stream_slot[masked] = -1
        point_stream[order[masked]] = -1
        stream_writes[k] += 1
        stream_writes[masked] += 1
        table[c0 * cap:(c0 + ncols) * cap] = tile
        slot_writes[c0 * cap:(c0 + ncols) * cap] += 1
    return (table, point_stream, stream_slot, overflow), slot_writes, \
        stream_writes


FILL_CASES = {case[0]: case[1:] for case in table_fill_cases()}


@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_fill_by_plan_equals_the_plain_version(name):
    """On the fill's edge clouds (every column at or past its cap, every
    point masked, one point, runs of columns across tiles, a cap of 512),
    the kernel's arithmetic by ``fill_plan``, emulated in numpy, writes
    every slot and every stream position once and gives
    ``table_fill_reference``'s four outputs bit for bit."""
    pts, mask, eps, _, ncx, ncy, cap = FILL_CASES[name]
    p, m = torch.from_numpy(pts), torch.from_numpy(mask)
    order, scid, cell_start = ccl.sorted_stream(p, m, eps, ncx, ncy)
    ncells = (ncx + 2) * (ncy + 2)
    want = C.table_fill_reference(p, order, scid, cell_start, ncells, cap)
    plan = C.fill_plan(ncells, cap, len(pts), H100_SMS)
    got, slot_writes, stream_writes = _fill_by_plan(
        pts, order.numpy(), cell_start.numpy().astype(np.int64), ncells,
        cap, plan)
    assert (slot_writes == 1).all() and (stream_writes == 1).all()
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].numpy().view(np.int32))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w.numpy())
    assert (int(want[3]) > 0) == ("past" in name or "512" in name
                                  or "runs" in name)


def test_fill_plan_refuses_what_the_kernel_refuses():
    """A cap whose one-column tile cannot be double-buffered in a block's
    shared memory, and a table past the int32 slot index (the pipeline's
    caps stop at 512; ``build_table`` refuses the slot count first)."""
    C.fill_plan(9, 7262, 10, H100_SMS)
    with pytest.raises(ValueError, match="shared memory"):
        C.fill_plan(9, 7263, 10, H100_SMS)
    with pytest.raises(ValueError, match="int32"):
        C.fill_plan(2 ** 27, 16, 10, H100_SMS)


def test_fill_plan_constants_are_the_kernel_sources():
    """The layout ``fill_plan`` mirrors is the one ``csrc/column_table.cu``
    declares and derives in its entry point."""
    src = (Path(kernels.CSRC_DIR) / "column_table.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == C.FILL_THREADS
    assert int(const("kTileSlots")) == C.FILL_TILE_SLOTS
    assert int(const("kBlocksPerSm")) == C.FILL_BLOCKS_PER_SM
    assert const("kScatterInlineMax") == "1 << 21"
    assert 1 << 21 == C.FILL_SCATTER_INLINE_MAX
    assert "const bool after = n > kScatterInlineMax;" in src
    assert const("kWarps") == "kThreads / 32"
    assert C.FILL_WARPS == C.FILL_THREADS // 32
    assert int(const("kSmemPerBlock")) == kernels.SMEM_PER_BLOCK
    assert ("const int tile_cols = max(1, min(kThreads - 1, kTileSlots / "
            "cap));") in src
    assert "sizeof(int32_t) * (tile_cols + 1 + kWarps);" in src
    assert [f.name for f in dataclasses.fields(C.FillPlan)] == [
        "tile_cols", "tiles", "masked_chunk", "blocks", "smem_bytes",
        "scatter_after"]


def test_fill_stage_variants_find_their_anchors():
    """``tools/fill_stages.py`` cuts the fill's source in text: every
    anchor is in today's source once, each variant differs from it, and
    the tool imports nothing of the JAX package."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "fill_stages", repo / "tools" / "fill_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (Path(kernels.CSRC_DIR) / "column_table.cu").read_text()
    variants = tool._variants(src)
    assert set(variants) == set(tool._VARIANTS)
    for name, (text, tile_slots, per_sm, whole) in variants.items():
        assert (text == src) == (name == tool.SHIPPED), name
        assert whole == (name in tool._WHOLE), name
    names = imported_modules(repo / "tools" / "fill_stages.py")
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "lidar_ai_recommendation_software_tpu")]
