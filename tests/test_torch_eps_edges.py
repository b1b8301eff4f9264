"""The eps-adjacency of the port's all-pairs clustering
(``ops/cuda/eps.py``) on the CPU: the plain version against an independent
NumPy all-pairs test, and the kernel's launch plan. The plan is plain
Python, so its coverage is held here; the kernel it launches is held
against ``eps_edges_reference`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import eps as E
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels as K
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    eps_edges_cases)

CASES = {case[0]: case[1:] for case in eps_edges_cases()}


def _numpy_pairs(points, mask, eps):
    """An independent oracle: query minus column, float32 squares summed
    axis by axis, each operation rounded by NumPy, against float32(eps)
    squared in float32. (rows, cols) in row-major order."""
    e = np.float32(eps)
    r2 = np.float32(e * e)
    # inf - inf is NaN, which fails the test, as on the card
    with np.errstate(invalid="ignore"):
        diff = points[:, None, 0] - points[None, :, 0]
        d2 = diff * diff
        for k in range(1, points.shape[1]):
            diff = points[:, None, k] - points[None, :, k]
            d2 = d2 + diff * diff
    hit = (d2 <= r2) & mask[:, None] & mask[None, :]
    return np.nonzero(hit)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_is_the_all_pairs_edge_list(name, monkeypatch):
    """The plain version's compressed rows hold every ordered pair of
    valid points within eps, self pairs included, row by row in ascending
    columns; a CPU tensor never builds the CUDA library or counts a
    launch."""
    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernels")
    monkeypatch.setattr(E, "load_library", no_build)
    points, mask, eps = CASES[name]
    n = points.shape[0]
    before = K.LAUNCHES["eps_edges"]
    offsets, cols = E.eps_edges(torch.from_numpy(points),
                                torch.from_numpy(mask), eps)
    assert K.LAUNCHES["eps_edges"] == before
    assert offsets.dtype == torch.int64 and cols.dtype == torch.int32
    assert offsets.shape == (n + 1,)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == cols.shape[0]
    rows = np.repeat(np.arange(n), np.diff(offsets.numpy()))
    want_rows, want_cols = _numpy_pairs(points, mask, eps)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(cols.numpy(), want_cols)
    if mask.any() and np.isfinite(points[mask]).all():
        assert cols.shape[0] >= int(mask.sum())  # self pairs


def test_pairs_at_exactly_eps_are_edges():
    """A squared distance equal to r2 is an edge, the next float past it
    is not: the cases hold such pairs."""
    points, mask, eps = CASES["pairs at exactly eps"]
    e = np.float32(eps)
    diff = points[:, None, :] - points[None, :, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    ties = np.argwhere(d2 == np.float32(e * e))
    assert len(ties) == 6
    offsets, cols = E.eps_edges_reference(torch.from_numpy(points),
                                          torch.from_numpy(mask), eps)
    for i, j in ties:
        assert j in cols[offsets[i]:offsets[i + 1]].tolist()


def test_eps_squares_in_float32():
    """r2 is float32(eps) squared in float32, as the plain version squares
    it; ``radius_count``'s r2, rounded once from float64, differs at
    0.35 (the two agree at the monolith's 0.3)."""
    for eps in (0.3, 0.35, 0.5, 0.1):
        e = torch.tensor(eps, dtype=torch.float32)
        assert E.eps_sq(eps) == (e * e).item()
    assert E.eps_sq(0.35) != K._radius_sq(0.35)


def test_a_tensor_off_the_cpu_needs_a_card():
    points = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        E.eps_edges(points, torch.ones(4, dtype=torch.bool, device="meta"),
                    0.3)


# the all-pairs buffers: the monolith's largest, the modular variant's;
# then edge shapes
PIPELINE_SIZES = [32_768, 131_072]
EDGE_SIZES = [1, 2, 127, 128, 129, 511, 512, 513, 1000, 8192, 65_537,
              300_000]


@pytest.mark.parametrize("n", PIPELINE_SIZES + EDGE_SIZES)
def test_plan_covers_every_row_and_column_once(n):
    plan = E.eps_plan(n)
    gx, gy = plan.grid
    rt, ct = E.EPS_ROW_TILE, E.EPS_COL_TILE
    rows = [i for x in range(gx) for i in range(x * rt, min((x + 1) * rt, n))]
    assert rows == list(range(n))
    n_tiles = -(-n // ct)
    tiles = [t for y in range(gy)
             for t in range(y * plan.tiles_per_slice,
                            min((y + 1) * plan.tiles_per_slice, n_tiles))]
    assert tiles == list(range(n_tiles))
    # no block without a row, no slice without a tile; CUDA's limit on the
    # grid's second dimension
    assert (gx - 1) * rt < n
    assert (gy - 1) * plan.tiles_per_slice < n_tiles
    assert gy <= 65_535
    blocks = gx * gy
    if plan.tiles_per_slice == 1:
        assert blocks <= E.EPS_TARGET_BLOCKS
    else:
        assert blocks <= E.EPS_TARGET_BLOCKS + gx


def test_plan_at_the_pipeline_buffers():
    """The sensor frame's 32,768 buffer: 64 row tiles x 64 slices of 4
    column tiles, 4,096 blocks, about 30 an SM of the H100; the modular
    131,072: 256 x 16 slices of 64 tiles."""
    assert E.eps_plan(32_768) == E.EpsPlan(4, (64, 64))
    assert E.eps_plan(131_072) == E.EpsPlan(64, (256, 16))


def test_plan_constants_are_the_kernel_sources():
    """The tile sizes the plan mirrors are the ones ``csrc/eps_edges.cu``
    declares; its entry points refuse a grid that does not cover the
    points; the pair test is the plain version's, every operation rounded
    on its own."""
    src = (Path(K.__file__).resolve().parents[2] / "csrc" /
           "eps_edges.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == E.EPS_THREADS
    assert int(const("kRowsPerThread").split()[0]) == E.EPS_ROWS_PER_THREAD
    assert const("kRowTile") == "kThreads * kRowsPerThread"
    assert const("kColTile").split()[0] == "kThreads"
    assert E.EPS_ROW_TILE == E.EPS_THREADS * E.EPS_ROWS_PER_THREAD
    assert E.EPS_COL_TILE == E.EPS_THREADS
    assert [f.name for f in dataclasses.fields(E.EpsPlan)] == [
        "tiles_per_slice", "grid"]
    assert "d >= 1 && d <= 3" in src and E.EPS_MAX_DIM == 3
    assert "rows >= n && columns >= n" in src
    assert re.search(r"__fadd_rn\(\s*__fadd_rn\(__fmul_rn\(dx, dx\), "
                     r"__fmul_rn\(dy, dy\)\),\s*__fmul_rn\(dz, dz\)\)", src)
    for axis in "xyz":
        assert f"__fsub_rn(q{axis}[r], c.{axis})" in src
    assert "d2 <= r2" in src
    assert K._SIGNATURES["eps_count_launch"][3] is K._F
    assert K._SIGNATURES["eps_fill_launch"][3] is K._F
