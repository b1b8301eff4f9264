"""The launch plans of the port's ``sa_mlp_pool`` and ``place_dense``
kernels (``ops/cuda/pointnet.py::sa_plan``, ``ops/cuda/place.py::
place_plan``): tiles, blocks, shared memory and what each refuses. The
plans are plain Python, so they are held here on the CPU; the kernels
they launch are held against their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Also the cuts of
``tools/kernel_stages.py``, which time both kernels stage by stage.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import place
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as P)
from port_helpers import imported_modules

CSRC = Path(kernels.CSRC_DIR)


def _const(src: str, name: str) -> str:
    return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)


# (M, K, Cin, H1, H2, Cout) -> (centroids a tile, blocks, pieces an item):
# the served model's two layers, the 100,000-point layer, the
# default-width model's two layers (batch 4)
MODEL_SHAPES = {
    (512, 32, 3, 32, 32, 64): (1, 512, 1),
    (128, 32, 67, 64, 64, 128): (1, 128, 1),
    (4096, 32, 3, 32, 32, 64): (4, 1024, 2),
    (1024, 32, 67, 64, 64, 128): (1, 1024, 1),
}


@pytest.mark.parametrize("shape", sorted(MODEL_SHAPES))
def test_model_shapes_fill_the_card(shape):
    """Every layer the model runs takes at least 128 blocks (the first
    design ran the served second layer on 32 of the 132 SMs)."""
    plan = P.sa_plan(*shape)
    assert (plan.tile, plan.blocks, plan.pieces) == MODEL_SHAPES[shape]
    assert plan.blocks >= 128


@pytest.mark.parametrize("k", [1, 5, 16, 20, 32, 33, 48, 65, 128])
@pytest.mark.parametrize("m", [1, 131, 2112, 40_000])
def test_tiles_cover_every_centroid_once_within_128_rows(m, k):
    plan = P.sa_plan(m, k, 3, 32, 32, 64)
    assert plan.tile * k <= P.SA_MAX_ROWS
    assert plan.blocks == -(-m // plan.tile)
    narrow = 1 if k >= P.SA_PIECE else P.SA_PIECE // k
    # wide tiles only where 32-row tiles give blocks to spare
    wide = -(-m // narrow) >= P.SA_SPLIT_BLOCKS
    assert (plan.tile, plan.pieces) == (
        (max(1, 128 // k), P.SA_WIDE_ROWS) if wide else (narrow, 1))


def _old_smem_bytes(k, cin, h1, h2, cout):
    """Shared memory of the first design: 128 // K centroids a tile, the
    weights, two activation buffers of the tile at the wider width, and
    the tile's mask."""
    rows = 128 // k * k
    floats = (-(-cin * h1 // 4) * 4 + h1 * h2 + h2 * cout + h1 + h2 + cout
              + rows * (max(cin, h2) | 1) + rows * (max(h1, cout) | 1)
              + rows)
    return 4 * floats


@pytest.mark.parametrize("k", [1, 20, 32, 48, 128])
@pytest.mark.parametrize("cin", [3, 67, 200])
@pytest.mark.parametrize("widths", [(8, 8, 8), (64, 64, 128),
                                    (128, 64, 128), (256, 128, 256)])
def test_takes_everything_the_first_design_took(k, cin, widths):
    """No narrowing: a shape the first design's layout fitted in a block's
    shared memory has a plan here, with no more shared memory."""
    old = _old_smem_bytes(k, cin, *widths)
    if old > kernels.SMEM_PER_BLOCK:
        return
    plan = P.sa_plan(1000, k, cin, *widths)
    assert plan.smem_bytes <= old


@pytest.mark.parametrize("args", [(10, 0, 3, 8, 8, 8), (10, 129, 3, 8, 8, 8),
                                  (10, 32, 0, 8, 8, 8), (10, 32, 3, 12, 8, 8),
                                  (10, 32, 3, 8, 4, 8), (10, 32, 3, 8, 8, 0),
                                  (10, 32, 2000, 64, 64, 64)])
def test_sa_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        P.sa_plan(*args)


def test_sa_plan_constants_are_the_kernel_source():
    src = (CSRC / "sa_mlp_pool.cu").read_text()
    assert int(_const(src, "kThreads")) == P.SA_THREADS
    assert int(_const(src, "kPiece")) == P.SA_PIECE
    assert int(_const(src, "kMaxRows")) == P.SA_MAX_ROWS
    assert int(_const(src, "kSplitBlocks")) == P.SA_SPLIT_BLOCKS
    assert int(_const(src, "kWideRows")) == P.SA_WIDE_ROWS
    assert int(_const(src, "kSmemPerBlock")) == kernels.SMEM_PER_BLOCK
    # the layout the plan sums, region by region
    for region in ("w1", "w2", "w3", "b1", "b2", "b3", "x", "a1"):
        assert f"l.{region} = at; at += up4(" in src, region


def test_place_plan_at_the_3m_scan():
    plan = place.place_plan(3_145_728, 7, 393_216)
    assert plan == place.PlacePlan(zero_blocks=264, row_blocks=768)


@pytest.mark.parametrize("n,nch,kp", [(0, 7, 512), (1, 0, 512),
                                      (4095, 1, 8), (4096, 9, 1024),
                                      (4097, 3, 3), (2_000_000, 7, 125_440)])
def test_place_plan_covers_every_row_once(n, nch, kp):
    plan = place.place_plan(n, nch, kp)
    assert plan.row_blocks * place.PLACE_BLOCK_ROWS >= n
    assert (plan.row_blocks - 1) * place.PLACE_BLOCK_ROWS < max(n, 1)
    quads = (nch + 1) * kp // 4
    assert 1 <= plan.zero_blocks <= place.PLACE_ZERO_BLOCKS
    assert plan.zero_blocks * place.PLACE_THREADS >= min(
        quads, place.PLACE_ZERO_BLOCKS * place.PLACE_THREADS)


@pytest.mark.parametrize("args", [(-1, 7, 512), (10, -1, 512), (10, 7, 0)])
def test_place_plan_refuses_what_the_kernel_refuses(args):
    with pytest.raises(ValueError):
        place.place_plan(*args)


def test_place_plan_constants_are_the_kernel_source():
    src = (CSRC / "place_dense.cu").read_text()
    assert int(_const(src, "kThreads")) == place.PLACE_THREADS
    assert _const(src, "kWarpRows") == "32 * kLaneRows"
    assert 32 * int(_const(src, "kLaneRows")) == place.PLACE_WARP_ROWS
    assert _const(src, "kBlockRows") == "kWarps * kWarpRows"
    assert int(_const(src, "kZeroBlocks")) == place.PLACE_ZERO_BLOCKS


def test_kernel_stage_variants_find_their_anchors():
    """``tools/kernel_stages.py`` cuts both kernels' sources in text: each
    source matches one design, every anchor of it once; each variant
    differs from the source but the whole kernel, and neither it nor
    ``tools/kernel_ab.py`` imports anything of the JAX package."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "kernel_stages", repo / "tools" / "kernel_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name in ("sa_mlp_pool.cu", "place_dense.cu"):
        src = (CSRC / name).read_text()
        design = tool.design_of(name, src)
        variants = tool.variants(name, src)
        assert list(variants) == list(tool.DESIGNS[name][design])
        for stage, (text, whole) in variants.items():
            assert (text == src) == (stage == "whole"), stage
            assert whole == stage.startswith("whole"), stage
    names = set()
    for tool_file in ("kernel_stages.py", "kernel_ab.py", "variants.py"):
        names |= imported_modules(repo / "tools" / tool_file)
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "lidar_ai_recommendation_software_tpu")]
