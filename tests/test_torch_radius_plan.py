"""The launch plan of the port's ``radius_count`` kernel
(``ops/cuda/kernels.py::radius_plan``): which block counts which centres
against which people. The plan is plain Python, so its coverage is held
here on the CPU; the kernel it launches is held against
``radius_count_reference`` on the card (``tests/test_torch_radius_count.py``,
``chip_smoke.py``).
"""

import dataclasses
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels as K

# (centres, people capacity): the density's shapes at 10,000, 40,960 and
# 262,144 points, then edge shapes
PIPELINE_SHAPES = [(4096, 1280), (9216, 5120), (25_600, 32_768)]
EDGE_SHAPES = [(1, 1), (1, 1000), (1000, 1), (1000, 1000), (512, 128),
               (513, 129), (1000, 0), (0, 1000), (295_936, 14_000),
               (1, 300_000)]


@pytest.mark.parametrize("c,k", PIPELINE_SHAPES + EDGE_SHAPES)
def test_plan_covers_every_centre_and_person_once(c, k):
    plan = K.radius_plan(c, k)
    gx, gy = plan.grid
    ct, pt = K.RADIUS_CENTRE_TILE, K.RADIUS_PEOPLE_TILE
    centres = [i for x in range(gx)
               for i in range(x * ct, min((x + 1) * ct, c))]
    assert centres == list(range(c))
    n_tiles = -(-k // pt)
    tiles = [t for y in range(gy)
             for t in range(y * plan.tiles_per_slice,
                            min((y + 1) * plan.tiles_per_slice, n_tiles))]
    assert tiles == list(range(n_tiles))
    people = [j for t in tiles for j in range(t * pt, min((t + 1) * pt, k))]
    assert people == list(range(k))
    # no block without a centre, no slice without a tile; CUDA's limit on
    # the grid's second dimension
    assert (gx - 1) * ct < c or gx == 0
    assert (gy - 1) * plan.tiles_per_slice < n_tiles or gy == 0
    assert gy <= 65_535


def test_sensor_frame_fills_the_card():
    """At the 40,960-point frame (9,216 cells x 5,120 people, 1,786 live)
    at least one block per SM of the H100 holds live people."""
    plan = K.radius_plan(9216, 5120)
    span = plan.tiles_per_slice * K.RADIUS_PEOPLE_TILE
    live_slices = sum(1 for y in range(plan.grid[1]) if y * span < 1786)
    assert plan.grid[0] * live_slices >= 132


@pytest.mark.parametrize("c", [1, 4096, 25_600, 295_936])
def test_slices_lengthen_past_the_target(c):
    """While the grid stays under ``RADIUS_TARGET_BLOCKS`` a slice is one
    people tile; past it, slices lengthen so the grid stays near it."""
    for k in (128, 5120, 32_768, 393_216, 3_000_000):
        plan = K.radius_plan(c, k)
        blocks = plan.grid[0] * plan.grid[1]
        if plan.tiles_per_slice == 1:
            assert blocks <= K.RADIUS_TARGET_BLOCKS
        else:
            assert blocks <= K.RADIUS_TARGET_BLOCKS + plan.grid[0]


def test_plan_constants_are_the_kernel_sources():
    """The tile sizes the plan mirrors are the ones ``csrc/radius_count.cu``
    declares; the plan passes only what varies with the shapes, and the
    kernel's entry point refuses a grid that does not cover its inputs."""
    src = (Path(K.__file__).resolve().parents[2] / "csrc" /
           "radius_count.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == K.RADIUS_THREADS
    assert int(const("kPerThread").split()[0]) == K.RADIUS_PER_THREAD
    assert const("kPeopleTile").split()[0] == "kThreads"
    assert K.RADIUS_PEOPLE_TILE == K.RADIUS_THREADS
    assert const("kCentreTile") == "kThreads * kPerThread"
    assert K.RADIUS_CENTRE_TILE == K.RADIUS_THREADS * K.RADIUS_PER_THREAD
    assert [f.name for f in dataclasses.fields(K.RadiusPlan)] == [
        "tiles_per_slice", "grid"]
    assert "centre_cover < c || people_cover < k" in src


def test_wrapper_has_no_prologue():
    """The wrapper finds no live extent on the device: the kernel skips
    tiles with no valid person itself, so the CUDA branch is one
    allocation and one launch function."""
    src = inspect.getsource(K.radius_count)
    cuda_branch = src[src.index("_cuda_device"):]
    for op in ("arange", "where", "amax", ".item(", ".cpu(", "nonzero"):
        assert op not in cuda_branch, op
    assert cuda_branch.count("torch.empty(") == 1
    assert cuda_branch.count("fn(") == 1


def _numpy_counts(centers, people, pmask, radius):
    """An independent oracle: float32 differences, products and sum, each
    rounded by numpy, against r^2 rounded once from float64."""
    r2 = np.float32(radius * radius)
    dx = centers[:, None, 0] - people[None, :, 0]
    dy = centers[:, None, 1] - people[None, :, 1]
    d2 = dx * dx + dy * dy
    return ((d2 <= r2) & pmask[None, :]).sum(1).astype(np.int32)


@pytest.mark.parametrize("c,k,valid", [
    (1, 1000, "all"), (1000, 1000, "all"), (1000, 0, "all"),
    (700, 1000, "last_tile"), (700, 1000, "dead_tile_between")])
def test_cpu_tensor_never_builds_the_library(monkeypatch, c, k, valid):
    """A CPU tensor takes the plain version at the edge shapes, without
    the CUDA build (which this machine cannot do) or a launch count."""
    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernel")
    monkeypatch.setattr(K, "load_library", no_build)
    rng = np.random.RandomState(c + k)
    centers = rng.uniform(-6, 6, (c, 2)).astype(np.float32)
    people = rng.uniform(-6, 6, (k, 2)).astype(np.float32)
    tile = np.arange(k) // K.RADIUS_PEOPLE_TILE
    pmask = {"all": np.ones(k, bool),
             "last_tile": tile == tile.max(initial=0),
             "dead_tile_between": (tile == 0) | (tile == 2)}[valid]
    before = K.LAUNCHES["radius_count"]
    got = K.radius_count(torch.from_numpy(centers), torch.from_numpy(people),
                         torch.from_numpy(pmask), 2.0)
    assert K.LAUNCHES["radius_count"] == before
    np.testing.assert_array_equal(
        got.numpy(), _numpy_counts(centers, people, pmask, 2.0))
