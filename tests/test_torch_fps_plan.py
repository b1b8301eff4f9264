"""The launch plan of the port's ``fps`` kernel (``ops/cuda/pointnet.py::
fps_plan``): which body samples a cloud of n points, in how many blocks,
with how much shared memory. The plan is plain Python, so its routes and
layout are held here on the CPU; the kernels it launches are held against
``fps_reference`` on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import re
from pathlib import Path

import pytest

from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    pointnet as P)

CAPACITY = P.PORTABLE_CLUSTER * P.POINTS_PER_BLOCK  # 108,992 points
BLOCK_MAX = P.BLOCK_SMEM_BUDGET // P.BYTES_PER_POINT  # 13,643 points
REGISTER_MAX = 512 * 16  # the largest cloud of a CrowdNet forward
SIZES = [1, 31, 33, 100, 512, 513, 4096, REGISTER_MAX, REGISTER_MAX + 1,
         12_288, 12_289, BLOCK_MAX, BLOCK_MAX + 1, 20_000, 60_000,
         100_000, CAPACITY, CAPACITY + 1, 250_000]


@pytest.mark.parametrize("n,route,cluster", [
    (REGISTER_MAX, "registers", 1), (REGISTER_MAX + 1, "block", 1),
    (BLOCK_MAX, "block", 1), (BLOCK_MAX + 1, "cluster", 2),
    (100_000, "cluster", 8), (CAPACITY, "cluster", 8),
    (CAPACITY + 1, "stream", 1)])
def test_route_boundaries(n, route, cluster):
    plan = P.fps_plan(n)
    assert (plan.route, plan.cluster) == (route, cluster)


@pytest.mark.parametrize("n,threads,per_thread", [
    (1, 32, 16), (512, 32, 16), (513, 128, 16), (2048, 128, 16),
    (1024, 128, 16), (2049, 256, 16), (4095, 256, 16), (4096, 256, 16),
    (4097, 512, 16), (REGISTER_MAX, 512, 16)])
def test_register_instantiation_edges(n, threads, per_thread):
    """Each register instantiation takes the clouds up to its capacity,
    the next one from one point more; the copy of the cloud for the
    winners' coordinates fits the block."""
    plan = P.fps_plan(n)
    assert plan.route == "registers"
    assert (plan.threads, plan.per_thread) == (threads, per_thread)
    assert plan.smem_bytes >= P.REGISTER_COPY_BYTES * n
    assert plan.smem_bytes <= P.SMEM_PER_BLOCK - 2 * (threads // 32) * 8


def test_forward_shapes_take_the_register_route():
    """Every fps_batched launch of a CrowdNet forward, served (4,096 and
    512 points) or default width (8,192 and 1,024), in registers, with as
    few warps as the cloud needs."""
    assert {n: (P.fps_plan(n).route, P.fps_plan(n).threads)
            for n in (512, 1024, 4096, 8192)} == {
        512: ("registers", 32), 1024: ("registers", 128),
        4096: ("registers", 256), 8192: ("registers", 512)}


def test_no_plan_gives_a_cluster_of_one_block():
    """The shared-memory body takes clouds up to the most one block holds,
    so a cluster always has at least two blocks."""
    for n in range(REGISTER_MAX - 3, CAPACITY + 1, 101):
        plan = P.fps_plan(n)
        assert plan.route != "cluster" or plan.cluster >= 2, n


def test_the_100000_point_layer_takes_eight_blocks_of_12500():
    plan = P.fps_plan(100_000)
    assert (plan.cluster, plan.per_block, plan.smem_bytes) == (
        8, 12_500, P.CLUSTER_HEADER_BYTES + 17 * 12_500)


@pytest.mark.parametrize("n", SIZES)
def test_plan_fits_a_block_and_covers_every_point_once(n):
    plan = P.fps_plan(n)
    assert plan.smem_bytes <= P.SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= P.PORTABLE_CLUSTER
    if plan.route == "registers":
        # point tid + j * threads in slot j of thread tid: every point once
        assert plan.threads * plan.per_thread >= n
        slots = sorted(t + j * plan.threads for t in range(plan.threads)
                       for j in range(plan.per_thread)
                       if t + j * plan.threads < n)
        assert slots == list(range(n))
        return
    # block r holds [min(r * per_block, n), min((r + 1) * per_block, n)),
    # as csrc/fps.cu cuts them
    covered = [i for r in range(plan.cluster)
               for i in range(min(r * plan.per_block, n),
                              min((r + 1) * plan.per_block, n))]
    assert covered == list(range(n))
    if plan.route == "cluster":
        # the smallest cluster that holds the cloud, each slice in its
        # block's shared memory
        assert plan.per_block <= P.POINTS_PER_BLOCK
        assert (plan.cluster - 1) * P.POINTS_PER_BLOCK < n
        assert plan.smem_bytes >= (P.CLUSTER_HEADER_BYTES
                                   + P.BYTES_PER_POINT * plan.per_block)
    else:
        # the one-block body: the cloud in shared memory, or streaming
        # with its distance cache in device scratch
        assert plan.cluster == 1 and plan.threads == P.BLOCK_THREADS
        assert plan.scratch == (n if plan.route == "stream" else 0)
        if plan.route == "block":
            assert plan.smem_bytes <= P.BLOCK_SMEM_BUDGET


def test_no_cluster_above_the_portable_size():
    """Past 8 full blocks the plan streams; it never asks for a
    non-portable cluster."""
    clusters = {P.fps_plan(n).cluster
                for n in range(CAPACITY - 5 * P.POINTS_PER_BLOCK,
                               CAPACITY + 2 * P.POINTS_PER_BLOCK, 997)}
    assert max(clusters) == P.PORTABLE_CLUSTER
    for n in (CAPACITY + 1, 120_000, 16 * P.POINTS_PER_BLOCK):
        assert P.fps_plan(n).route == "stream"


def test_plan_constants_are_the_kernel_sources():
    """The layout numbers the plan mirrors are the ones ``csrc/fps.cu``
    declares: a plan with too few shared bytes would be refused there."""
    src = (Path(P.__file__).resolve().parents[2] / "csrc" / "fps.cu"
           ).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([0-9 *]+);",
                             src).group(1).replace(" ", "").split("*")[0])

    assert const("kSmemPerBlock") == P.SMEM_PER_BLOCK
    assert const("kMaxCluster") == P.PORTABLE_CLUSTER
    assert const("kThreads") == P.BLOCK_THREADS == 1024
    # candidate buffers: 2 x kMaxCluster x (v, i, x, y, z); warp results:
    # 2 x 32 warps x (v, i)
    assert P.CLUSTER_HEADER_BYTES == 2 * P.PORTABLE_CLUSTER * 20 + 2 * 32 * 8
    # the one-block body has all of a block's shared memory but its static
    # warp results
    assert "kBlockStatic = 2 * kWarps * 8" in src
    assert P.BLOCK_STATIC_BYTES == 2 * 32 * 8
    assert P.BLOCK_SMEM_BUDGET == P.SMEM_PER_BLOCK - P.BLOCK_STATIC_BYTES
    assert "kSmemBudget" not in src and "cache_fits" not in src
    table = re.search(r"kRegisterShapes\[\] = \{(.*?)\};", src, re.S).group(1)
    shapes = tuple((int(t), int(q))
                   for t, q in re.findall(r"\{(\d+), (\d+)\}", table))
    assert shapes == P.REGISTER_SHAPES
    # smallest first, so the plan's first fit is the fewest threads
    assert list(shapes) == sorted(shapes, key=lambda s: s[0] * s[1])
