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
SIZES = [1, 4096, 12_047, 12_048, 13_624, 13_625, 20_000, 60_000, 100_000,
         CAPACITY, CAPACITY + 1, 250_000]


@pytest.mark.parametrize("n,route,cluster", [
    (12_047, "block", 1), (12_048, "cluster", 1), (13_625, "cluster", 2),
    (100_000, "cluster", 8), (CAPACITY, "cluster", 8),
    (CAPACITY + 1, "stream", 1)])
def test_route_boundaries(n, route, cluster):
    plan = P.fps_plan(n)
    assert (plan.route, plan.cluster) == (route, cluster)


def test_the_100000_point_layer_takes_eight_blocks_of_12500():
    plan = P.fps_plan(100_000)
    assert (plan.cluster, plan.per_block, plan.smem_bytes) == (
        8, 12_500, P.CLUSTER_HEADER_BYTES + 17 * 12_500)


@pytest.mark.parametrize("n", SIZES)
def test_plan_fits_a_block_and_covers_every_point_once(n):
    plan = P.fps_plan(n)
    assert plan.smem_bytes <= P.SMEM_PER_BLOCK
    assert 1 <= plan.cluster <= P.PORTABLE_CLUSTER
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
        # the streaming body keeps its distance cache in device scratch
        assert plan.cluster == 1
        assert plan.scratch == (n if plan.route == "stream" else 0)


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
    assert const("kThreads") == 1024
    # candidate buffers: 2 x kMaxCluster x (v, i, x, y, z); warp results:
    # 2 x 32 warps x (v, i)
    assert P.CLUSTER_HEADER_BYTES == 2 * P.PORTABLE_CLUSTER * 20 + 2 * 32 * 8
    assert "kSmemBudget = 200 * 1024" in src
    assert P.BLOCK_SMEM_BUDGET == 200 * 1024
