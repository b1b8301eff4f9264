"""The tail of the port's column-grid clustering (``ops/cuda/columns.py``:
``dense_tail``, ``dense_tail_plan``) on the CPU: its plain version, the
CPU path and the kernel's oracle, against the JAX package's ``dbscan_gs``
and against the definition of the ranks; and the kernel's launch plan.

The clouds and label arrays are ``synthetic.dense_tail_cases`` and
``synthetic.dense_tail_label_cases``, which the card-only test and
``chip_smoke.py`` feed to the kernel. Tolerance: none; ids, cluster counts
and overflow are integers.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.ops import ccl as jccl
from lidar_ai_recommendation_software_tpu_torch.ops import ccl as tccl
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import (
    columns as C)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels
from lidar_ai_recommendation_software_tpu_torch.synthetic import (
    dense_tail_cases, dense_tail_label_cases)
from port_helpers import imported_modules

CASES = {case[0]: case[1:] for case in dense_tail_cases()}
LABEL_CASES = {case[0]: case[1:] for case in dense_tail_label_cases()}


def _stream_labels(pts, mask, eps, min_samples, ncx, ncy, cap):
    """The clustering's stream-order labels before its tail, and the
    point map (the steps of ``dbscan_gs`` before ``dense_tail``)."""
    t = tccl.build_table(torch.from_numpy(pts), torch.from_numpy(mask), eps,
                         ncx, ncy, cap)
    nb = (t.table, t.stream_slot, t.cell_start, t.py, t.cap, eps)
    core = (t.stream_slot >= 0) & (C.column_counts(*nb) >= min_samples)
    labels = torch.where(core, t.order, C.INT_MAX)
    C.propagate(t.table, t.stream_slot, t.point_stream, t.py, t.cap, eps,
                labels, 320)
    return (torch.where(core, labels, C.border_min(*nb, labels)),
            t.point_stream)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tail_matches_jax_dbscan_gs(name):
    """``dbscan_gs`` of both packages on the case: the port's ids come from
    the plain tail and equal the JAX package's, every one."""
    pts, mask, eps, min_samples, ncx, ncy, cap = CASES[name]
    want, wn, wov = jccl.dbscan_gs(jnp.asarray(pts), jnp.asarray(mask), eps,
                                   min_samples, ncx=ncx, ncy=ncy,
                                   column_cap=cap)
    got, gn, gov = tccl.dbscan_gs(torch.from_numpy(pts),
                                  torch.from_numpy(mask), eps, min_samples,
                                  ncx=ncx, ncy=ncy, column_cap=cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gn) == int(wn)
    assert int(gov) == int(wov)
    labels, pst = _stream_labels(pts, mask, eps, min_samples, ncx, ncy, cap)
    dense, n_clusters = C.dense_tail(labels, pst)
    assert torch.equal(dense, got) and int(n_clusters) == int(gn)
    # what each case is for
    point_labels = C.table_gather_reference(labels, pst, C.INT_MAX)
    has = point_labels != C.INT_MAX
    forward = int((point_labels[has] > torch.arange(len(pts))[has]).sum())
    if name in ("labels pointing forward", "N not a multiple of the tile"):
        assert forward >= 20 and int(gn) >= 20
    if name == "N not a multiple of the tile":
        assert len(pts) % 32 and len(pts) % 2048
    if name == "dropped and masked points":
        assert int(gov) > 0 and (~mask).sum() > 0 and int(gn) > 20
    if name == "empty stream":
        assert int(gn) == 0 and (got == -1).all()


def _ranks_by_definition(labels, stream):
    """The tail by its definition, in numpy: a point's label is its stream
    position's (none for no slot or INT_MAX); a representative is a point
    whose label is its own index; a labelled point's id is the number of
    representatives at or below its label (clamped to N - 1), less one."""
    n = len(labels)
    lab = np.where(stream >= 0, labels[np.maximum(stream, 0)], -1)
    lab = np.where(lab == C.INT_MAX, -1, lab).astype(np.int64)
    reps = np.nonzero(lab == np.arange(n))[0]
    rank = np.searchsorted(reps, np.minimum(lab, n - 1), side="right") - 1
    return np.where(lab >= 0, rank, -1), len(reps)


@pytest.mark.parametrize("name", sorted(LABEL_CASES))
def test_plain_tail_matches_its_definition(name):
    labels, stream = LABEL_CASES[name]
    want, want_n = _ranks_by_definition(labels, stream)
    dense, n_clusters = C.dense_tail(torch.from_numpy(labels),
                                     torch.from_numpy(stream))
    assert dense.dtype == torch.int32 and n_clusters.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), want)
    assert int(n_clusters) == want_n
    if len(labels) > 100:
        assert (want >= 0).mean() > 0.3 or want_n == 0
        assert (labels < 0).any() and (labels >= len(labels)).any()


@pytest.mark.parametrize("n", [0, 1, 31, 33, 2047, 2048, 2049, 2085,
                               114_688, 262_144, 1_000_003, 2_097_152,
                               2_097_153, 3_145_728, 2 ** 31 - 2 ** 21,
                               2 ** 31 - 1])
def test_tail_plan_covers_every_point(n):
    """Blocks of whole chunks of TAIL_CHUNK points (a multiple of 32),
    none empty, at most TAIL_MAX_BLOCKS, together covering the N points:
    what ``csrc/dense_tail.cu`` checks before it launches; a chunk a block
    until the blocks reach TAIL_MAX_BLOCKS."""
    plan = C.dense_tail_plan(n)
    assert plan.per_block % C.TAIL_CHUNK == 0 and C.TAIL_CHUNK % 32 == 0
    assert 1 <= plan.blocks <= C.TAIL_MAX_BLOCKS
    assert plan.blocks * plan.per_block >= n
    assert (plan.blocks - 1) * plan.per_block < max(n, 1)
    if n <= C.TAIL_CHUNK * C.TAIL_MAX_BLOCKS:
        assert plan.per_block == C.TAIL_CHUNK
    # the words of the last block's range still index the word array
    assert (n + 31) // 32 <= plan.blocks * plan.per_block // 32


def test_cpu_tail_never_builds_the_kernels(monkeypatch):
    def no_build():
        raise AssertionError("the CPU tail tried to build the kernels")
    monkeypatch.setattr(C, "load_library", no_build)
    before = dict(kernels.LAUNCHES)
    labels, stream = LABEL_CASES["33 points"]
    C.dense_tail(torch.from_numpy(labels), torch.from_numpy(stream))
    assert kernels.LAUNCHES == before


def test_tail_stage_variants_find_their_anchors():
    """``tools/tail_stages.py`` cuts the tail's source in text: every
    anchor is in today's source once, and the tool imports nothing of the
    JAX package."""
    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "tail_stages", repo / "tools" / "tail_stages.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = (Path(kernels.CSRC_DIR) / "dense_tail.cu").read_text()
    for stage, cut in tool._STAGES.items():
        assert (cut is None) == (stage == "whole"), stage
        if cut is not None:
            assert src.count(cut[0]) == 1, stage
    names = imported_modules(repo / "tools" / "tail_stages.py")
    assert not [n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "lidar_ai_recommendation_software_tpu")]
