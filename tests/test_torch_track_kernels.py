"""The temporal tracking's all-pairs kernels (``ops/cuda/track.py``,
``csrc/track_pairs.cu``): ``track_match``, the nearest slot of each frame
in the other, and ``track_nodes``, the kept velocity samples around each
lattice node.

On the CPU: the launch plans from the shapes, the plans' constants in the
kernel's source, CPU tensors taking the plain twins without a launch, and
the twins equal to the code of ``models/temporal.py`` they came from.

On the card (marker ``cuda``, skipped without one): ``track_match``
bit-equal to ``nearest_reference`` in ``fwd``, ``dmin`` and ``bwd``, at the
sequence's K = 14,336 and at odd K, with every slot masked, one live slot,
equal distances and masked rows; ``track_nodes`` against
``node_sums_reference`` at 16,384 nodes x 14,336 slots x 3 pairs: counts
equal, each velocity sum within 1e-6 m/s times its count (the kernel adds
a node's samples in index order, torch's sum over the slots in its own
order: float32 reassociation, a few ulps of a sum of about a count's
worth of 1 m/s samples); a second run of each bit-identical; one launch a
pair and one for the node sums through ``temporal_flow_multi``.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_track_kernels.py -q
"""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu_torch import MONOLITH_CONFIG
from lidar_ai_recommendation_software_tpu_torch.models import temporal
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import kernels as K
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import track as T
from lidar_ai_recommendation_software_tpu_torch.types import People

# the sequence cell's shapes: people slots, lattice nodes, pairs of frames
SEQ_K, SEQ_NODES, SEQ_PAIRS = 14_336, 16_384, 3
NODE_SUM_TOL = 1e-6  # m/s, times the node's count


def _frames(k, live, seed, span=None, garbage=False):
    """Two frames of ``k`` people slots, ``live`` of them live in each,
    spread over the first ``span`` slots (as the clusters' dense ids and
    the person-like mask leave them), positions on a 95 m venue. Masked
    slots hold 0, or with ``garbage`` any float, which no answer may
    read."""
    rng = np.random.RandomState(seed)
    span = k if span is None else span
    out = []
    for _ in range(2):
        pos = rng.uniform(-47.5, 47.5, (k, 2)).astype(np.float32)
        mask = np.zeros(k, bool)
        mask[rng.choice(span, min(live, span), replace=False)] = True
        if not garbage:
            pos[~mask] = 0.0
        out.append((pos, mask))
    return out


def _ties(k):
    """A query slot with three other slots at exactly the same distance,
    in other column tiles, segments and threads, and a second query slot
    equally far from two: the first index must win."""
    pos = [np.zeros((k, 2), np.float32) for _ in range(2)]
    mask = [np.zeros(k, bool) for _ in range(2)]
    pos[0][3] = (1.0, 0.0)
    pos[0][600] = (10.0, 10.0)
    for j, xy in ((1300, (0.0, 0.0)), (700, (2.0, 0.0)), (5, (1.0, 1.0)),
                  (1000, (10.0, 11.0)), (64, (10.0, 9.0))):
        pos[1][j] = xy
        mask[1][j] = True
    mask[0][[3, 600]] = True
    return list(zip(pos, mask))


def _match_case(name, small=False):
    """The two frames of a named case; ``small`` cuts the sequence's K
    (and the all-live odd K) to sizes whose (K, K) plain matrices the CPU
    tests build in well under a second."""
    seq, odd = (2_048, 1_537) if small else (SEQ_K, 14_337)
    live, span = (150, 600) if small else (470, 3_300)
    return {
        "sequence K, 470 live in 3,300": lambda: _frames(seq, live, 0, span),
        "sequence K, masked slots hold garbage": lambda: _frames(
            seq, live, 1, span, garbage=True),
        "K = 1": lambda: _frames(1, 1, 2),
        "K = 31": lambda: _frames(31, 20, 3),
        "K = 513": lambda: _frames(513, 400, 4),
        "odd K, every slot live": lambda: _frames(odd, odd, 5),
        "every slot masked": lambda: _frames(2_000, 0, 6),
        "one live slot a frame": lambda: _frames(2_000, 1, 7),
        "one frame all masked": lambda: [_frames(2_000, 300, 8)[0],
                                         _frames(2_000, 0, 9)[1]],
        "equal distances": lambda: _ties(2_048),
    }[name]()


MATCH_CASES = ["sequence K, 470 live in 3,300",
               "sequence K, masked slots hold garbage", "K = 1", "K = 31",
               "K = 513", "odd K, every slot live", "every slot masked",
               "one live slot a frame", "one frame all masked",
               "equal distances"]


def _node_case(k=SEQ_K, nodes_side=128, pairs=SEQ_PAIRS, live=470, seed=0):
    """The node sums' inputs at the sequence's shapes: a lattice of
    ``nodes_side`` squared nodes 1 m apart, ``pairs + 1`` frames of people,
    velocities about 1 m/s, about ``live`` kept samples a pair."""
    rng = np.random.RandomState(seed)
    i, j = np.meshgrid(np.arange(nodes_side), np.arange(nodes_side),
                       indexing="ij")
    nodes = np.stack([-47.5 + i.ravel(), -47.5 + j.ravel()],
                     1).astype(np.float32)
    positions = rng.uniform(-48.5, nodes_side - 47.5,
                            (pairs + 1, k, 2)).astype(np.float32)
    keep = np.zeros((pairs, k), bool)
    for t in range(pairs):
        keep[t, rng.choice(min(k, 3_300), live, replace=False)] = True
    vel = np.where(keep[..., None],
                   rng.uniform(-1.5, 1.5, (pairs, k, 2)), 0.0).astype(
                       np.float32)
    g = torch.tensor(1.0, dtype=torch.float32)
    return (torch.from_numpy(nodes), g * g, torch.from_numpy(positions),
            torch.from_numpy(vel), torch.from_numpy(keep))


# ---------------------------------------------------------------------------
# the code the twins came from (models/temporal.py before the kernels)
# ---------------------------------------------------------------------------

def _old_squared_distances(a, b):
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    return dx * dx + dy * dy


def _old_match_people(prev, curr, max_dist):
    d2 = _old_squared_distances(curr.positions, prev.positions)
    d2 = torch.where(curr.mask[:, None] & prev.mask[None, :], d2,
                     torch.tensor(1e18, dtype=d2.dtype, device=d2.device))
    fwd = torch.argmin(d2, dim=1)
    bwd = torch.argmin(d2, dim=0)
    k = curr.positions.shape[0]
    rows = torch.arange(k, device=d2.device)
    mutual = bwd[fwd] == rows
    if isinstance(max_dist, torch.Tensor):
        limit = max_dist * max_dist
    else:
        limit = torch.tensor(np.float32(float(max_dist) * float(max_dist)),
                             device=d2.device)
    close = d2[rows, fwd] <= limit
    return fwd.to(torch.int32), mutual & close & curr.mask


def _old_accumulate_samples(nodes, g2, positions, pairs, keeps):
    k = positions.shape[1]
    wsum = torch.zeros((nodes.shape[0], 2), dtype=positions.dtype,
                       device=positions.device)
    cnt = torch.zeros(nodes.shape[0], dtype=torch.int32,
                      device=positions.device)
    chunk = max(1, K.PAIRS_PER_CHUNK // max(k, 1))
    for t, ((_, _, vel), keep) in enumerate(zip(pairs, keeps)):
        curr_pos = positions[t + 1]
        for s in range(0, nodes.shape[0], chunk):
            near = ((_old_squared_distances(nodes[s:s + chunk], curr_pos)
                     <= g2) & keep[None, :])
            wsum[s:s + chunk] += torch.where(near[..., None], vel[None],
                                             0.0).sum(1)
            cnt[s:s + chunk] += near.sum(1, dtype=torch.int32)
    return wsum, cnt


def _people(pos, mask):
    return People(positions=pos, mask=mask,
                  z=torch.zeros(pos.shape[0], device=pos.device),
                  overflow=torch.zeros((), dtype=torch.int32,
                                       device=pos.device))


def _tensors(case, dev="cpu"):
    return [(torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev))
            for p, m in case]


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

ROW_COUNTS = [1, 31, 511, 512, 513, 2_000, SEQ_K, 14_337, SEQ_NODES,
              100_000]


@pytest.mark.parametrize("n", ROW_COUNTS)
def test_plans_cover_every_row_once(n):
    for plan, grid_y in ((T.match_plan(n), T.MATCH_DIRECTIONS),
                         (T.nodes_plan(n), 1)):
        gx, gy = plan
        assert gy == grid_y
        rows = [i for x in range(gx)
                for i in range(x * T.TRACK_ROW_TILE,
                               min((x + 1) * T.TRACK_ROW_TILE, n))]
        assert rows == list(range(n))
        assert (gx - 1) * T.TRACK_ROW_TILE < n  # no block without a row


def test_plans_at_the_sequence_shapes():
    """The sequence cell: 28 row tiles of slots each way a match, 32 of
    nodes for the node sums."""
    assert T.match_plan(SEQ_K) == (28, 2)
    assert T.nodes_plan(SEQ_NODES) == (32, 1)


def test_plan_constants_are_the_kernel_source():
    """The tile sizes the plans mirror are the ones ``csrc/track_pairs.cu``
    declares; its entry points refuse a grid that does not cover the rows;
    the pair test is the plain version's, every operation rounded on its
    own; a masked pair is 1e18."""
    src = (Path(K.__file__).resolve().parents[2] / "csrc" /
           "track_pairs.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(const("kThreads")) == T.TRACK_THREADS
    assert int(const("kRowsPerThread").split()[0]) == T.TRACK_ROWS_PER_THREAD
    assert int(const("kColsPerThread").split()[0]) == T.TRACK_COLS_PER_THREAD
    assert const("kRowTile") == "kThreads * kRowsPerThread"
    assert const("kColTile") == "kThreads * kColsPerThread"
    assert float(const("kFar").rstrip("f").split()[0]) == T.FAR
    assert "static_cast<int64_t>(grid_x) * kRowTile >= n_rows" in src
    assert "grid_y != 2" in src and T.MATCH_DIRECTIONS == 2
    assert "grid_y != 1 || pairs < 1" in src
    assert "__fsub_rn(qx, cx)" in src and "__fsub_rn(qy, cy)" in src
    assert "__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))" in src
    assert "d2 <= g2" in src and "d2 < best[r]" in src
    assert len(K._SIGNATURES["track_match_launch"]) == 10
    assert len(K._SIGNATURES["track_nodes_launch"]) == 13
    assert {"track_match", "track_nodes"} <= set(K.LAUNCHES)


@pytest.mark.parametrize("name", MATCH_CASES)
def test_cpu_tensors_take_the_twins(name, monkeypatch):
    """A CPU tensor never builds the CUDA library or counts a launch; the
    wrappers answer what their twins answer."""
    def no_build():
        raise AssertionError("CPU path tried to build the CUDA kernels")
    monkeypatch.setattr(T, "load_library", no_build)
    before = dict(K.LAUNCHES)
    (qp, qm), (op, om) = _tensors(_match_case(name, small=True))
    got = T.nearest(qp, qm, op, om)
    want = T.nearest_reference(qp, qm, op, om)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [g.dtype for g in got] == [torch.int32, torch.float32,
                                      torch.int32]
    if name == "sequence K, 470 live in 3,300":
        args = _node_case(k=2_000, nodes_side=24)
        for g, w in zip(T.node_sums(*args), T.node_sums_reference(*args)):
            assert torch.equal(g, w)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("name", MATCH_CASES)
def test_match_people_is_the_code_it_came_from(name):
    """``match_people`` through ``nearest`` equals its body before the
    kernel, with a float limit (squared in float64) and a tensor one
    (squared in float32), bit for bit; masked rows match index 0."""
    (cp, cm), (pp, pm) = _tensors(_match_case(name, small=True))
    curr, prev = _people(cp, cm), _people(pp, pm)
    for max_dist in (1.5, 0.35, torch.tensor(1.5, dtype=torch.float32)):
        idx, ok = temporal.match_people(prev, curr, max_dist)
        w_idx, w_ok = _old_match_people(prev, curr, max_dist)
        assert idx.dtype == torch.int32
        assert torch.equal(idx, w_idx) and torch.equal(ok, w_ok)
    assert (idx[~cm] == 0).all()
    if name == "equal distances":
        assert idx[3] == 5 and idx[600] == 64
        fwd, dmin, bwd = T.nearest_reference(cp, cm, pp, pm)
        assert dmin[3] == 1.0 and dmin[600] == 1.0
        assert bwd[1300] == 3 and bwd[1000] == 600


@pytest.mark.parametrize("pairs", [1, 3])
def test_accumulate_samples_is_the_code_it_came_from(pairs):
    """``accumulate_samples`` through ``node_sums`` equals its loop before
    the kernel bit for bit, on lists of pairs as ``temporal_flow_multi``
    builds them; no pair gives zeros."""
    nodes, g2, positions, vel, keep = _node_case(
        k=1_500, nodes_side=40, pairs=pairs, live=300, seed=pairs)
    pair_list = [(None, None, vel[t]) for t in range(pairs)]
    keeps = [keep[t] for t in range(pairs)]
    got = temporal.accumulate_samples(nodes, g2, positions, pair_list,
                                      keeps)
    want = _old_accumulate_samples(nodes, g2, positions, pair_list, keeps)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].sum()) > 0
    none = temporal.accumulate_samples(nodes, g2, positions[:1], [], [])
    assert not none[0].any() and not none[1].any()
    assert none[0].shape == (nodes.shape[0], 2) and none[1].dtype == \
        torch.int32


def test_entry_points_keep_their_names_and_signatures():
    """``crowdbench``'s sequence kind wraps these two by name."""
    assert list(inspect.signature(temporal.match_people).parameters) == [
        "prev", "curr", "max_dist"]
    assert list(inspect.signature(
        temporal.accumulate_samples).parameters) == [
        "nodes", "g2", "positions", "pairs", "keeps"]


def test_a_tensor_off_the_cpu_needs_a_card():
    p = torch.zeros((4, 2), device="meta")
    m = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        T.nearest(p, m, p, m)
    with pytest.raises(ValueError, match="no kernel for meta"):
        T.node_sums(p, torch.zeros((), device="meta"), p[None].expand(2, 4, 2),
                    p[None], m[None])


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MATCH_CASES)
def test_track_match_is_bit_equal_to_its_twin(cuda_device, name):
    (qp, qm), (op, om) = _tensors(_match_case(name), cuda_device)
    before = K.LAUNCHES["track_match"]
    got = T.nearest(qp, qm, op, om)
    again = T.nearest(qp, qm, op, om)
    torch.cuda.synchronize()
    assert K.LAUNCHES["track_match"] == before + 2
    want = T.nearest_reference(qp, qm, op, om)
    for what, g, a, w in zip(("fwd", "dmin", "bwd"), got, again, want):
        assert torch.equal(g, w), what
        assert torch.equal(g, a), what  # a second run, bit for bit
    fwd, dmin, _ = got
    assert (fwd[~qm] == 0).all() and (dmin[~qm] == T.FAR).all()
    if name == "equal distances":
        assert int(fwd[3]) == 5 and int(fwd[600]) == 64


@pytest.mark.cuda
def test_track_nodes_against_its_twin(cuda_device):
    """16,384 nodes x 14,336 slots x 3 pairs: counts equal, each velocity
    sum within 1e-6 m/s times its count (reassociation), a second run bit
    for bit."""
    args = [a.to(cuda_device) for a in _node_case()]
    before = K.LAUNCHES["track_nodes"]
    wsum, cnt = T.node_sums(*args)
    w2, c2 = T.node_sums(*args)
    torch.cuda.synchronize()
    assert K.LAUNCHES["track_nodes"] == before + 2
    want_w, want_c = T.node_sums_reference(*args)
    assert torch.equal(cnt, want_c)
    assert int(cnt.sum()) > 0
    err = (wsum - want_w).abs().amax(1)
    assert (err <= NODE_SUM_TOL * cnt.to(torch.float32)).all(), float(
        err.max())
    assert torch.equal(wsum, w2) and torch.equal(cnt, c2)


@pytest.mark.cuda
def test_temporal_flow_launches_each_kernel(cuda_device):
    """Four frames: one ``track_match`` a pair and one ``track_nodes``,
    and the flow equal to the CPU's within the node sums' rounding."""
    rng = np.random.RandomState(11)
    k = 4_096
    base = rng.uniform(-40, 40, (k, 2)).astype(np.float32)
    mask = np.zeros(k, bool)
    mask[:400] = True
    frames = []
    for t in range(4):
        pos = np.where(mask[:, None], base + t * np.float32(0.5), 0.0)
        frames.append(_people(torch.from_numpy(pos.astype(np.float32)),
                              torch.from_numpy(mask)))
    seq = temporal.stack_people(frames)
    mins = torch.tensor([-45.0, -45.0])
    maxs = torch.tensor([45.0, 45.0])
    cfg = MONOLITH_CONFIG
    cpu = temporal.temporal_flow_multi(seq, 0.5, mins, maxs, cfg)
    K.reset_launch_counts()
    card_seq = People(*(getattr(seq, f).to(cuda_device)
                        for f in ("positions", "mask", "z", "overflow")))
    card = temporal.temporal_flow_multi(card_seq, 0.5, mins.to(cuda_device),
                                        maxs.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert K.LAUNCHES["track_match"] == 3
    assert K.LAUNCHES["track_nodes"] == 1
    assert torch.equal(card.node_mask.cpu(), cpu.node_mask)
    np.testing.assert_allclose(card.vectors.cpu().numpy(),
                               cpu.vectors.numpy(), atol=1e-5, rtol=0)
