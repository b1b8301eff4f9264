"""The port's temporal flow (``models/temporal.py``) and
``Pipeline.analyze_sequence`` against the JAX package's, on the CPU: the
same numpy inputs, made from seeds, through both.

The cases mirror tests/test_temporal.py, and add the duplicate targets of
a pair's inverted matches, exact distance ties and the growth of the
people capacity in mid-sequence.

Tolerances: match indices, match flags, occupied nodes, bottleneck
severities and masks, people counts and directions exact; node positions
exact (the same float32 operations); on the same people, node vectors,
magnitudes, average speed and mean vector within FLOW_TOL = 1e-5 m/s (a
node's vector is a mean of float32 velocity samples summed over people,
and the average speed a sum over nodes, in another order than XLA's);
velocities of ``frame_velocities`` within 1e-6 (one subtraction and one
division each, the same in both). Through the pipelines, the people's
centroids differ by float32 ulps (CENTROID_TOL = 1e-5 m, as
tests/test_torch_density_flow.py; their sums run in another order), and a
velocity is a difference of two centroids over dt = 0.5 s, so the flow is
held within SEQUENCE_TOL = 5e-5 m/s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidar_ai_recommendation_software_tpu.config import MONOLITH_CONFIG
from lidar_ai_recommendation_software_tpu.models import temporal as jtemp
from lidar_ai_recommendation_software_tpu.pipeline import (
    Pipeline as JaxPipe, people_of_cloud as jax_people_of_cloud)
from lidar_ai_recommendation_software_tpu.synthetic import venue_sequence
from lidar_ai_recommendation_software_tpu.types import (
    People as JaxPeople, PointCloud as JaxCloud)
from lidar_ai_recommendation_software_tpu_torch.models import (
    temporal as ttemp)
from lidar_ai_recommendation_software_tpu_torch.pipeline import Pipeline
from lidar_ai_recommendation_software_tpu_torch.types import (
    People, PointCloud)
from port_helpers import port_cfg

FLOW_TOL = 1e-5
CENTROID_TOL = 1e-5
SEQUENCE_TOL = 5e-5
CFG = port_cfg(MONOLITH_CONFIG)


def _people(xy, cap=64, z=1.0, mask=None):
    """(JAX People, port People) of the same padded arrays."""
    buf = np.zeros((cap, 2), np.float32)
    buf[:len(xy)] = xy
    m = np.zeros(cap, bool)
    m[:len(xy)] = True if mask is None else mask
    zz = np.full(cap, z, np.float32)
    return (JaxPeople(positions=jnp.asarray(buf), mask=jnp.asarray(m),
                      z=jnp.asarray(zz)),
            People(positions=torch.from_numpy(buf), mask=torch.from_numpy(m),
                   z=torch.from_numpy(zz),
                   overflow=torch.zeros((), dtype=torch.int32)))


def _stack_jax(seq):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *seq)


def _assert_flow_equal(got, want):
    """A port FlowResults against a JAX one, field by field."""
    for key in ("node_mask", "bottleneck_severity", "bottleneck_mask",
                "positions", "bottleneck_xy"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(getattr(want, key)), key)
    for key in ("vectors", "magnitudes", "avg_speed", "mean_vector"):
        np.testing.assert_allclose(getattr(got, key).numpy(),
                                   np.asarray(getattr(want, key)),
                                   atol=FLOW_TOL, rtol=0, err_msg=key)


def _multi(frames_xy, masks=None, cap=64, dt=1.0, lo=-14.0, hi=14.0):
    """temporal_flow_multi of both packages on the same frames: (port's,
    JAX's)."""
    pairs = [_people(xy, cap, mask=None if masks is None else masks[t])
             for t, xy in enumerate(frames_xy)]
    mins, maxs = np.float32([lo, lo]), np.float32([hi, hi])
    want = jtemp.temporal_flow_multi(
        _stack_jax([p[0] for p in pairs]), dt, jnp.asarray(mins),
        jnp.asarray(maxs), MONOLITH_CONFIG)
    got = ttemp.temporal_flow_multi(
        ttemp.stack_people([p[1] for p in pairs]), dt,
        torch.from_numpy(mins), torch.from_numpy(maxs), CFG)
    return got, want


# --- frame_velocities: tests/test_temporal.py's first two cases ----------

def _known_motion():
    rng = np.random.RandomState(0)
    prev_xy = rng.uniform(-10, 10, (20, 2))
    return prev_xy, prev_xy + np.array([1.0, 0.5]) * 0.5, 0.5


def _teleport():
    return np.array([[0.0, 0.0]]), np.array([[50.0, 50.0]]), 0.1


@pytest.mark.parametrize("case", [_known_motion, _teleport],
                         ids=["known_motion", "teleport"])
def test_frame_velocities_match_jax(case):
    prev_xy, curr_xy, dt = case()
    (jp, tp), (jc, tc) = _people(prev_xy), _people(curr_xy)
    wv, wok = jtemp.frame_velocities(jp, jc, dt=dt)
    gv, gok = ttemp.frame_velocities(tp, tc, dt=dt)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-6, rtol=0)
    if case is _known_motion:
        assert gok[:20].all() and not gok[20:].any()
        np.testing.assert_allclose(gv[:20].numpy(), np.tile([1.0, 0.5],
                                                             (20, 1)),
                                   atol=1e-5)
    else:
        assert not gok.any()


def test_match_people_distance_ties_take_the_first_index():
    """People on an integer lattice: a current person midway between two
    previous ones is at exactly the same distance from both; both
    packages take the first index, for the forward and the backward
    match."""
    prev_xy = np.array([[0.0, 0.0], [2.0, 0.0], [0.0, 2.0], [2.0, 2.0]])
    curr_xy = np.array([[1.0, 0.0], [1.0, 2.0], [0.0, 1.0], [2.0, 1.0],
                        [1.0, 1.0]])
    (jp, tp), (jc, tc) = _people(prev_xy, 8), _people(curr_xy, 8)
    for max_dist in (1.5, torch.tensor(1.5)):
        want = jtemp.match_people(jp, jc, max_dist=1.5)
        got = ttemp.match_people(tp, tc, max_dist=max_dist)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][:5].tolist() == [0, 2, 0, 1, 0]


# --- temporal_flow and temporal_flow_multi: the flow cases ---------------

def _lattice(seed):
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.linspace(-10, 10, 6), np.linspace(-8, 8, 5))
    return (np.stack([gx.ravel(), gy.ravel()], 1)
            + rng.uniform(-0.4, 0.4, (30, 2))), rng


def test_temporal_flow_field_matches_jax():
    prev_xy, _ = _lattice(1)
    curr_xy = prev_xy + np.array([0.6, 0.0])
    cap = MONOLITH_CONFIG.capacity.max_people
    (jp, tp), (jc, tc) = _people(prev_xy, cap), _people(curr_xy, cap)
    mins, maxs = np.float32([-12.0, -12.0]), np.float32([12.0, 12.0])
    want = jtemp.temporal_flow(jp, jc, 1.0, jnp.asarray(mins),
                               jnp.asarray(maxs), MONOLITH_CONFIG)
    got = ttemp.temporal_flow(tp, tc, 1.0, torch.from_numpy(mins),
                              torch.from_numpy(maxs), CFG)
    _assert_flow_equal(got, want)
    d = got.to_host_dict()
    assert d["dominant_direction"] == "E"
    assert abs(d["avg_speed"] - 0.6) < 1e-4


def _multi_frame_drift():
    base, rng = _lattice(2)
    frames, pos = [], base.copy()
    for _ in range(5):
        frames.append(pos.copy())
        pos = pos + np.array([0.5, 0.0]) + rng.normal(0, 0.1, (30, 2))
    return dict(frames_xy=frames, cap=MONOLITH_CONFIG.capacity.max_people,
                lo=-14.0, hi=16.0)


def _crossing_lanes():
    xs = np.linspace(-10, 4, 8)
    frames = []
    for t in range(6):
        a = np.stack([xs + 1.0 * t, np.full(8, +0.3)], 1)
        b = np.stack([-xs - 1.0 * t, np.full(8, -0.3)], 1)
        frames.append(np.concatenate([a, b]))
    return dict(frames_xy=frames)


def _entry_exit():
    rng = np.random.RandomState(3)
    base = rng.uniform(-8, 8, (12, 2))
    frames, masks = [], []
    for t in range(5):
        frames.append(base + np.array([0.7, 0.0]) * t)
        m = np.ones(12, bool)
        m[0] = t < 2
        m[11] = t >= 3
        masks.append(m)
    return dict(frames_xy=frames, masks=masks)


def _merge_split():
    rng = np.random.RandomState(4)
    bg = rng.uniform(5, 12, (6, 2))
    frames = []
    for t in range(5):
        py, qy = -0.8 + 0.4 * t, 0.8 - 0.4 * t
        ppl = (np.array([[0.0, py]]) if abs(py - qy) < 1e-6
               else np.array([[0.0, py], [0.0, qy]]))
        frames.append(np.concatenate([ppl, bg + np.array([0.4, 0.0]) * t]))
    return dict(frames_xy=frames)


FLOW_CASES = {"multi_frame_drift": _multi_frame_drift,
              "crossing_lanes": _crossing_lanes,
              "entry_exit": _entry_exit, "merge_split": _merge_split}


@pytest.mark.parametrize("name", sorted(FLOW_CASES))
def test_temporal_flow_multi_matches_jax(name):
    got, want = _multi(**FLOW_CASES[name]())
    _assert_flow_equal(got, want)
    d = got.to_host_dict()
    vec = d["flow_vectors"]["vectors"]
    live = np.linalg.norm(vec, axis=1) > 0.05
    assert live.any()
    if name == "multi_frame_drift":
        assert d["dominant_direction"] == "E"
        assert abs(d["avg_speed"] - 0.5) < 0.1
    if name == "crossing_lanes":
        assert np.all(np.abs(np.abs(vec[live, 0]) - 1.0) < 0.15)
    if name == "entry_exit":
        np.testing.assert_allclose(vec[live, 0], 0.7, atol=0.1)
    if name == "merge_split":
        assert np.linalg.norm(vec[live], axis=1).max() < 0.6


def test_two_frame_wrapper_is_multi_on_two_frames():
    frames = _multi_frame_drift()["frames_xy"][:2]
    cap = MONOLITH_CONFIG.capacity.max_people
    (_, p0), (_, p1) = _people(frames[0], cap), _people(frames[1], cap)
    mins, maxs = torch.tensor([-14.0, -12.0]), torch.tensor([16.0, 12.0])
    two = ttemp.temporal_flow(p0, p1, 1.0, mins, maxs, CFG)
    pair = ttemp.temporal_flow_multi(ttemp.stack_people([p0, p1]), 1.0, mins,
                                     maxs, CFG)
    for key in ("vectors", "node_mask", "avg_speed"):
        assert torch.equal(getattr(two, key), getattr(pair, key))


def test_inverted_matches_keep_the_last_row_of_a_repeated_target():
    """The JAX package inverts pair t + 1's matches with
    ``.at[idx].set(...)``; its padded rows all match person 0 (argmin of an
    all-1e18 row), and on the CPU the last of repeated targets wins. So
    frame 1's person 0 finds no next velocity and its pair-0 sample is
    dropped, while persons 1 and 2 keep theirs. The port keeps the same
    row (``_last_writer``), on the CPU and the card alike.

    Person 0 walks alone at 1.0 then 1.5 m/s (within the consistency
    tolerance): the nodes around it average only its pair-1 sample."""
    frames = [np.array([[0.0, 0.0], [8.0, 8.0], [-8.0, 8.0]]),
              np.array([[1.0, 0.0], [8.5, 8.0], [-7.5, 8.0]]),
              np.array([[2.5, 0.0], [9.0, 8.0], [-7.0, 8.0]])]
    got, want = _multi(frames, cap=8)
    _assert_flow_equal(got, want)
    last = ttemp._last_writer(torch.tensor([1, 0, 2, 0, 0, 0]), 4)
    assert last.tolist() == [5, 0, 2, -1]
    pos = got.positions.numpy()
    near0 = (np.abs(pos[:, 1]) < 1.5) & (pos[:, 0] > -1) & (pos[:, 0] < 4)
    live = got.node_mask.numpy() & near0
    assert live.any()
    np.testing.assert_allclose(got.vectors.numpy()[live],
                               np.tile([1.5, 0.0], (int(live.sum()), 1)),
                               atol=1e-6)


# --- the pipeline --------------------------------------------------------

def test_cloud_and_people_helpers():
    pts = np.random.RandomState(5).uniform(-3, 3, (50, 3))
    cloud = PointCloud.from_numpy(pts, 64)
    jcloud = JaxCloud.from_numpy(pts, 64)
    assert cloud.capacity == jcloud.capacity == 64
    assert int(cloud.count) == int(jcloud.count) == 50
    z = np.float32([0.1, 0.5, 0.31, 2.0])
    jp = JaxPeople(positions=jnp.zeros((4, 2)), mask=jnp.asarray(
        [True, True, True, False]), z=jnp.asarray(z))
    tp = People(positions=torch.zeros(4, 2), mask=torch.tensor(
        [True, True, True, False]), z=torch.from_numpy(z),
        overflow=torch.zeros((), dtype=torch.int32))
    want = jp.person_like(0.3, jnp.float32(0.0)).mask
    got = tp.person_like(0.3, torch.tensor(0.0)).mask
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, True, True, False]


def _jax_tracked(pipe, frames, cfg, offset):
    """Each frame's person-like people through the JAX package's
    ``people_of_cloud`` under ``cfg``: the (T, K) stack."""
    out = []
    for f in frames:
        cloud = JaxCloud.from_numpy(np.asarray(f, np.float64) - offset,
                                    cfg.capacity.max_points)
        proc, ppl = jax_people_of_cloud(cloud, cfg)
        assert int(proc.cluster_overflow) == 0 and int(ppl.overflow) == 0
        out.append(ppl.person_like(pipe.config.flow.track_min_height,
                                   proc.mins[2]))
    return _stack_jax(out)


def _assert_sequence_equal(got, want_flow, want_density):
    gf = got["flow"]
    assert gf["dominant_direction"] == want_flow["dominant_direction"]
    assert [b["severity"] for b in gf["bottlenecks"]] == [
        b["severity"] for b in want_flow["bottlenecks"]]
    assert abs(gf["avg_speed"] - want_flow["avg_speed"]) < SEQUENCE_TOL
    np.testing.assert_array_equal(gf["flow_vectors"]["positions"],
                                  want_flow["flow_vectors"]["positions"])
    for key in ("vectors", "magnitudes"):
        np.testing.assert_allclose(gf["flow_vectors"][key],
                                   want_flow["flow_vectors"][key],
                                   atol=SEQUENCE_TOL, rtol=0)
    assert got["density"]["total_people"] == want_density["total_people"]


def test_analyze_sequence_matches_jax():
    """tests/test_temporal.py's sequence through both pipelines: the same
    flow, the same density, the same people tracked in every frame; and
    the generator's motion recovered (cosine > 0.9)."""
    frames = venue_sequence(n_frames=4, dt=0.5, n_points=8000, n_people=40,
                            extent=15.0, speed=1.0)
    jpipe = JaxPipe()
    want = jpipe.analyze_sequence(frames, dt=0.5)
    got = Pipeline(device="cpu").analyze_sequence(frames, dt=0.5)
    _assert_sequence_equal(got, want["flow"], want["density"])
    cfg = jpipe.fit_capacity(np.asarray(frames[0], np.float64))
    tracked = _jax_tracked(jpipe, frames, cfg, np.zeros(3))
    np.testing.assert_array_equal(got["tracked_people"].mask.numpy(),
                                  np.asarray(tracked.mask))
    np.testing.assert_allclose(got["tracked_people"].positions.numpy(),
                               np.asarray(tracked.positions),
                               atol=CENTROID_TOL, rtol=0)
    f = got["flow"]
    pos, v = f["flow_vectors"]["positions"], f["flow_vectors"]["vectors"]
    vn = np.linalg.norm(v, axis=1)
    ok = vn > 0.05
    gt = np.stack([15.0 - pos[:, 0], -pos[:, 1]], 1)
    gt /= np.maximum(np.linalg.norm(gt, axis=1, keepdims=True), 1e-9)
    assert float(np.mean(np.sum(v[ok] / vn[ok, None] * gt[ok], 1))) > 0.9
    assert 0.2 < f["avg_speed"] < 2.0


def _growth_frames():
    """Three frames whose first is the largest (the people capacity is
    fitted to it: 1,024) and holds 100 people of 30 points, while the next
    two hold 1,120 people of 5 points each, walking +x at 0.6 m/s, over
    terrain that is the lowest 30% of each frame."""
    rng = np.random.RandomState(6)
    side = 34
    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    centres = (np.stack([i.ravel(), j.ravel()], 1).astype(float)
               + rng.uniform(-0.1, 0.1, (side * side, 2)))[:1120]

    def frame(n_people, per_person, shift, n_terrain):
        c = centres[:n_people] + [shift, 0.0]
        n = per_person * n_people
        pts = np.repeat(c, per_person, axis=0) + rng.normal(0, 0.03, (n, 2))
        z = np.repeat(rng.uniform(0.9, 1.3, n_people), per_person) + (
            rng.normal(0, 0.02, n))
        ter = np.column_stack([rng.uniform(0, side, (n_terrain, 2)),
                               rng.uniform(-0.05, 0.0, n_terrain)])
        return np.concatenate([np.column_stack([pts, z]), ter])

    return [frame(100, 30, 0.0, 5001), frame(1120, 5, 0.3, 2400),
            frame(1120, 5, 0.6, 2400)]


def test_analyze_sequence_grows_the_people_capacity():
    """A frame whose clusters outgrow the people capacity fitted to the
    largest frame: the JAX package's analyze_sequence fails to stack the
    frames (its first frame keeps the old capacity); the port extracts
    the earlier frames again under the grown config, and gives what the
    JAX package computes when it fits that config first."""
    frames = _growth_frames()
    jpipe = JaxPipe()
    cfg = jpipe.fit_capacity(np.asarray(frames[0], np.float64))
    assert cfg.capacity.max_people == 1024
    with pytest.raises(ValueError):
        jpipe.analyze_sequence(frames, dt=0.5)
    grown = cfg.with_capacity(max_people=2048)
    final = jpipe.analyze(frames[-1])
    tracked = _jax_tracked(jpipe, frames, grown, np.zeros(3))
    proc = final["processed"]
    want = jtemp.temporal_flow_multi(
        tracked, jnp.asarray(0.5, jnp.float32), proc.mins[:2],
        proc.maxs[:2], grown).to_host_dict()
    got = Pipeline(device="cpu").analyze_sequence(frames, dt=0.5)
    assert got["tracked_people"].mask.shape == (3, 2048)
    assert got["tracked_people"].mask.sum(1).tolist() == [100, 1120, 1120]
    _assert_sequence_equal(got, want, final["density"])
    assert got["flow"]["dominant_direction"] == "E"
