"""Temporal crowd flow: people tracked across point-cloud frames, their
velocities averaged onto the analysis lattice.

The PyTorch counterpart of the JAX package's ``models/temporal.py``:
people are matched between consecutive frames by mutual nearest centroid
within ``track_max_speed * dt``, each match's velocity is kept only where
it agrees with the same person's velocity in the pair before or after
(three frames or more), and every surviving sample is averaged onto the
lattice nodes within one grid step of it. The result is a ``FlowResults``
of the same layout as ``models/flow.py``'s, with its bottlenecks found by
the same stencil.

Tensor code on the device of its inputs. The all-pairs tests (the
nearest slots of a pair of frames, the samples around each lattice node)
go through ``ops/cuda/track.py``: one kernel body on the card, its plain
twins on the CPU. Two orders of the JAX package are kept on purpose, so
that both packages give the same answer:

  - ``argmin`` takes the first index among equal distances, on the CPU
    and on the card (a masked row, all 1e18, matches index 0);
  - the inversion of a pair's matches scatters with repeated targets (the
    masked rows' index 0, and any target two rows matched), and the JAX
    package's ``.at[idx].set`` on the CPU keeps the LAST row's value for a
    repeated target. ``_last_writer`` picks that row explicitly, so the
    card, whose ``index_put_`` with repeated indices is not deterministic,
    gives the same answer.

The node accumulation is a masked sum over (nodes, people); its float32
sums run in another order than XLA's (and the card's than the CPU's).

``temporal_flow_multi`` records its stages as ``utils.profiling`` spans:
``temporal.flow`` around the call, and inside it ``temporal.match``,
``temporal.consistency``, ``temporal.nodes`` and ``temporal.bottlenecks``.
The counter ``temporal.pair_tests`` adds the pair tests of the all-pairs
formulation, from the shapes alone: (T - 1) K^2 in ``temporal.match`` and
(T - 1) nodes K in ``temporal.nodes``. No span reads the device.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.config import PipelineConfig
from lidar_ai_recommendation_software_tpu_torch.models.flow import (
    _bottlenecks_monolith)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda import track
from lidar_ai_recommendation_software_tpu_torch.types import (
    FlowResults, People)
from lidar_ai_recommendation_software_tpu_torch.utils import profiling
from lidar_ai_recommendation_software_tpu_torch.utils.profiling import stage


def match_people(prev: People, curr: People,
                 max_dist: Union[float, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy mutual nearest-neighbour matching: (index (K,) int32 into
    ``prev`` of each current person's nearest previous person, matched
    (K,) bool). A pair matches when each is the other's nearest and they
    lie within ``max_dist``. A float ``max_dist`` is squared in float64
    and rounded once (the JAX package's eager call); a float32 tensor is
    squared in float32 (its jitted one). The nearest slots both ways come
    from ``track.nearest``, one kernel launch on the card."""
    fwd, dmin, bwd = track.nearest(curr.positions, curr.mask,
                                   prev.positions, prev.mask)
    dev = fwd.device
    rows = torch.arange(fwd.shape[0], device=dev)
    mutual = bwd[fwd.to(torch.int64)] == rows
    if isinstance(max_dist, torch.Tensor):
        limit = max_dist * max_dist
    else:
        limit = torch.tensor(np.float32(float(max_dist) * float(max_dist)),
                             device=dev)
    close = dmin <= limit
    return fwd, mutual & close & curr.mask


def _dt_tensor(dt, device: torch.device) -> torch.Tensor:
    """``dt`` as a float32 tensor on ``device``: velocities divide by it,
    and a division by a tensor rounds once on the CPU and the card."""
    return torch.as_tensor(dt, dtype=torch.float32).to(device)


def frame_velocities(prev: People, curr: People, dt: float,
                     max_speed: float = 3.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-person velocity between two frames: (velocities (K, 2), valid
    (K,)); 0 where a person has no match."""
    idx, ok = match_people(prev, curr, max_dist=max_speed * dt)
    vel = ((curr.positions - prev.positions[idx.to(torch.int64)])
           / _dt_tensor(dt, curr.positions.device))
    return torch.where(ok[:, None], vel, 0.0), ok


def _last_writer(idx: torch.Tensor, k: int) -> torch.Tensor:
    """For each of ``k`` targets, the last row ``r`` with ``idx[r]`` equal
    to it, -1 for none: the row whose value a sequential scatter keeps."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((k,), -1, dtype=torch.int64, device=idx.device)
    return last.scatter_reduce(0, idx.to(torch.int64), rows, reduce="amax")


def _frame(seq: People, t: int) -> People:
    return People(positions=seq.positions[t], mask=seq.mask[t], z=seq.z[t],
                  overflow=seq.overflow[t])


def stack_people(frames: List[People]) -> People:
    """People of T frames of one capacity K as one People of (T, K, ...)
    tensors."""
    return People(*(torch.stack([getattr(p, f) for p in frames])
                    for f in ("positions", "mask", "z", "overflow")))


def accumulate_samples(nodes: torch.Tensor, g2: torch.Tensor,
                       positions: torch.Tensor,
                       pairs: List[Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]],
                       keeps: List[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every kept sample of every pair onto the ``nodes`` (G, 2) within
    ``g2`` (the squared grid step) of it: the velocity sums (G, 2) and the
    sample counts (G,) int32. Pair t's velocities sit at frame t + 1's
    ``positions``; ``track.node_sums`` tests every pair, one kernel launch
    on the card."""
    if not pairs:  # one frame: no sample
        return (positions.new_zeros((nodes.shape[0], 2)),
                torch.zeros(nodes.shape[0], dtype=torch.int32,
                            device=positions.device))
    return track.node_sums(nodes, g2, positions,
                           torch.stack([vel for _, _, vel in pairs]),
                           torch.stack(keeps))


def temporal_flow_multi(people_seq: People, dt, mins: torch.Tensor,
                        maxs: torch.Tensor,
                        config: PipelineConfig) -> FlowResults:
    """Flow field of a tracked sequence on the analysis lattice.

    ``people_seq`` holds T frames' people stacked, (T, K, ...). Each pair
    of consecutive frames is tracked on its own and its velocities are
    sampled around the later frame's positions; a node's vector is the
    mean over every surviving sample of every pair. Nodes with no sample
    carry zero vectors and stay out of the statistics."""
    cap = config.capacity
    n_frames, k = people_seq.positions.shape[:2]
    with stage("temporal.flow", frames=n_frames, slots=k,
               nodes=cap.grid_cells_x * cap.grid_cells_y):
        return _temporal_flow_multi(people_seq, dt, mins, maxs, config)


def _temporal_flow_multi(people_seq: People, dt, mins: torch.Tensor,
                         maxs: torch.Tensor,
                         config: PipelineConfig) -> FlowResults:
    fc = config.flow
    cap = config.capacity
    pos = people_seq.positions
    dev, dtype = pos.device, pos.dtype
    n_frames, k = pos.shape[0], pos.shape[1]
    dt_t = _dt_tensor(dt, dev)

    g = torch.tensor(fc.grid_size, dtype=dtype, device=dev)
    gx, gy = cap.grid_cells_x, cap.grid_cells_y
    x0, y0 = mins[0], mins[1]
    nx = torch.ceil((maxs[0] + g - x0) / g).to(torch.int32).clamp(1, gx)
    ny = torch.ceil((maxs[1] + g - y0) / g).to(torch.int32).clamp(1, gy)
    ii = torch.arange(gx, dtype=dtype, device=dev)
    jj = torch.arange(gy, dtype=dtype, device=dev)
    px = (x0 + ii * g)[:, None].expand(gx, gy)
    py = (y0 + jj * g)[None, :].expand(gx, gy)
    valid = ((torch.arange(gx, device=dev)[:, None] < nx)
             & (torch.arange(gy, device=dev)[None, :] < ny))
    nodes = torch.stack([px.reshape(-1), py.reshape(-1)], dim=1)

    # per pair t (frames t -> t + 1): matches and velocities, indexed by
    # frame t + 1's people
    with stage("temporal.match"):
        profiling.count("temporal.pair_tests", (n_frames - 1) * k * k)
        max_dist = torch.tensor(fc.track_max_speed, dtype=torch.float32,
                                device=dev) * dt_t
        pairs = []
        for t in range(n_frames - 1):
            prev, curr = _frame(people_seq, t), _frame(people_seq, t + 1)
            idx, ok = match_people(prev, curr, max_dist)
            vel = ((curr.positions - prev.positions[idx.to(torch.int64)])
                   / dt_t)
            pairs.append((idx.to(torch.int64), ok,
                          torch.where(ok[:, None], vel, 0.0)))

    # three frames or more: keep a sample only where it agrees, within
    # track_consistency_tol, with the same person's velocity in the pair
    # before or after (merges and splits swap identities and leave
    # outliers that a mutual-nearest check cannot see)
    with stage("temporal.consistency"):
        tol2 = torch.tensor(np.float32(fc.track_consistency_tol),
                            device=dev) ** 2
        keeps = []
        for t, (idx, ok, vel) in enumerate(pairs):
            if n_frames < 3:
                keeps.append(ok)
                continue
            with_prev = torch.zeros(k, dtype=torch.bool, device=dev)
            if t > 0:
                _, ok_p, vel_p = pairs[t - 1]
                pv, p_ok = vel_p[idx], ok_p[idx]
                dv = vel - pv
                with_prev = ok & p_ok & (dv[:, 0] * dv[:, 0]
                                         + dv[:, 1] * dv[:, 1] <= tol2)
            with_next = torch.zeros(k, dtype=torch.bool, device=dev)
            if t < len(pairs) - 1:
                idx_n, ok_n, vel_n = pairs[t + 1]
                # pair t + 1's map inverted: frame t + 1 person j -> its
                # velocity in pair t + 1, the last row to name j winning
                last = _last_writer(idx_n, k)
                has = last >= 0
                src = last.clamp_min(0)
                nv = torch.where(
                    has[:, None],
                    torch.where(ok_n[:, None], vel_n, 0.0)[src], 0.0)
                n_ok = has & ok_n[src]
                dv = vel - nv
                with_next = ok & n_ok & (dv[:, 0] * dv[:, 0]
                                         + dv[:, 1] * dv[:, 1] <= tol2)
            keeps.append(ok & (with_prev | with_next))

    # every surviving sample onto the nodes within one grid step of it
    with stage("temporal.nodes"):
        profiling.count("temporal.pair_tests",
                        (n_frames - 1) * nodes.shape[0] * k)
        wsum, cnt = accumulate_samples(nodes, g * g, pos, pairs, keeps)
        vectors = (wsum / cnt.clamp_min(1)[:, None]).reshape(gx, gy, 2)
        occupied = (cnt > 0).reshape(gx, gy) & valid
        vectors = torch.where(occupied[..., None], vectors, 0.0)
        mags = torch.sqrt(vectors[..., 0] * vectors[..., 0]
                          + vectors[..., 1] * vectors[..., 1])

        ocount = occupied.sum(dtype=torch.int32).clamp_min(1)
        avg_speed = torch.where(occupied, mags, 0.0).sum() / ocount
        mean_vec = torch.where(occupied[..., None], vectors, 0.0).sum(
            dim=(0, 1)) / ocount

    with stage("temporal.bottlenecks"):
        # bottlenecks: slow occupied nodes next to faster flow, by the
        # monolith's stencil on the measured field; ties keep the
        # lattice's y-major scan order, as the JAX package's top_k
        sev, ok_b = _bottlenecks_monolith(mags, occupied, config)
        fx = px.T.reshape(-1)
        fy = py.T.reshape(-1)
        scores = torch.where(ok_b.T.reshape(-1), sev.T.reshape(-1), -1)
        top_v, top_i = torch.sort(scores, descending=True, stable=True)
        top_v = top_v[:fc.max_bottlenecks]
        top_i = top_i[:fc.max_bottlenecks]
        bmask = top_v >= 0
        return FlowResults(
            positions=torch.stack([fx, fy], dim=1),
            vectors=vectors.transpose(0, 1).reshape(-1, 2),
            magnitudes=mags.T.reshape(-1),
            node_mask=occupied.T.reshape(-1),
            avg_speed=avg_speed,
            mean_vector=mean_vec,
            bottleneck_xy=torch.stack([fx[top_i], fy[top_i]], dim=1),
            bottleneck_severity=torch.where(bmask, top_v, 0),
            bottleneck_mask=bmask)


def temporal_flow(prev: People, curr: People, dt, mins: torch.Tensor,
                  maxs: torch.Tensor, config: PipelineConfig) -> FlowResults:
    """Two-frame form of ``temporal_flow_multi``."""
    return temporal_flow_multi(stack_people([prev, curr]), dt, mins, maxs,
                               config)
