"""Sharded CrowdNet training over a ``dp`` (batch) x ``mp`` (tensor) mesh.

The counterpart of the JAX package's ``parallel/trainer.py``, over the
port's ``models/train.py``. There ``NamedSharding`` places the state and
XLA inserts the collectives; here they are written out:

  - ``mp`` shards the state. A Dense or Conv kernel whose output-feature
    count divides by mp (``param_spec``, the JAX package's rule) is kept
    by each mp rank as its slice of the output features, and so are both
    AdamW moments (AdamW is elementwise, so the slice's update is the
    whole update's slice); each rank updates only its slice. Before a
    forward the slices are gathered over the mp line, so the forward and
    backward (``fps_batched``, ``sa_mlp_pool``, cuDNN) run on whole
    weights, unchanged. Whether XLA also splits the compute over mp is not
    reproduced: every mp rank of a dp line computes the same forward.
  - ``dp`` splits the batch: each rank takes its rows, runs ``loss_fn``
    on them, and the gradients are ``all_reduce(SUM) / dp``. Every loss
    term is a batch mean over equal shards and CrowdNet has no
    normalisation layer, so this is the global batch's gradient up to the
    order of the sums. The metrics are the dp mean.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.models import train
from lidar_ai_recommendation_software_tpu_torch.models.crowdnet import (
    CrowdNet)
from lidar_ai_recommendation_software_tpu_torch.parallel.mesh import (
    Mesh, all_gather, psum)


def param_spec(name: str, value: torch.Tensor, mp_size: int
               ) -> Optional[int]:
    """The dimension of ``state_dict`` entry ``name`` sharded over mp, or
    None (replicated): the JAX package's rule read on the flax leaf, a
    ``kernel`` or ``mlp{i}_kernel`` of rank >= 2 whose output features
    divide by mp. Flax keeps output features last, (kh, kw, in, out) and
    (in, out); a ``Conv2d`` weight keeps them first, (out, in, kh, kw)."""
    path, is_conv = train._flax_path(name)
    dim = 0 if is_conv else value.ndim - 1
    out = value.shape[dim]
    if (value.ndim >= 2 and path[-1].endswith("kernel")
            and out % mp_size == 0 and out >= mp_size):
        return dim
    return None


@dataclasses.dataclass
class ShardedTrainState:
    """A model in sharded training: the whole weights (``model``, gathered
    after every update), this rank's slice of each parameter
    (``shards``; the whole parameter where ``dims`` is None), AdamW over
    the slices, the schedule and the update count."""

    model: CrowdNet
    shards: Dict[str, torch.Tensor]
    dims: Dict[str, Optional[int]]
    optimizer: torch.optim.AdamW
    schedule: train.Schedule
    step: int = 0


def _gather_weights(state: ShardedTrainState, mesh: Mesh) -> None:
    """The model's weights from every mp rank's slices: one all_gather of
    this rank's sharded slices, flattened together."""
    mp = mesh.shape.get("mp", 1)
    sharded = [n for n, d in state.dims.items() if d is not None]
    if mp > 1 and sharded:
        flat = torch.cat([state.shards[n].reshape(-1) for n in sharded])
        every = all_gather(flat[None], mesh, "mp")
    params = dict(state.model.named_parameters())
    offset = 0
    with torch.no_grad():
        for name, d in state.dims.items():
            s = state.shards[name]
            if d is None or mp == 1:
                params[name].copy_(s)
                continue
            k = s.numel()
            params[name].copy_(torch.cat(
                [every[j, offset:offset + k].view(s.shape)
                 for j in range(mp)], dim=d))
            offset += k


def sharded_init(cfg: train.TrainConfig, mesh: Mesh,
                 params: Optional[Dict[str, torch.Tensor]] = None
                 ) -> ShardedTrainState:
    """``train.init_state(cfg)`` on the mesh's device (the same draw on
    every rank), or the weights ``params`` (a ``state_dict``), cut into
    this rank's slices, with AdamW (optax's defaults, as ``init_state``)
    over the slices."""
    state = train.init_state(cfg, device=mesh.device)
    if params is not None:
        state.model.load_state_dict(params)
    mp, k = mesh.shape.get("mp", 1), mesh.coords.get("mp", 0)
    shards, dims = {}, {}
    for name, p in state.model.named_parameters():
        dims[name] = param_spec(name, p, mp)
        whole = p.detach()
        shards[name] = (whole if dims[name] is None
                        else whole.chunk(mp, dims[name])[k]).clone()
    opt = torch.optim.AdamW(list(shards.values()), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return ShardedTrainState(state.model, shards, dims, opt, state.schedule)


def make_sharded_train_step(cfg: train.TrainConfig, mesh: Mesh
                            ) -> Callable[[ShardedTrainState, Dict],
                                          Dict[str, torch.Tensor]]:
    """A step ``step(state, batch) -> metrics``: ``batch`` is the whole
    batch (``train.make_batch``'s dict, the same on every rank), of which
    this rank takes its dp rows. It updates ``state`` in place; after it,
    ``state.model`` holds the updated whole weights and, as ``.grad``,
    the dp-reduced gradients; the metrics are the dp mean."""
    dp, i = mesh.shape.get("dp", 1), mesh.coords.get("dp", 0)
    mp, k = mesh.shape.get("mp", 1), mesh.coords.get("mp", 0)
    if cfg.batch_size % dp:
        raise ValueError(f"batch {cfg.batch_size} does not divide by dp "
                         f"{dp}")
    rows = slice(i * cfg.batch_size // dp, (i + 1) * cfg.batch_size // dp)
    n_dp = torch.tensor(float(dp), device=mesh.device)

    def step(state: ShardedTrainState, batch: Dict) -> Dict[str,
                                                            torch.Tensor]:
        local = {key: torch.as_tensor(np.asarray(v)[rows],
                                      device=mesh.device)
                 for key, v in batch.items()}
        state.model.zero_grad(set_to_none=True)
        loss, metrics = train.loss_fn(state.model, local, cfg)
        loss.backward()
        params = dict(state.model.named_parameters())
        names = list(state.dims)
        # one all_reduce: every gradient, then the metrics
        flat = torch.cat([params[n].grad.reshape(-1) for n in names]
                         + [torch.stack([v.detach()
                                         for v in metrics.values()])])
        flat = psum(flat, mesh, "dp") / n_dp if dp > 1 else flat
        offset = 0
        for n in names:
            g = flat[offset:offset + params[n].numel()].view_as(params[n])
            offset += params[n].numel()
            params[n].grad = g.clone()
            d = state.dims[n]
            state.shards[n].grad = (g if d is None or mp == 1
                                    else g.chunk(mp, d)[k]).clone()
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
        state.step += 1
        _gather_weights(state, mesh)
        return dict(zip(metrics, flat[offset:]))

    return step


def run_sharded_steps(cfg: train.TrainConfig, mesh: Mesh,
                      n_steps: int = 1) -> Dict[str, float]:
    """Init, then ``n_steps`` steps on batches from
    ``RandomState(cfg.seed)``; the last step's metrics."""
    state = sharded_init(cfg, mesh)
    step = make_sharded_train_step(cfg, mesh)
    rng = np.random.RandomState(cfg.seed)
    metrics: Dict[str, torch.Tensor] = {}
    for _ in range(n_steps):
        metrics = step(state, train.make_batch(rng, cfg))
    return {key: float(v) for key, v in metrics.items()}
