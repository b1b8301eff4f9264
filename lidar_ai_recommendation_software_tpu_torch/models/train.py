"""What serving needs of CrowdNet's training module: the configuration a
checkpoint carries, the model it describes, the checkpoint reader, the
function that carries the JAX package's parameters across, and weights from
a numpy seed for widths that have no checkpoint.

The counterpart of the serving half of the JAX package's
``models/train.py``. The loss, ``fit``, ``evaluate`` and the train-state
checkpoints are not ported yet (ROADMAP.md, queue 1, item 10).

State shared with the JAX package: the serving checkpoint, a ``.npz`` of
float32 arrays named ``param:<flax path>`` and the ``TrainConfig`` as JSON.
``load_params_npz`` reads it into the flax tree of nested dicts (numpy
only), and ``params_from_flax`` maps that tree onto the ``state_dict`` of
the port's ``CrowdNet``:

  - ``sa*/mlp{i}_kernel`` (in, out) and ``sa*/mlp{i}_bias`` keep their
    names and shapes;
  - a flax ``Conv`` ``kernel`` (kh, kw, in, out) becomes the ``weight``
    (out, in, kh, kw) of the ``nn.Conv2d`` of the same name, and its
    ``bias`` stays.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np
import torch

from lidar_ai_recommendation_software_tpu_torch.models.crowdnet import (
    CrowdNet)

# the name flax gives the vmapped CrowdNet inside BatchedCrowdNet
BATCHED_SCOPE = "VmapCrowdNet_0"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field (a checkpoint's
    JSON names them all). Serving reads ``n_points``, ``grid``, the sample
    counts and ``bf16``."""
    batch_size: int = 4
    n_points: int = 8192
    grid: int = 64
    sa1_samples: int = 1024
    sa2_samples: int = 256
    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    lr_schedule_steps: int = 0
    density_weight: float = 1.0
    flow_weight: float = 1.0
    congestion_weight: float = 0.25
    count_weight: float = 0.1
    huber_delta: float = 0.1
    speckle_prob: float = 0.25
    seed: int = 0
    bf16: bool = False         # bf16 operands in the SA MLPs and the trunk
    remat: bool = False        # a training option; serving ignores it
    use_pallas: bool = False   # the JAX package's kernel switch; the port
    #                            always takes its kernels on a card


def make_model(cfg: TrainConfig) -> CrowdNet:
    return CrowdNet(sa1_samples=cfg.sa1_samples, sa2_samples=cfg.sa2_samples,
                    grid=cfg.grid,
                    dtype=torch.bfloat16 if cfg.bf16 else torch.float32)


def seeded_state_dict(model: CrowdNet, seed: int) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model`` from a numpy seed, for runs at widths
    no checkpoint has: normal weights scaled by 1 / sqrt(fan-in), small
    normal biases."""
    rng = np.random.RandomState(seed)
    state = {}
    for key, value in model.state_dict().items():
        shape = tuple(value.shape)
        if len(shape) == 1:
            arr = rng.randn(*shape) * 0.05
        else:  # (in, out) MLP kernels, (out, in, kh, kw) convolutions
            fan_in = shape[0] if len(shape) == 2 else int(
                np.prod(shape[1:]))
            arr = rng.randn(*shape) / np.sqrt(fan_in)
        state[key] = torch.from_numpy(arr.astype(np.float32))
    return state


def load_params_npz(path: str) -> Tuple[Dict, TrainConfig]:
    """A serving checkpoint as (flax parameter tree of numpy arrays,
    TrainConfig)."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        cfg = TrainConfig(**json.loads(str(z["config_json"])))
        for key in z.files:
            if not key.startswith("param:"):
                continue
            *scopes, leaf = key[len("param:"):].split("/")
            node = tree
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = z[key]
    return tree, cfg


def flax_leaves(tree: Dict, prefix: Tuple[str, ...] = ()
                ) -> Dict[Tuple[str, ...], np.ndarray]:
    """The leaves of a nested dict by path."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(flax_leaves(value, prefix + (name,)))
        else:
            out[prefix + (name,)] = value
    return out


def _flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """The flax path of a ``state_dict`` key, and whether the array is a
    convolution kernel (stored transposed)."""
    *scopes, leaf = key.split(".")
    if leaf == "weight":
        return (*scopes, "kernel"), True
    return (*scopes, leaf), False


def expected_flax_shapes(model: CrowdNet) -> Dict[Tuple[str, ...], tuple]:
    """Path -> shape of the flax tree that ``params_from_flax`` maps onto
    ``model``, below the batching scope."""
    out = {}
    for key, value in model.state_dict().items():
        path, is_conv = _flax_path(key)
        shape = tuple(value.shape)
        out[path] = (shape[2], shape[3], shape[1], shape[0]) if is_conv \
            else shape
    return out


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's CrowdNet parameter tree (nested dicts of arrays,
    with or without the ``BatchedCrowdNet`` scope on top) as a
    ``state_dict`` of the port's ``CrowdNet``."""
    leaves = flax_leaves(tree.get(BATCHED_SCOPE, tree))
    state = {}
    for path, value in leaves.items():
        arr = np.array(value, dtype=np.float32)  # a writable copy
        *scopes, leaf = path
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)
            leaf = "weight"
        state[".".join((*scopes, leaf))] = torch.from_numpy(
            np.ascontiguousarray(arr))
    return state
