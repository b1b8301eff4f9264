"""CrowdNet's training module: the configuration a checkpoint carries,
the model it describes, label synthesis, the loss, the training step and
loop, held-out evaluation, and the checkpoint formats.

The counterpart of the JAX package's ``models/train.py``. CrowdNet learns
the analytic pipeline's BEV targets (density, flow, congestion, the people
count) from raw points. ``fit`` draws batches from
``RandomState(cfg.seed)`` with ``make_batch`` (host numpy, bit-equal to the
JAX package's) and takes AdamW steps (``torch.optim.AdamW``; optax's
warmup-cosine schedule when ``lr_schedule_steps`` > 0). Every entry point
runs on the card unless the caller names the CPU.

State shared with the JAX package:

  - the serving checkpoint, a ``.npz`` of float32 arrays named
    ``param:<flax path>`` and the ``TrainConfig`` as JSON.
    ``load_params_npz`` reads it into the flax tree of nested dicts (numpy
    only) and ``params_from_flax`` maps that tree onto the ``state_dict``
    of the port's ``CrowdNet``; ``flax_from_params`` and
    ``save_params_npz`` go back:

      - ``sa*/mlp{i}_kernel`` (in, out) and ``sa*/mlp{i}_bias`` keep their
        names and shapes;
      - a flax ``Conv`` ``kernel`` (kh, kw, in, out) becomes the ``weight``
        (out, in, kh, kw) of the ``nn.Conv2d`` of the same name, and its
        ``bias`` stays;

  - the optimizer: ``opt_state_from_optax`` carries optax's AdamW moments
    and update count into ``torch.optim.AdamW``'s state.

The train-state checkpoint (``save_checkpoint``, ``restore_checkpoint``) is
the port's own ``torch.save`` file (model, optimizer, schedule, step and
the config JSON); Orbax is the JAX package's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Dict, Optional, Tuple

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
    remat: bool = False        # recompute the SA layers in the backward
    use_pallas: bool = False   # the JAX package's kernel switch; the port
    #                            always takes its kernels on a card


def make_model(cfg: TrainConfig,
               generator: Optional[torch.Generator] = None) -> CrowdNet:
    """CrowdNet at ``cfg``'s widths on the CPU, initialised from
    ``generator`` (``CrowdNet.init_weights``)."""
    return CrowdNet(sa1_samples=cfg.sa1_samples, sa2_samples=cfg.sa2_samples,
                    grid=cfg.grid,
                    dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
                    remat=cfg.remat, generator=generator)


def _device(device, what: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}(device='cuda') needs a CUDA device and none is "
            f"available; pass device='cpu' to run on the CPU")
    return dev


# -- labels -------------------------------------------------------------------

def synth_example(rng: np.random.RandomState, cfg: TrainConfig):
    """One venue + its analytic BEV labels (host side).

    People carry realistic LiDAR return blobs (~12-40 points in a 0.3 m
    disc with z up to 1.8 m, like synthetic.venue_sequence frames) over a
    terrain of ground returns — the reference's density fixture leaves
    ~1-3 samples per person, below any detector's information floor
    (including the analytic pipeline's own min_samples=5).

    Density label: people-count histogram per BEV cell / cell area, from
    the true generator person centres (the analytic pipeline's estimand).
    Flow label: the deterministic exit+swirl+damping field evaluated at
    cell centres (crowd_flow_model.py:107-175 semantics). Congestion:
    density/(speed+0.1) normalised (visualization.py:322-326)."""
    n = cfg.n_points
    extent = float(rng.uniform(10.0, 20.0))
    n_people = int(rng.randint(20, 80))
    # Two discrete return-rate regimes, each internally fixed (a
    # continuously varying per-venue rate would make per-cell counts
    # ambiguous by that factor): the realistic ~24-return blob, and —
    # with cfg.speckle_prob — the reference fixture's speckle regime.
    # Discrete far-apart rates stay locally identifiable (blob vs
    # isolated elevated returns), unlike a continuum.
    per_person = 24
    if cfg.speckle_prob > 0 and rng.uniform() < cfg.speckle_prob:
        per_person = int(rng.randint(1, 5))
    centers = rng.uniform(-extent * 0.66, extent * 0.66, (n_people, 2))

    n_person_pts = min(n_people * per_person, (3 * n) // 4)
    which = rng.randint(0, n_people, n_person_pts)
    radii = 0.3 * np.sqrt(rng.uniform(0, 1, n_person_pts))
    theta = rng.uniform(0, 2 * np.pi, n_person_pts)
    pxy = centers[which] + np.stack(
        [radii * np.cos(theta), radii * np.sin(theta)], axis=1)
    pz = rng.uniform(0.1, 1.8, n_person_pts)

    n_bg = n - n_person_pts
    bx = rng.uniform(-extent, extent, n_bg)
    by = rng.uniform(-extent, extent, n_bg)
    bz = 0.1 * np.sin(bx * 0.5) * np.cos(by * 0.5)

    pts = np.concatenate(
        [np.column_stack([pxy, pz]),
         np.column_stack([bx, by, bz])], axis=0)
    pts = pts[rng.permutation(n)].astype(np.float32)

    g = cfg.grid
    vmin = pts[:, :2].min(axis=0)
    vmax = pts[:, :2].max(axis=0)
    vsize = float(max(vmax[0] - vmin[0], vmax[1] - vmin[1])) + 1e-6
    cell_area = (vsize / g) ** 2

    ci = np.clip(((centers - vmin) / vsize * g).astype(int), 0, g - 1)
    density = np.zeros((g, g), np.float32)
    np.add.at(density, (ci[:, 0], ci[:, 1]), 1.0)
    density /= cell_area

    # flow field at cell centres
    xcen = vmin[0] + (np.arange(g) + 0.5) * vsize / g
    yc = vmin[1] + (np.arange(g) + 0.5) * vsize / g
    X, Y = np.meshgrid(xcen, yc, indexing="ij")
    exit_x, exit_y = vmax[0], (vmin[1] + vmax[1]) / 2
    dx, dy = exit_x - X, exit_y - Y
    dist = np.sqrt(dx * dx + dy * dy) + 1e-9
    ux, uy = dx / dist, dy / dist
    ang = np.sin(X * 0.3) * np.cos(Y * 0.3) * 0.5
    vx = ux * np.cos(ang) - uy * np.sin(ang)
    vy = ux * np.sin(ang) + uy * np.cos(ang)
    r3 = np.random.RandomState(42)
    for _ in range(3):
        bx = vmin[0] + 1 + r3.uniform() * (vmax[0] - vmin[0] - 2)
        by = vmin[1] + 1 + r3.uniform() * (vmax[1] - vmin[1] - 2)
        d = np.sqrt((X - bx) ** 2 + (Y - by) ** 2)
        damp = np.where(d < 3.0, d / 3.0, 1.0)
        vx *= damp
        vy *= damp
    mag = np.sqrt(vx * vx + vy * vy)
    scale = 1.3 / mag.max() if mag.max() > 0 else 1.0
    vx, vy = vx * scale, vy * scale
    mag = np.sqrt(vx * vx + vy * vy)
    flow = np.stack([vx, vy], axis=-1).astype(np.float32)

    congestion = density / (mag + 0.1)
    cmax = congestion.max()
    congestion = (congestion / cmax if cmax > 0
                  else congestion).astype(np.float32)

    return {
        "points": pts.astype(np.float32),
        "mask": np.ones(n, bool),
        "venue_min": vmin.astype(np.float32),
        "venue_size": np.float32(vsize),
        "density": density,
        "flow": flow,
        "congestion": congestion,
    }


def make_batch(rng: np.random.RandomState, cfg: TrainConfig) -> Dict:
    exs = [synth_example(rng, cfg) for _ in range(cfg.batch_size)]
    return {k: np.stack([e[k] for e in exs]) for k in exs[0]}


def batch_tensors(batch: Dict[str, np.ndarray], device
                  ) -> Dict[str, torch.Tensor]:
    """A ``make_batch`` batch as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# -- loss and step -------------------------------------------------------------

def _huber(pred: torch.Tensor, target: torch.Tensor, delta: float
           ) -> torch.Tensor:
    """optax's ``huber_loss``: 0.5 q^2 + delta (|e| - q) with q =
    min(|e|, delta); ``minimum`` halves the gradient at |e| = delta, as
    ``jnp.minimum`` does."""
    abs_err = (pred - target).abs()
    quadratic = torch.minimum(abs_err, abs_err.new_tensor(delta))
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


def loss_fn(model: CrowdNet, batch: Dict[str, torch.Tensor],
            cfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Huber on density (``cfg.huber_delta``), MSE on flow, clipped BCE on
    congestion and the people count's relative error, weighted by ``cfg``:
    (loss, {"loss", "density_mae", "flow_mse", "count_rel_err"})."""
    out = model(batch["points"], batch["mask"], batch["venue_min"],
                batch["venue_size"])
    d_err = _huber(out["density"], batch["density"], cfg.huber_delta).mean()
    f_err = ((out["flow"] - batch["flow"]) ** 2).mean()
    eps = 1e-6
    cong = out["congestion"]
    # min(max(.)) as jnp.clip, which halves the gradient at either end
    c = torch.minimum(torch.maximum(cong, cong.new_tensor(eps)),
                      cong.new_tensor(1 - eps))
    t = batch["congestion"]
    c_err = -(t * torch.log(c) + (1 - t) * torch.log(1 - c)).mean()
    vsize = batch["venue_size"]
    # divides by a device tensor: CUDA multiplies by a Python number's
    # reciprocal, which rounds differently
    cell_area = (vsize / vsize.new_tensor(float(cfg.grid))) ** 2
    true_n = batch["density"].sum((1, 2)) * cell_area
    n_err = ((out["count"] - true_n).abs() / true_n.clamp_min(1.0)).mean()
    loss = (cfg.density_weight * d_err + cfg.flow_weight * f_err
            + cfg.congestion_weight * c_err + cfg.count_weight * n_err)
    metrics = {"loss": loss,
               "density_mae": (out["density"] - batch["density"]).abs()
               .mean(),
               "flow_mse": f_err, "count_rel_err": n_err}
    return loss, metrics


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The learning rate of an update, from the count of updates before it
    (optax reads its schedule before it counts the update). With
    ``decay_steps`` > 0, optax's ``warmup_cosine_decay_schedule(0, peak,
    warmup_steps, decay_steps)``, which gives 0 to the first update; else
    ``peak`` throughout."""

    peak: float
    warmup_steps: int = 0
    decay_steps: int = 0

    @classmethod
    def of(cls, cfg: TrainConfig) -> "Schedule":
        if cfg.lr_schedule_steps <= 0:
            return cls(cfg.learning_rate)
        return cls(cfg.learning_rate, max(1, cfg.lr_schedule_steps // 20),
                   cfg.lr_schedule_steps)

    def __call__(self, count: int) -> float:
        if self.decay_steps <= 0:
            return self.peak
        if count < self.warmup_steps:
            return self.peak * count / self.warmup_steps
        span = self.decay_steps - self.warmup_steps
        t = min(count - self.warmup_steps, span)
        return self.peak * 0.5 * (1.0 + math.cos(math.pi * t / span))


@dataclasses.dataclass
class TrainState:
    """A model in training: its AdamW optimizer (over
    ``model.parameters()``), the learning-rate schedule and the number of
    updates taken."""

    model: CrowdNet
    optimizer: torch.optim.AdamW
    schedule: Schedule
    step: int = 0


def init_state(cfg: TrainConfig, seed: Optional[int] = None,
               device: torch.device | str = "cuda") -> TrainState:
    """A fresh model drawn from ``torch.Generator`` seed ``seed``
    (``cfg.seed`` by default) on ``device``; AdamW with optax's defaults
    (betas 0.9 and 0.999, eps 1e-8) and ``cfg.weight_decay`` on every
    parameter, as ``optax.adamw``."""
    dev = _device(device, "init_state")
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    model = make_model(cfg, gen).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=cfg.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    return TrainState(model, opt, Schedule.of(cfg))


def step_loss(state: TrainState, batch: Dict[str, torch.Tensor],
              cfg: TrainConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The forward of a training step: clears the gradients of ``state``
    and returns the loss on ``batch`` and its metrics, on the device."""
    state.optimizer.zero_grad(set_to_none=True)
    return loss_fn(state.model, batch, cfg)


def apply_update(state: TrainState) -> None:
    """The AdamW update of a training step from the gradients in place,
    at the schedule's rate for the step count before it."""
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """One AdamW update of ``state``, in place, on ``batch`` (tensors on
    the model's device); returns the metrics of the loss before the
    update, on the device."""
    loss, metrics = step_loss(state, batch, cfg)
    loss.backward()
    apply_update(state)
    return {k: v.detach() for k, v in metrics.items()}


def fit(cfg: TrainConfig, steps: int, state: Optional[TrainState] = None,
        log_every: int = 10, device: torch.device | str = "cuda"
        ) -> Tuple[TrainState, Dict[str, float]]:
    """``steps`` updates of ``state`` (on its model's device) or of a fresh
    ``init_state`` on ``device``, on batches drawn from
    ``RandomState(cfg.seed)``. As the JAX package's ``fit``, the batch
    stream starts again from its first batch on every call, a resumed
    state's too. Returns the state and the last step's metrics."""
    rng = np.random.RandomState(cfg.seed)
    state = state or init_state(cfg, device=device)
    dev = next(state.model.parameters()).device
    metrics: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        metrics = train_step(state, batch_tensors(make_batch(rng, cfg), dev),
                             cfg)
        if log_every and (i + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i + 1}: {m}")
    return state, {k: float(v) for k, v in metrics.items()}


# -- evaluation ----------------------------------------------------------------

def evaluate(params: Dict[str, torch.Tensor], cfg: TrainConfig,
             n_venues: int = 8, seed: int = 10_000,
             device: torch.device | str = "cuda") -> Dict[str, float]:
    """Held-out metrics of the model with ``params`` (a ``state_dict``):
    density MAE and flow MSE against the analytic labels on venues the
    training stream never saw (``RandomState(seed)``, disjoint from
    ``fit``'s draws), the zero predictor's density MAE as the no-skill
    floor, and the people count's relative error."""
    dev = _device(device, "evaluate")
    model = make_model(cfg)
    model.load_state_dict(params)
    model.to(dev).eval()
    rng = np.random.RandomState(seed)
    maes, fmses, zeros, people_err = [], [], [], []
    for _ in range(n_venues):
        ex = make_batch(rng, cfg)
        with torch.no_grad():
            out = model(*(torch.as_tensor(ex[k], device=dev) for k in
                          ("points", "mask", "venue_min", "venue_size")))
        pred = out["density"].cpu().numpy()
        maes.append(np.abs(pred - ex["density"]).mean())
        zeros.append(np.abs(ex["density"]).mean())
        fmses.append(np.square(out["flow"].cpu().numpy() - ex["flow"]).mean())
        cell_area = (ex["venue_size"] / cfg.grid) ** 2
        true_n = ex["density"].sum(axis=(1, 2)) * cell_area
        people_err.append(np.abs(out["count"].cpu().numpy() - true_n)
                          / np.maximum(true_n, 1.0))
    return {"density_mae": float(np.mean(maes)),
            "density_mae_zero": float(np.mean(zeros)),
            "flow_mse": float(np.mean(fmses)),
            "people_rel_err": float(np.mean(people_err))}


# -- checkpoints ---------------------------------------------------------------

def save_checkpoint(path: str, state: TrainState, cfg: TrainConfig) -> None:
    """The train state as one ``torch.save`` file: the model's and the
    optimizer's ``state_dict``, the schedule, the step and ``cfg`` as
    JSON."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "schedule": dataclasses.asdict(state.schedule),
                "step": state.step,
                "config_json": json.dumps(dataclasses.asdict(cfg))}, path)


def restore_checkpoint(path: str, cfg: TrainConfig,
                       device: torch.device | str = "cuda") -> TrainState:
    """The train state ``save_checkpoint`` wrote, on ``device``; raises
    ValueError if it was saved under another configuration."""
    dev = _device(device, "restore_checkpoint")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if json.loads(saved["config_json"]) != dataclasses.asdict(cfg):
        raise ValueError(f"checkpoint {path!r} was saved under another "
                         f"TrainConfig: {saved['config_json']}")
    state = init_state(cfg, device=dev)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    return dataclasses.replace(state, schedule=Schedule(**saved["schedule"]),
                               step=saved["step"])


def opt_state_from_optax(state: TrainState, mu: Dict, nu: Dict,
                         count: int) -> Dict:
    """optax's AdamW state carried across: the first and second moments
    ``mu`` and ``nu`` (parameter trees of the JAX package's CrowdNet, as
    ``params_from_flax`` reads them) and the update count, as a
    ``state_dict`` for ``state.optimizer``. Load it and set ``state.step``
    to ``count``."""
    m, v = params_from_flax(mu), params_from_flax(nu)
    sd = state.optimizer.state_dict()
    names = [name for name, _ in state.model.named_parameters()]
    sd["state"] = {i: {"step": torch.tensor(float(count)),
                       "exp_avg": m[name], "exp_avg_sq": v[name]}
                   for i, name in zip(sd["param_groups"][0]["params"], names)}
    return sd


def weights_digest(params: Dict[str, torch.Tensor]) -> str:
    """SHA-256 of a ``state_dict``'s float32 bytes in key order: two runs
    started from the same weights print the same digest."""
    h = hashlib.sha256()
    for value in params.values():
        h.update(value.detach().to("cpu", torch.float32).numpy().tobytes())
    return h.hexdigest()


def flax_from_params(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_flax``: a ``state_dict`` as the JAX
    package's parameter tree of float32 numpy arrays under the
    ``BatchedCrowdNet`` scope, convolution kernels as (kh, kw, in, out)."""
    tree: Dict = {}
    for key, value in params.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        path, is_conv = _flax_path(key)
        node = tree.setdefault(BATCHED_SCOPE, {})
        for scope in path[:-1]:
            node = node.setdefault(scope, {})
        node[path[-1]] = np.ascontiguousarray(
            arr.transpose(2, 3, 1, 0) if is_conv else arr)
    return tree


def save_params_npz(path: str, params: Dict[str, torch.Tensor],
                    cfg: TrainConfig) -> None:
    """The serving checkpoint of a ``state_dict`` in the JAX package's
    format (``param:VmapCrowdNet_0/...`` arrays and the config JSON), which
    ``load_params_npz`` reads here and there."""
    flat = {"param:" + "/".join(p): v
            for p, v in flax_leaves(flax_from_params(params)).items()}
    flat["config_json"] = np.asarray(json.dumps(dataclasses.asdict(cfg)))
    np.savez_compressed(path, **flat)


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
