"""Device meshes over ``torch.distributed`` ranks, the exchanges the
sharded modules use, and a launcher that spawns the ranks.

The counterpart of the JAX package's ``parallel/mesh.py``. There a mesh
lays the devices of one program out on named axes and XLA compiles the
collectives. Here every rank is a process with one device; a ``Mesh``
names this rank's coordinate on each axis and holds one process group
for each line of each axis (the ranks whose coordinates differ on that
axis alone). The collectives of an axis run over this rank's line:
``ppermute``, ``psum``, ``pmax`` and ``all_gather`` below, the
counterparts of ``jax.lax``'s.

The communication device: gloo moves CPU tensors (it takes CUDA tensors
for ``broadcast`` and ``all_reduce`` only), NCCL CUDA tensors. A tensor on
another device is staged to the group's communication device and back;
``Mesh.stats`` counts the exchanges and their seconds, the staging apart.
Only gloo is checked: NCCL refuses two ranks on one card, and the card's
machine has one. The groups are made with the backend of the default
group, never by ``init_device_mesh("cuda", ...)``, which picks NCCL.

Ranks are processes started by ``spawn`` (``torch.multiprocessing``,
start method spawn): ``_rank_main`` joins the process group and calls the
rank function, which must be importable without the caller's modules.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


# a collective that waits longer than this raises (a rank that died)
EXCHANGE_TIMEOUT_S = 600.0


def initialize_distributed(backend: str = "gloo",
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None) -> None:
    """Join the default process group (``init_method`` "env://" when not
    given: MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)."""
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=EXCHANGE_TIMEOUT_S))


def _rank_device(device: torch.device | str) -> torch.device:
    """The device of this rank: the CPU when asked for by name, else the
    card ``rank % device_count`` (every rank on the one card of a one-card
    machine). Raises when there is no card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on device='cuda' needs a CUDA device and "
                           "none is available; pass device='cpu' to run on "
                           "the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


@dataclasses.dataclass
class ExchangeStats:
    """What this rank's exchanges cost: the calls, the seconds in them,
    and of those the seconds and bytes of the copies between the device
    and the communication device."""

    calls: int = 0
    seconds: float = 0.0
    staging_seconds: float = 0.0
    staged_bytes: int = 0


@dataclasses.dataclass
class Mesh:
    """This rank's place in a mesh of ``torch.distributed`` ranks laid out
    row-major on the axes of ``shape``, in order (as ``jax.sharding.Mesh``
    lays out its devices): its coordinate on each axis and the group of
    its line."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]
    device: torch.device
    comm_device: torch.device
    stats: ExchangeStats = dataclasses.field(default_factory=ExchangeStats)


def make_mesh(axes: Sequence[Tuple[str, int]] = (("dp", -1),),
              device: torch.device | str = "cuda") -> Mesh:
    """A mesh of every rank of the default group from (name, size) axes;
    one size may be -1 (inferred). The sizes must multiply to the world
    size. Every rank calls ``new_group`` for every line of every axis, in
    the same order, lines it is not in included, as ``torch.distributed``
    requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    names = tuple(n for n, _ in axes)
    sizes = [s for _, s in axes]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} wants "
                         f"{int(np.prod(sizes))} ranks, the world has {world}")
    grid = np.arange(world).reshape(sizes)
    coords = {n: int(c) for n, c in zip(names, np.unravel_index(rank, sizes))}
    backend = dist.get_backend()
    groups = {}
    for a, name in enumerate(names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, sizes[a]):
            ranks = [int(r) for r in line]
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[name] = group
    dev = _rank_device(device)
    comm = torch.device("cpu") if backend == "gloo" else dev
    return Mesh(dict(zip(names, sizes)), coords, groups, dev, comm)


def train_mesh(device: torch.device | str = "cuda") -> Mesh:
    """The training mesh over every rank: mp = 2 when the rank count is
    even, else pure dp (the JAX package's ``train_mesh``)."""
    n = dist.get_world_size()
    mp = 2 if n % 2 == 0 and n >= 2 else 1
    return make_mesh((("dp", n // mp), ("mp", mp)), device)


def spatial_mesh(device: torch.device | str = "cuda") -> Mesh:
    """A 1-D ``sp`` mesh over every rank, for venue-sharded analytics."""
    return make_mesh((("sp", dist.get_world_size()),), device)


# ---------------------------------------------------------------------------
# exchanges along one axis
# ---------------------------------------------------------------------------

def _to_comm(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if x.device == mesh.comm_device:
        return x.contiguous()
    if x.device.type == "cuda":
        # the copy to the host waits for the stream anyway: this moves
        # the wait out of the timed copy
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    y = x.to(mesh.comm_device).contiguous()
    mesh.stats.staging_seconds += time.perf_counter() - t0
    mesh.stats.staged_bytes += y.numel() * y.element_size()
    return y


def _from_comm(y: torch.Tensor, device: torch.device,
               mesh: Mesh) -> torch.Tensor:
    if y.device == device:
        return y
    # a blocking copy: it returns with the data on the device
    t0 = time.perf_counter()
    x = y.to(device)
    mesh.stats.staging_seconds += time.perf_counter() - t0
    mesh.stats.staged_bytes += y.numel() * y.element_size()
    return x


class _Timed:
    def __init__(self, mesh: Mesh):
        self.stats = mesh.stats

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.stats.calls += 1
        self.stats.seconds += time.perf_counter() - self.t0


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: along ``axis``, the rank at coordinate ``src``
    sends ``x`` to the rank at ``dst`` for each pair of ``perm``; returns
    what this rank received, zeros where no pair sends to it."""
    n, me = mesh.shape[axis], mesh.coords[axis]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if (len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts)
            or not all(0 <= r < n for r in srcs + dsts)):
        raise ValueError(f"{perm} is not a permutation of {n} coordinates")
    if x.dtype == torch.bool:
        return ppermute(x.to(torch.uint8), mesh, axis, perm).to(torch.bool)
    group = mesh.groups[axis]
    with _Timed(mesh):
        send = _to_comm(x, mesh)
        got = torch.zeros_like(send)
        ops = []
        for src, dst in perm:
            if src == me:
                ops.append(dist.P2POp(dist.isend, send,
                                      dist.get_global_rank(group, dst),
                                      group))
            if dst == me:
                ops.append(dist.P2POp(dist.irecv, got,
                                      dist.get_global_rank(group, src),
                                      group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _from_comm(got, x.device, mesh)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str,
                op: dist.ReduceOp) -> torch.Tensor:
    with _Timed(mesh):
        y = _to_comm(x, mesh).clone()
        dist.all_reduce(y, op=op, group=mesh.groups[axis])
        return _from_comm(y, x.device, mesh)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum``: the sum of ``x`` over ``axis``, on every rank."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.pmax``: the largest ``x`` over ``axis``, on every rank."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather(..., tiled=True)``: every rank's ``x`` along
    ``axis``, concatenated along the first dimension in coordinate
    order."""
    with _Timed(mesh):
        y = _to_comm(x, mesh)
        parts = [torch.empty_like(y) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, y, group=mesh.groups[axis])
        return _from_comm(torch.cat(parts), x.device, mesh)


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

def _free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               args: tuple) -> None:
    """A rank's entry: the host's cores split between the ranks, the
    default group joined over gloo, ``fn(rank, *args)``, the group
    left."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    initialize_distributed("gloo", init_method, world_size, rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args) -> None:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes joined in
    one gloo process group on ``tcp://127.0.0.1``; returns when all have
    ended. ``fn`` and ``args`` are pickled, so ``fn`` must be a module's
    top-level function. A rank that raises ends the others, and the
    error is raised here."""
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    torch.multiprocessing.spawn(
        _rank_main, args=(fn, world_size, init_method, args),
        nprocs=world_size, join=True)
