"""The two kernels of the set-abstraction layer: farthest-point sampling
and the fused shared MLP with its masked max-pool. Wrappers and plain
PyTorch versions.

The counterparts of the JAX package's ``ops/pallas/kernels.py``: ``fps``
(``_fps_single``, ``_fps_batched``) and ``sa_mlp_pool``. The kernels are
``csrc/fps.cu`` (three bodies, picked per cloud size by ``fps_plan``) and
``csrc/sa_mlp_pool.cu``. ``sa_mlp_pool_trainable`` puts the pool under
autograd: the kernel forward, a backward through its differentiable
plain version ``sa_mlp_pool_reference`` (no backward kernel: the JAX
package's backward is plain jnp too).

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); each launch adds one to ``LAUNCHES``
(``fps_single``, ``fps_batched``, ``sa_mlp_pool``), and each ``fps``
launch one to ``FPS_ROUTES`` under the route it took.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    FPS_ROUTES, LAUNCHES, SMEM_PER_BLOCK, _check, _cuda_device, _raise_on,
    _stream, load_library)

_BIG = 3.4e38  # the distance cache starts here; masked points rank at -_BIG

# The layout of csrc/fps.cu, which the plan mirrors (the kernel's entry
# point refuses a plan that gives a block less shared memory than it uses):
BLOCK_THREADS = 1024            # the shared-memory and cluster bodies
BLOCK_STATIC_BYTES = 512        # the one-block body's warp results
BLOCK_SMEM_BUDGET = SMEM_PER_BLOCK - BLOCK_STATIC_BYTES
CLUSTER_HEADER_BYTES = 832      # candidate buffers and warp results
BYTES_PER_POINT = 17            # x, y, z, the distance cache, the mask
PORTABLE_CLUSTER = 8            # the largest cluster every sm_90 card runs
POINTS_PER_BLOCK = (SMEM_PER_BLOCK - CLUSTER_HEADER_BYTES) // BYTES_PER_POINT
# the register body's instantiations, (threads, points a thread), smallest
# first, and the bytes a point of its shared copy of the cloud takes
REGISTER_SHAPES = ((32, 16), (128, 16), (256, 16), (512, 16))
REGISTER_COPY_BYTES = 12


# ---------------------------------------------------------------------------
# fps
# ---------------------------------------------------------------------------

def fps_reference(points: torch.Tensor, mask: torch.Tensor, n_samples: int,
                  start_index: int = 0) -> torch.Tensor:
    """Plain version of ``fps``, single ((N, D), (N,)) or batched
    ((B, N, D), (B, N)): the distance-cache formulation, one Python step
    per sample. The squared distance is summed axis by axis,
    ``(dx*dx + dy*dy) + dz*dz``, each operation rounded on its own, and the
    argmax takes the lowest index among equal values, so the indices are
    those of the kernel and of the JAX package bit for bit."""
    single = points.ndim == 2
    p = points[None] if single else points
    m = mask[None] if single else mask
    b, n, d = p.shape
    dev = p.device
    rows = torch.arange(b, device=dev)
    cols = torch.arange(n, device=dev)
    dist = torch.full((b, n), _BIG, dtype=p.dtype, device=dev)
    out = torch.empty((b, n_samples), dtype=torch.int32, device=dev)
    last = torch.full((b,), start_index, dtype=torch.int64, device=dev)
    out[:, 0] = start_index
    for s in range(1, n_samples):
        lp = p[rows, last]                                    # (B, D)
        diff = p[..., 0] - lp[:, None, 0]
        d2 = diff * diff
        for a in range(1, d):
            diff = p[..., a] - lp[:, None, a]
            d2 = d2 + diff * diff
        dist = torch.minimum(dist, d2)
        ranked = torch.where(m, dist, -_BIG)
        top = ranked.amax(1, keepdim=True)
        last = torch.where(ranked == top, cols, n).amin(1)   # first index
        out[:, s] = last
    return out[0] if single else out


@dataclasses.dataclass(frozen=True)
class FpsPlan:
    """How ``csrc/fps.cu`` samples a cloud of ``n`` points.

    route: ``"registers"``, one block of ``threads`` threads, each holding
    ``per_thread`` points in registers; ``"block"``, one block of 1,024
    threads with the cloud in its shared memory; ``"cluster"``, a
    thread-block cluster of ``cluster`` blocks, block r holding points
    [r * per_block, (r + 1) * per_block) in its shared memory;
    ``"stream"``, one block reading the coordinates through L2 every step.
    ``smem_bytes`` of dynamic shared memory a block, ``scratch`` floats of
    device memory a cloud (the stream route's distance cache);
    ``per_thread`` is 0 but on the register route."""

    route: str
    cluster: int
    per_block: int
    smem_bytes: int
    scratch: int
    threads: int = BLOCK_THREADS
    per_thread: int = 0


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def fps_plan(n: int) -> FpsPlan:
    """The launch plan for a cloud of ``n`` points, by size alone: the
    smallest register instantiation that holds it (up to 512 x 16 = 8,192
    points, the largest cloud of a CrowdNet forward), then one block with
    the cloud in its shared memory (up to 13,643; no workload of the port
    sends such clouds yet), then the smallest cluster of at most 8 blocks,
    the portable size, that holds it (2 to 8 blocks of up to 13,624 points,
    up to 108,992), then one block streaming from L2 with its distance
    cache in device scratch."""
    for threads, per_thread in REGISTER_SHAPES:
        if n <= threads * per_thread:
            return FpsPlan("registers", 1, n,
                           _round16(n * REGISTER_COPY_BYTES), 0, threads,
                           per_thread)
    if n * BYTES_PER_POINT <= BLOCK_SMEM_BUDGET:
        return FpsPlan("block", 1, n, _round16(n * BYTES_PER_POINT), 0)
    cl = -(-n // POINTS_PER_BLOCK)
    if cl <= PORTABLE_CLUSTER:
        per = -(-n // cl)
        return FpsPlan("cluster", cl, per,
                       CLUSTER_HEADER_BYTES + BYTES_PER_POINT * per, 0)
    return FpsPlan("stream", 1, n, 0, n)


@functools.lru_cache(maxsize=None)
def max_active_clusters(plan: FpsPlan) -> int:
    """How many clusters of ``plan`` the card can hold at once
    (``cudaOccupancyMaxActiveClusters``); raises if it cannot place one."""
    got = load_library().fps_max_active_clusters(
        plan.cluster, plan.per_block, plan.smem_bytes)
    if got < 0:
        _raise_on(-got, "fps_max_active_clusters")
    if got == 0:
        raise RuntimeError(
            f"the card cannot place a cluster of {plan.cluster} blocks with "
            f"{plan.smem_bytes} bytes of shared memory each")
    return got


def _fps_launch(name: str, points: torch.Tensor, mask: torch.Tensor,
                n_samples: int, start_index: int) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on (B, N, 3) float32 points and a (B, N) bool
    mask by ``fps_plan(N)``; returns (B, n_samples) int32. A launch the
    card refuses raises; no other route is tried."""
    dev = _cuda_device(points, name)
    b, n = points.shape[0], points.shape[1]
    _check("points", points, torch.float32, (b, n, 3), dev)
    _check("mask", mask, torch.bool, (b, n), dev)
    if not 0 <= start_index < n:
        raise ValueError(f"start_index {start_index} outside [0, {n})")
    plan = fps_plan(n)
    lib = load_library()
    with torch.cuda.device(dev):
        if plan.route == "cluster":
            max_active_clusters(plan)
        out = torch.empty((b, n_samples), dtype=torch.int32, device=dev)
        scratch = torch.empty((b, plan.scratch), dtype=torch.float32,
                              device=dev) if plan.scratch else None
        err = lib.fps_launch(points.data_ptr(), mask.data_ptr(),
                             scratch.data_ptr() if plan.scratch else None,
                             b, n, n_samples, start_index,
                             plan.cluster if plan.route == "cluster" else 0,
                             plan.per_block, plan.smem_bytes, plan.threads,
                             plan.per_thread, out.data_ptr(), _stream(dev))
        LAUNCHES[name] += 1
        FPS_ROUTES[plan.route] += 1
    _raise_on(err, name)
    return out


def fps_single(points: torch.Tensor, mask: torch.Tensor, n_samples: int,
               start_index: int = 0) -> torch.Tensor:
    """Farthest-point sampling of one cloud: points (N, 3) float32, mask
    (N,) bool -> (n_samples,) int32. ``out[0]`` is ``start_index``; masked
    points are never chosen afterwards; with fewer valid points than samples
    the indices repeat."""
    if points.device.type == "cpu":
        return fps_reference(points, mask, n_samples, start_index)
    if points.ndim != 2:
        raise ValueError(f"fps_single takes (N, 3) points, got "
                         f"{tuple(points.shape)}")
    return _fps_launch("fps_single", points[None], mask[None], n_samples,
                       start_index)[0]


def fps_batched(points: torch.Tensor, mask: torch.Tensor, n_samples: int,
                start_index: int = 0) -> torch.Tensor:
    """Farthest-point sampling of B clouds, each as ``fps_single`` samples
    it: points (B, N, 3), mask (B, N) -> (B, n_samples) int32."""
    if points.device.type == "cpu":
        return fps_reference(points, mask, n_samples, start_index)
    if points.ndim != 3:
        raise ValueError(f"fps_batched takes (B, N, 3) points, got "
                         f"{tuple(points.shape)}")
    return _fps_launch("fps_batched", points, mask, n_samples, start_index)


def fps(points: torch.Tensor, mask: torch.Tensor, n_samples: int,
        start_index: int = 0) -> torch.Tensor:
    """``fps_batched`` for (B, N, 3) points, ``fps_single`` for (N, 3)."""
    if points.ndim == 3:
        return fps_batched(points, mask, n_samples, start_index)
    return fps_single(points, mask, n_samples, start_index)


# ---------------------------------------------------------------------------
# sa_mlp_pool
# ---------------------------------------------------------------------------

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]

# The layout of csrc/sa_mlp_pool.cu, which the plan mirrors (the kernel's
# entry point derives the same plan from the shapes and refuses what it
# refuses):
SA_THREADS = 256
SA_PIECE = 32                   # rows of a warp item's piece, one a lane
SA_MAX_ROWS = 128               # rows of a tile, and the largest K
SA_SPLIT_BLOCKS = 1056          # past this many 32-row tiles, wide tiles
SA_WIDE_ROWS = 2                # pieces a warp item takes in a wide tile


@dataclasses.dataclass(frozen=True)
class SaPlan:
    """How ``csrc/sa_mlp_pool.cu`` covers M centroids: ``tile`` centroids
    a block, ``blocks`` blocks of ``SA_THREADS`` threads, a warp item of
    ``pieces`` 32-row pieces by 8 output columns, and ``smem_bytes`` of
    shared memory a block (the weights, the biases, the tile's rows, where
    layer 2 later writes, and layer 1's output)."""

    tile: int
    blocks: int
    pieces: int
    smem_bytes: int


def _up4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)
def sa_plan(m: int, k: int, cin: int, h1: int, h2: int, cout: int
            ) -> SaPlan:
    """The launch plan of ``sa_mlp_pool`` for (M, K, Cin) rows and widths
    H1, H2, Cout: tiles of 32 rows (one centroid at K >= 32) and warp items
    of one piece; when that gives ``SA_SPLIT_BLOCKS`` blocks or more, tiles
    of up to ``SA_MAX_ROWS`` rows and items of ``SA_WIDE_ROWS`` pieces.
    Raises ValueError where the kernel refuses: K outside [1, 128], a width
    that is not a positive multiple of 8 (or Cin < 1), or a layout past a
    block's shared memory."""
    if not 1 <= k <= SA_MAX_ROWS or cin < 1 or any(
            h < 1 or h % 8 for h in (h1, h2, cout)):
        raise ValueError(f"sa_mlp_pool kernel takes K <= {SA_MAX_ROWS} and "
                         f"widths that are multiples of 8, got K = {k}, "
                         f"Cin = {cin}, widths {[h1, h2, cout]}")
    tile, pieces = (1 if k >= SA_PIECE else SA_PIECE // k), 1
    if -(-m // tile) >= SA_SPLIT_BLOCKS:
        tile, pieces = max(1, SA_MAX_ROWS // k), SA_WIDE_ROWS
    rows = tile * k
    floats = (_up4(cin * h1) + _up4(h1 * h2) + _up4(h2 * cout) + _up4(h1)
              + _up4(h2) + _up4(cout) + _up4(rows * max(cin, h2 | 1))
              + _up4(rows * (h1 | 1)))
    if 4 * floats > SMEM_PER_BLOCK:
        raise ValueError(f"sa_mlp_pool: a tile of {rows} rows at widths "
                         f"{[cin, h1, h2, cout]} needs {4 * floats} bytes "
                         f"of shared memory, past the {SMEM_PER_BLOCK} a "
                         f"block may use")
    return SaPlan(tile, -(-m // tile), pieces, 4 * floats)


def _operand(x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the products see it: rounded to ``compute_dtype`` (to
    nearest even) and widened again, so that the products and sums stay in
    float32 on every device."""
    if compute_dtype == torch.float32:
        return x
    return x.to(compute_dtype).to(torch.float32)


def sa_mlp_pool_reference(grouped: torch.Tensor, valid: torch.Tensor,
                          weights: Weights,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain version of ``sa_mlp_pool``, differentiable: the counterpart
    of the JAX package's ``_sa_jnp_math``. Each layer's operands rounded to
    ``compute_dtype`` and the products summed in float32, ReLU as
    ``maximum(x, 0)`` (half the gradient at 0, as ``jnp.maximum``), an
    additive ``(valid - 1) * 1e9`` penalty, the max over the neighbours
    (``amax`` splits the gradient evenly among ties, as JAX's reduce-max
    does), and 0 for a centroid with no valid neighbour."""
    x = grouped.to(torch.float32)
    zero = x.new_zeros(())
    for w, b in weights:
        x = torch.maximum(_operand(x, compute_dtype)
                          @ _operand(w.to(torch.float32), compute_dtype)
                          + b.to(torch.float32), zero)
    x = x + (valid[..., None].to(torch.float32) - 1.0) * 1e9
    return torch.where(valid.any(1)[:, None], x.amax(1), 0.0)


def sa_mlp_pool(grouped: torch.Tensor, valid: torch.Tensor, weights: Weights,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Three layers of ``relu(x @ W + b)`` over every grouped row, then the
    max over each centroid's valid neighbours.

    grouped (M, K, Cin) float32; valid (M, K) bool; weights
    [(W1, b1), (W2, b2), (W3, b3)] float32 -> (M, Cout) float32, 0 for a
    centroid with no valid neighbour. ``compute_dtype`` float32 or bfloat16:
    with bfloat16 the operands of every product are rounded to it, the
    products and sums stay float32. The (M, K, hidden) activations never
    reach device memory. The kernel takes what ``sa_plan`` takes (K <=
    128, widths that are multiples of 8, a tile that fits a block's shared
    memory) and raises otherwise."""
    if len(weights) != 3:
        raise ValueError("sa_mlp_pool is specialised to 3 MLP layers")
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} is not float32 or "
                         f"bfloat16")
    if grouped.device.type == "cpu":
        return sa_mlp_pool_reference(grouped, valid, weights, compute_dtype)
    dev = _cuda_device(grouped, "sa_mlp_pool")
    m, k, cin = grouped.shape
    _check("grouped", grouped, torch.float32, (m, k, cin), dev)
    _check("valid", valid, torch.bool, (m, k), dev)
    dims = [cin]
    flat = []
    for li, (w, b) in enumerate(weights):
        _check(f"W{li + 1}", w, torch.float32, (dims[-1], w.shape[1]), dev)
        _check(f"b{li + 1}", b, torch.float32, (w.shape[1],), dev)
        dims.append(w.shape[1])
        flat += [w.data_ptr(), b.data_ptr()]
    sa_plan(m, k, *dims)  # raises where the kernel refuses
    fn = load_library().sa_mlp_pool_launch
    with torch.cuda.device(dev):
        out = torch.empty((m, dims[3]), dtype=torch.float32, device=dev)
        err = fn(grouped.data_ptr(), valid.data_ptr(), *flat, m, k, cin,
                 dims[1], dims[2], dims[3],
                 int(compute_dtype == torch.bfloat16), out.data_ptr(),
                 _stream(dev))
        LAUNCHES["sa_mlp_pool"] += 1
    _raise_on(err, "sa_mlp_pool")
    return out


class _SaMlpPool(torch.autograd.Function):
    """``sa_mlp_pool`` forward; the backward recomputes the activations
    with ``sa_mlp_pool_reference`` and takes its gradient. Only the inputs
    are saved: the (M, K, hidden) activations exist only inside each
    pass."""

    @staticmethod
    def forward(ctx, compute_dtype, grouped, valid, *flat):
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(grouped, valid, *flat)
        return sa_mlp_pool(grouped, valid, list(zip(flat[::2], flat[1::2])),
                           compute_dtype)

    @staticmethod
    def backward(ctx, ct):
        grouped, valid, *flat = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in (grouped, *flat)]
            out = sa_mlp_pool_reference(args[0], valid,
                                        list(zip(args[1::2], args[2::2])),
                                        ctx.compute_dtype)
            grads = torch.autograd.grad(out, args, ct)
        return (None, grads[0], None, *grads[1:])


def sa_mlp_pool_trainable(grouped: torch.Tensor, valid: torch.Tensor,
                          weights: Weights,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """``sa_mlp_pool`` under autograd, the counterpart of the JAX
    package's ``sa_mlp_pool_trainable``: the forward is the CUDA kernel for
    card tensors (the plain version for CPU tensors), the backward the
    gradient of ``sa_mlp_pool_reference`` on the saved inputs. Gradients reach
    ``grouped`` and the six weights, none ``valid``."""
    if len(weights) != 3:
        raise ValueError("sa_mlp_pool is specialised to 3 MLP layers")
    return _SaMlpPool.apply(compute_dtype, grouped, valid,
                            *(t for pair in weights for t in pair))
