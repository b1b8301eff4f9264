"""The two kernels of the set-abstraction layer: farthest-point sampling
and the fused shared MLP with its masked max-pool. Wrappers and plain
PyTorch versions.

The counterparts of the JAX package's ``ops/pallas/kernels.py``: ``fps``
(``_fps_single``, ``_fps_batched``) and ``sa_mlp_pool``. The kernels are
``csrc/fps.cu`` (one body, a block per cloud) and ``csrc/sa_mlp_pool.cu``.

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); each launch adds one to ``LAUNCHES``
(``fps_single``, ``fps_batched``, ``sa_mlp_pool``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, _check, _cuda_device, _raise_on, _stream, load_library)

_BIG = 3.4e38  # the distance cache starts here; masked points rank at -_BIG


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


def _fps_launch(name: str, points: torch.Tensor, mask: torch.Tensor,
                n_samples: int, start_index: int) -> torch.Tensor:
    """Launch ``csrc/fps.cu`` on (B, N, 3) float32 points and a (B, N) bool
    mask; returns (B, n_samples) int32."""
    dev = _cuda_device(points, name)
    b, n = points.shape[0], points.shape[1]
    _check("points", points, torch.float32, (b, n, 3), dev)
    _check("mask", mask, torch.bool, (b, n), dev)
    if not 0 <= start_index < n:
        raise ValueError(f"start_index {start_index} outside [0, {n})")
    lib = load_library()
    with torch.cuda.device(dev):
        out = torch.empty((b, n_samples), dtype=torch.int32, device=dev)
        # clouds whose distance cache does not fit in shared memory keep it
        # in this buffer
        need = lib.fps_scratch_floats(n)
        scratch = torch.empty((b, need), dtype=torch.float32, device=dev) \
            if need else None
        err = lib.fps_launch(points.data_ptr(), mask.data_ptr(),
                             scratch.data_ptr() if need else None, b, n,
                             n_samples, start_index, out.data_ptr(),
                             _stream(dev))
        LAUNCHES[name] += 1
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
    """Plain version of ``sa_mlp_pool``."""
    x = grouped.to(torch.float32)
    for w, b in weights:
        x = torch.relu(_operand(x, compute_dtype)
                       @ _operand(w.to(torch.float32), compute_dtype)
                       + b.to(torch.float32))
    x = torch.where(valid[..., None], x, -torch.inf)
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
    reach device memory. The kernel takes K <= 128 and hidden widths that
    are multiples of 8, and raises otherwise."""
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
    if k > 128 or any(h % 8 for h in dims[1:]):
        raise ValueError(f"sa_mlp_pool kernel takes K <= 128 and widths that "
                         f"are multiples of 8, got K = {k}, widths "
                         f"{dims[1:]}")
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
