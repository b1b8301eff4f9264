"""Point sampling ops.

- ``farthest_point_sampling``: the PointNet++ downsampler in its
  distance-cache formulation, in plain PyTorch on any device. It is the
  model of the ``fps`` kernel's plain version and shares its code
  (``ops/cuda/pointnet.py::fps_reference``); the set-abstraction layers
  call the kernel's wrapper, not this.
- ``random_downsample``: keep about a share of the valid points, drawn
  from an explicit ``torch.Generator``.
- ``voxel_downsample``: one representative point per voxel.

Both downsamplers mask points out and remove none: shapes stay static.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.columns import (
    INT_MAX)
from lidar_ai_recommendation_software_tpu_torch.ops.cuda.pointnet import (
    fps_reference)


def farthest_point_sampling(points: torch.Tensor, mask: torch.Tensor,
                            n_samples: int, start_index: int = 0
                            ) -> torch.Tensor:
    """Select ``n_samples`` indices spreading over the valid points.

    points (N, D) padded; mask (N,). Returns (n_samples,) int32. Invalid
    points are never selected; with fewer valid points than samples the
    indices repeat (callers mask by unique)."""
    return fps_reference(points, mask, n_samples, start_index)


def keep_from_uniforms(u: torch.Tensor, mask: torch.Tensor, factor: float
                       ) -> torch.Tensor:
    """The keep mask of ``random_downsample`` for given uniforms ``u`` (N,):
    valid points with ``u < factor``, and the first valid point when none
    would survive."""
    keep = mask & (u < factor)
    first_valid = torch.argmax(mask.to(torch.int8))
    keep[first_valid] |= ~keep.any() & mask[first_valid]
    return keep


def random_downsample(generator: torch.Generator, points: torch.Tensor,
                      mask: torch.Tensor, factor: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep about ``factor`` of the valid points (masked out, not
    removed). ``generator`` lives on the points' device and takes the place
    of the JAX package's PRNG key; the two draw different numbers from one
    seed."""
    if factor >= 1.0:
        return points, mask
    u = torch.rand(points.shape[0], generator=generator,
                   device=points.device)
    return points, keep_from_uniforms(u, mask, factor)


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor,
                     voxel_size: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep one representative (lowest padded index) per voxel.

    Three stable sorts, z then y then x, order the points by voxel without
    flattening the voxel coordinates into one integer (the flattened id
    overflows int32 for venue-scale extents at centimetre voxels).
    Stability makes the first row of each group the lowest original
    index."""
    n = points.shape[0]
    big = torch.finfo(points.dtype).max
    pmin = torch.where(mask[:, None], points, big).amin(0)
    # divide by a device tensor: CUDA multiplies by a Python float's
    # reciprocal, which rounds differently
    coords = torch.floor((points - pmin) / points.new_tensor(voxel_size)
                         ).to(torch.int32)
    keys = [torch.where(mask, coords[:, a], INT_MAX) for a in range(3)]
    order = torch.arange(n, device=points.device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    sx, sy, sz = (key[order] for key in keys)
    is_first = torch.ones(n, dtype=torch.bool, device=points.device)
    is_first[1:] = ((sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1])
                    | (sz[1:] != sz[:-1]))
    keep = torch.zeros(n, dtype=torch.bool, device=points.device)
    keep[order] = is_first & (sx != INT_MAX)
    return points, keep
