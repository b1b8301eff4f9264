"""CrowdNet: a PointNet++-style hierarchical point encoder with a
bird's-eye-view (BEV) analytics head.

  points (B, N, 3) -> SA1 (FPS, r = 0.4, K = 32, MLP 32-32-64)
                   -> SA2 (FPS, r = 1.0, K = 32, MLP 64-64-128)
                   -> BEV scatter-mean of the SA1 and SA2 levels
                      ++ raw-point pillar stats (log-count, mean z, max z)
                      ++ coordinate channels (venue-relative + absolute)
                   -> 3x3 conv trunk
                   -> heads: density (G, G) people/m^2 [softplus],
                             flow (G, G, 2) m/s,
                             congestion (G, G) 0-1 [sigmoid],
                             count () people [softplus map, integrated]

The counterpart of the JAX package's ``models/crowdnet.py``. Its modules
take one example and are lifted over the batch with ``nn.vmap``; here the
batch dimension is written out, so ``CrowdNet`` is what ``BatchedCrowdNet``
is there. Attribute names are the flax names (``sa1``, ``sa2``, ``bev``,
``density_head_hidden``, ...), and ``models/train.py::params_from_flax``
carries a flax parameter tree into this module's ``state_dict``. Layouts at
the public functions are the JAX package's: BEV maps are (B, G, G[, C]),
channels last.

Each set-abstraction layer goes through ``fps_batched`` and ``sa_mlp_pool``
(``ops/cuda/pointnet.py``): the CUDA kernels for tensors on a card, their
plain versions for CPU tensors. The model serves; it has no backward
through the kernels yet (ROADMAP.md, queue 1, item 10).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.pointnet import (
    fps_batched, sa_mlp_pool)
from lidar_ai_recommendation_software_tpu_torch.ops.grouping import (
    ball_group, group_features)

Level = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) at idx (B, M): (B, M, ...)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.to(torch.int64)]


class SetAbstraction(nn.Module):
    """One PointNet++ set-abstraction layer over a batch of clouds:
    farthest-point sampling, ball grouping, a shared 3-layer MLP and a
    masked max-pool. Parameters are ``mlp{i}_kernel`` (in, out) and
    ``mlp{i}_bias``, float32; ``dtype`` is the type the MLP's products see
    (bfloat16 rounds their operands, sums stay float32)."""

    def __init__(self, n_samples: int, radius: float, k: int,
                 mlp: Sequence[int], in_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(mlp) != 3:
            raise ValueError("the fused MLP kernel takes 3 layers")
        self.n_samples, self.radius, self.k = n_samples, radius, k
        self.dtype = dtype
        dims = [3 + in_channels] + list(mlp)
        for li, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_parameter(
                f"mlp{li}_kernel",
                nn.Parameter(torch.randn(a, b) / float(a) ** 0.5))
            self.register_parameter(f"mlp{li}_bias",
                                    nn.Parameter(torch.zeros(b)))

    def sample(self, points: torch.Tensor, mask: torch.Tensor
               ) -> torch.Tensor:
        """Farthest-point sampling of every cloud: (B, M) int32."""
        return fps_batched(points, mask, self.n_samples)

    def group(self, points: torch.Tensor, features: Optional[torch.Tensor],
              mask: torch.Tensor, idx: torch.Tensor):
        """Ball grouping around the sampled points ``idx`` (B, M):
        (centroids (B, M, 3), centroid mask (B, M), neighbour indices
        (B, M, K) int32, neighbour validity (B, M, K), grouped rows
        (B, M, K, Cin))."""
        centroids, cmask = _take(points, idx), _take(mask, idx)
        gidx, gvalid, grouped = [], [], []
        for b in range(points.shape[0]):
            gi, gv = ball_group(centroids[b], cmask[b], points[b], mask[b],
                                self.radius, self.k)
            gidx.append(gi)
            gvalid.append(gv)
            grouped.append(group_features(
                points[b], None if features is None else features[b],
                centroids[b], gi, gv))
        return (centroids, cmask, torch.stack(gidx), torch.stack(gvalid),
                torch.stack(grouped))

    def pool(self, grouped: torch.Tensor, gvalid: torch.Tensor,
             cmask: torch.Tensor) -> torch.Tensor:
        """The shared MLP and the max over valid neighbours, one kernel
        launch for the whole batch: (B, M, Cout), 0 at masked centroids."""
        b, m, k, cin = grouped.shape
        weights = [(getattr(self, f"mlp{li}_kernel"),
                    getattr(self, f"mlp{li}_bias")) for li in range(3)]
        pooled = sa_mlp_pool(grouped.reshape(b * m, k, cin),
                             gvalid.reshape(b * m, k), weights,
                             compute_dtype=self.dtype).reshape(b, m, -1)
        return torch.where(cmask[..., None], pooled, 0.0)

    def forward(self, points: torch.Tensor,
                features: Optional[torch.Tensor], mask: torch.Tensor
                ) -> Level:
        """points (B, N, 3), features (B, N, C) or None, mask (B, N) ->
        (centroids (B, M, 3), pooled (B, M, Cout), centroid mask (B, M))."""
        idx = self.sample(points, mask)
        centroids, cmask, _, gvalid, grouped = self.group(
            points, features, mask, idx)
        return centroids, self.pool(grouped, gvalid, cmask), cmask


def _bev_cells(xy: torch.Tensor, m: torch.Tensor, g: int,
               venue_min: torch.Tensor, venue_size: torch.Tensor
               ) -> torch.Tensor:
    """Flat BEV cell of every point, (B, n) int64; masked points get the
    spill cell g * g. Divides by the device tensor ``venue_size``, and the
    cast truncates toward zero."""
    rel = (xy - venue_min[:, None, :]) / venue_size[:, None, None]
    cell = (rel * g).to(torch.int32).clamp(0, g - 1).to(torch.int64)
    return torch.where(m, cell[..., 0] * g + cell[..., 1], g * g)


def _segment_sums(values: torch.Tensor, flat: torch.Tensor, g: int
                  ) -> torch.Tensor:
    """Per example, the sum of ``values`` (B, n, C) over the rows of each
    cell ``flat`` (B, n): (B, g * g, C), the spill cell dropped.
    Deterministic on a card, unlike ``index_add_`` with its float atomics:
    a stable sort by cell, a float64 prefix sum and differences at the
    cells' ends, as the cluster centroids are summed."""
    b, n, c = values.shape
    cells = g * g + 1
    ids = (flat + torch.arange(b, device=flat.device)[:, None] * cells
           ).reshape(-1)
    order = torch.sort(ids, stable=True).indices
    cols = values.reshape(b * n, c)[order].T.to(torch.float64).contiguous()
    prefix = torch.nn.functional.pad(torch.cumsum(cols, 1), (1, 0))
    cnts = torch.bincount(ids, minlength=b * cells)
    end = torch.cumsum(cnts, 0)
    sums = (prefix[:, end] - prefix[:, end - cnts]).T.to(values.dtype)
    return sums.reshape(b, cells, c)[:, :-1]


def _cell_counts(flat: torch.Tensor, g: int) -> torch.Tensor:
    """Rows per cell, (B, g * g) float32, the spill cell dropped."""
    b = flat.shape[0]
    cells = g * g + 1
    ids = flat + torch.arange(b, device=flat.device)[:, None] * cells
    cnts = torch.bincount(ids.reshape(-1), minlength=b * cells)
    return cnts.reshape(b, cells)[:, :-1].to(torch.float32)


def _scatter_mean(xy, feats, m, g, venue_min, venue_size):
    """Masked per-cell feature means and counts: (B, g * g, C) and
    (B, g * g)."""
    flat = _bev_cells(xy, m, g, venue_min, venue_size)
    cnts = _cell_counts(flat, g)
    sums = _segment_sums(feats, flat, g)
    return sums / cnts.clamp_min(1.0)[..., None], cnts


class BEVHead(nn.Module):
    """Pillarised BEV trunk over three evidence streams: scattered SA
    features of each level with their occupancy, raw-point pillar
    statistics (log-count, mean z, max z) and coordinate channels; two 3x3
    convolutions, then the pillar statistics and coordinates once more
    beside the trunk's output (the heads read them directly)."""

    def __init__(self, grid: int, in_channels: int,
                 channels: Sequence[int] = (128, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid, self.dtype = grid, dtype
        dims = [in_channels] + list(channels)
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"Conv_{i}", nn.Conv2d(a, b, 3, padding=1))
        self.n_convs = len(channels)
        self.out_channels = dims[-1] + 7

    def planes(self, levels: Sequence[Level], points: torch.Tensor,
               mask: torch.Tensor, venue_min: torch.Tensor,
               venue_size: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The trunk's input (B, G, G, C) with its pillar (B, G, G, 3) and
        coordinate (B, G, G, 4) planes."""
        g = self.grid
        b = points.shape[0]
        planes = []
        for centroids, features, cmask in levels:
            bev, cnts = _scatter_mean(centroids[..., :2], features, cmask, g,
                                      venue_min, venue_size)
            planes.append(bev.reshape(b, g, g, -1))
            planes.append((cnts > 0).to(bev.dtype).reshape(b, g, g, 1))

        z = points[..., 2]
        flat = _bev_cells(points[..., :2], mask, g, venue_min, venue_size)
        cnt = _cell_counts(flat, g)
        zsum = _segment_sums((z * mask.to(z.dtype))[..., None], flat, g
                             )[..., 0]
        # a maximum is order-free, so the scatter is deterministic
        zmax = torch.full((b, g * g + 1), -torch.inf, dtype=z.dtype,
                          device=z.device).scatter_reduce(
            1, flat, torch.where(mask, z, -torch.inf), reduce="amax"
        )[:, :-1]
        live = cnt > 0
        pillar = torch.stack(
            [torch.log1p(cnt),
             torch.where(live, zsum / cnt.clamp_min(1.0), 0.0),
             torch.where(live, zmax, 0.0)], dim=-1).reshape(b, g, g, 3)
        planes.append(pillar)

        # coordinate channels: venue-relative 0-1 and absolute metres / 20
        gt = venue_size.new_tensor(float(g))
        ix = (torch.arange(g, dtype=torch.float32, device=points.device)
              + 0.5) / gt
        rx, ry = torch.meshgrid(ix, ix, indexing="ij")
        cellw = (venue_size / gt)[:, None, None]
        ax = (venue_min[:, 0, None, None] + rx * g * cellw) * 0.05
        ay = (venue_min[:, 1, None, None] + ry * g * cellw) * 0.05
        coords = torch.stack([rx.expand(b, g, g), ry.expand(b, g, g), ax,
                              ay], dim=-1)
        planes.append(coords)
        return torch.cat(planes, dim=-1), pillar, coords

    def forward(self, levels, points, mask, venue_min, venue_size):
        h, pillar, coords = self.planes(levels, points, mask, venue_min,
                                        venue_size)
        h = h.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            conv = getattr(self, f"Conv_{i}")
            h = torch.relu(_conv(h.to(self.dtype), conv, self.dtype))
        return torch.cat([h.permute(0, 2, 3, 1).to(torch.float32), pillar,
                          coords], dim=-1)


def _conv(x: torch.Tensor, conv: nn.Conv2d,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``conv`` on x (B, C, H, W) with operands of ``dtype``, in full
    float32 precision on a card: cuDNN runs float32 convolutions in TF32
    unless told otherwise, and only inside this call is it told."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        return torch.nn.functional.conv2d(
            x, conv.weight.to(dtype), conv.bias.to(dtype),
            padding=conv.padding)


class CrowdNet(nn.Module):
    """The full model over a batch: points (B, N, 3), mask (B, N),
    venue_min (B, 2), venue_size (B,) -> {"density" (B, G, G), "flow"
    (B, G, G, 2), "congestion" (B, G, G), "count" (B,)}."""

    HEADS = (("density_head", 1), ("flow_head", 2), ("congestion_head", 1),
             ("count_head", 1))

    def __init__(self, sa1_samples: int = 2048, sa2_samples: int = 512,
                 grid: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid = grid
        self.sa1 = SetAbstraction(sa1_samples, 0.4, 32, (32, 32, 64), 0,
                                  dtype=dtype)
        self.sa2 = SetAbstraction(sa2_samples, 1.0, 32, (64, 64, 128), 64,
                                  dtype=dtype)
        self.bev = BEVHead(grid, 64 + 1 + 128 + 1 + 3 + 4, dtype=dtype)
        for name, ch in self.HEADS:
            self.add_module(f"{name}_hidden",
                            nn.Conv2d(self.bev.out_channels, 32, 1))
            self.add_module(name, nn.Conv2d(32, ch, 1))
        # softplus(-3) is about 0.05 people/m^2, the typical mean label
        nn.init.constant_(self.density_head.bias, -3.0)

    def _head(self, name: str, h: torch.Tensor) -> torch.Tensor:
        hid = torch.relu(_conv(h, getattr(self, f"{name}_hidden")))
        return _conv(hid, getattr(self, name)).permute(0, 2, 3, 1)

    def forward(self, points: torch.Tensor, mask: torch.Tensor,
                venue_min: torch.Tensor, venue_size: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        c1, f1, m1 = self.sa1(points, None, mask)
        c2, f2, m2 = self.sa2(c1, f1, m1)
        h = self.bev([(c1, f1, m1), (c2, f2, m2)], points, mask, venue_min,
                     venue_size).permute(0, 3, 1, 2)
        density = _softplus(self._head("density_head", h))[..., 0]
        flow = self._head("flow_head", h)
        congestion = torch.sigmoid(self._head("congestion_head", h))[..., 0]
        cmap = _softplus(self._head("count_head", h))[..., 0]
        gt = venue_size.new_tensor(float(self.grid))
        cell_area = (venue_size / gt) ** 2
        return {"density": density, "flow": flow, "congestion": congestion,
                "count": cmap.sum(dim=(1, 2)) * cell_area}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``, the form flax uses
    (``F.softplus`` switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))
