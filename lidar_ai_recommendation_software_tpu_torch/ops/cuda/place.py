"""``place_dense``: a monotone scatter of at most one row per dense slot,
with occupancy. Wrapper and plain PyTorch version.

The counterpart of the JAX package's ``ops/pallas/fill.py::place_dense``;
the kernel is ``csrc/place_dense.cu``. ``ops/clustering.py`` packs each
cluster's end-of-segment prefix with it on the centroid route of the
largest scans.

As in ``kernels.py``: a CPU tensor takes the plain version, a CUDA tensor
the kernel (or an error); a launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from lidar_ai_recommendation_software_tpu_torch.ops.cuda.kernels import (
    LAUNCHES, _check, _cuda_device, _raise_on, _stream, load_library)

LANES = 512  # slots are padded to a multiple of this, as in the JAX package


def padded_slots(k: int, lanes: int = LANES) -> int:
    """K': ``k`` rounded up to a multiple of ``lanes``, at least ``lanes``."""
    return -(-max(k, lanes) // lanes) * lanes


def _channel_rows(channels: Union[torch.Tensor, Sequence[torch.Tensor]]
                  ) -> torch.Tensor:
    """The channels as one (C, n) float32 tensor (a sequence of (n,)
    tensors is stacked)."""
    if not isinstance(channels, torch.Tensor):
        channels = torch.stack(list(channels))
    return channels


def place_dense_reference(ids: torch.Tensor, valid: torch.Tensor,
                          channels, k: int, lanes: int = LANES
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``place_dense``."""
    ch = _channel_rows(channels)
    kp = padded_slots(k, lanes)
    out = torch.zeros((ch.shape[0] + 1, kp), dtype=torch.float32,
                      device=ids.device)
    slot = ids[valid].clamp(0, kp - 1).to(torch.int64)
    out[:-1, slot] = ch[:, valid]
    out[-1, slot] = 1.0
    return out[:-1], out[-1]


def place_dense(ids: torch.Tensor, valid: torch.Tensor, channels, k: int,
                lanes: int = LANES) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out[c, id] = channels[c][j]`` for the one valid row j with
    ``ids[j] == id``.

    ids (n,) int32, non-decreasing; valid (n,) bool; channels a (C, n)
    float32 tensor or a sequence of C (n,) tensors. Returns (out (C, K')
    float32, occupancy (K',) float32: 1 where a row landed), with K' = ``k``
    rounded up to ``lanes``; slots no row hit are 0 in both. Exact: values
    are copied. Ids are clipped into [0, K' - 1] first, as the JAX function
    clips them, so a valid row with an id past the end lands in the last
    slot. At most one valid row may land in a slot; with more, which one
    stays is not defined."""
    ch = _channel_rows(channels)
    if ids.device.type == "cpu":
        return place_dense_reference(ids, valid, ch, k, lanes)
    dev = _cuda_device(ids, "place_dense")
    n, nch = ids.shape[0], ch.shape[0]
    _check("ids", ids, torch.int32, (n,), dev)
    _check("valid", valid, torch.bool, (n,), dev)
    _check("channels", ch, torch.float32, (nch, n), dev)
    kp = padded_slots(k, lanes)
    fn = load_library().place_dense_launch
    with torch.cuda.device(dev):
        out = torch.empty((nch + 1, kp), dtype=torch.float32, device=dev)
        err = fn(ids.data_ptr(), valid.data_ptr(), ch.data_ptr(), n, nch, kp,
                 out.data_ptr(), _stream(dev))
        LAUNCHES["place_dense"] += 1
    _raise_on(err, "place_dense")
    return out[:-1], out[-1]
