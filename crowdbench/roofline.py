"""Published peaks and the work of the layers whose rooflines the
benchmark reports, counted from their inputs and outputs alone, never
from a layout of the program's.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its full power limit
of 700 W (a card set below it runs slower; the run prints the limit).
"""

from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "h100": {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12,
             "bf16_flops": 989e12},
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """Peaks of the card named ``device_name``, None for an unknown one."""
    low = device_name.lower()
    for key, value in PEAKS.items():
        if key in low:
            return dict(value)
    return None


def clustering_bytes(clustered_points: int) -> int:
    """Bytes the clustering has to move: each clustered point's xyz
    (3 x float32) read once and its label (int32) written once."""
    return 16 * int(clustered_points)


def roofline_pct(work_bytes: float, device_s: float,
                 bytes_per_s: float) -> Optional[float]:
    """The least time the work could take, over the device time it took,
    in percent; None when nothing was timed."""
    if device_s <= 0 or work_bytes <= 0:
        return None
    return 100.0 * (work_bytes / bytes_per_s) / device_s
