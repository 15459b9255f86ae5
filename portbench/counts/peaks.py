"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

The H100 SXM part, NVIDIA's data sheet, dense rates at the full 700 W
power limit: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor
cores (the step runs no matrix product).  A card set below 700 W runs
slower under load; the run records its power limit beside the numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional


class Peak(NamedTuple):
    bytes_per_s: float
    fp32_flop_per_s: float


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(bytes_per_s=3.35e12, fp32_flop_per_s=67e12),
}


def peak_of(device_name: Optional[str]) -> Optional[Peak]:
    """The card's peaks; None for a card not listed (its shares are then
    not reported)."""
    return PEAKS.get((device_name or "").strip())


def least_seconds(nbytes: float, flops: float, peak: Peak) -> tuple:
    """(seconds, limiter): the larger of bytes over the memory rate and
    operations over the float32 rate, and which of the two it is."""
    t_bytes, t_flops = nbytes / peak.bytes_per_s, flops / peak.fp32_flop_per_s
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")
