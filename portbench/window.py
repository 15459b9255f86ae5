"""The window's arithmetic: the rate over the whole window and the tail
of the step times, by nearest rank."""

from __future__ import annotations

import math
from typing import Sequence


def rate(steps: int, seconds: float) -> float:
    """Steps over the window's whole time (first dispatch to the last
    block's synchronise)."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return steps / seconds


def percentile_nearest_rank(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank: the value at
    rank ceil(q/100 * n) of the sorted values."""
    if not values:
        raise ValueError("no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q}")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def block_step_ms(marks_ms: Sequence[float], end_ms: float) -> list:
    """A block's step times from the times of the events recorded before
    each replay and the event after the block: step i runs from mark i to
    mark i + 1, the last to the end."""
    bounds = list(marks_ms) + [end_ms]
    return [b - a for a, b in zip(bounds[:-1], bounds[1:])]
