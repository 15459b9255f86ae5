"""Reading a ``torch.profiler`` trace of the window: the device's busy
time as the union of its kernel, memcpy and memset intervals (the
arithmetic of the port's ``profile_step.py``, copied), device time by
kernel name, and the longest idle gaps with what the host was doing."""

from __future__ import annotations

import bisect
from typing import Iterable, List, Tuple

import torch

_DEVICE = torch.autograd.DeviceType.CUDA
_CPU = torch.autograd.DeviceType.CPU


# ranges opened on the host (the program's ``pfs_*``), which the profiler
# also lays on the device's timeline over the kernels they span
RANGE_PREFIXES = ("pfs_",)


def device_events(events) -> list:
    """(name, start_us, end_us) of every device activity (kernels, copies,
    fills); ranges, which only span kernels, are left out."""
    return [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events
            if e.device_type == _DEVICE and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(RANGE_PREFIXES)]


def host_events(events) -> list:
    return [(e.name, float(e.time_range.start), float(e.time_range.end)) for e in events if e.device_type == _CPU]


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def union_us(spans) -> float:
    """Length of the union of the intervals."""
    return sum(hi - lo for lo, hi in merged(spans))


def by_name(dev) -> dict:
    """{name: (launches, device microseconds)}."""
    out = {}
    for name, lo, hi in dev:
        n, us = out.get(name, (0, 0.0))
        out[name] = (n + 1, us + hi - lo)
    return out


def gaps_after(dev, marker: str) -> list:
    """The idle gap that follows each device activity whose name holds
    ``marker``: from its end to the start of the next activity."""
    busy = merged((lo, hi) for _, lo, hi in dev)
    starts = [lo for lo, _ in busy]
    out = []
    for name, _, hi in dev:
        if marker in name:
            i = bisect.bisect_right(starts, hi)
            if i < len(starts):
                out.append(starts[i] - hi)
    return out


def idle_gaps(dev, host, n: int = 10, busy_after: str = "") -> list:
    """The n longest gaps between the device's busy intervals, each named
    by the shortest host event that spans its middle.  A gap that follows
    an activity whose name holds ``busy_after`` (a WHILE node's test, whose
    body the profiler does not show) is busy, not idle, and left out."""
    busy = merged((lo, hi) for _, lo, hi in dev)
    ends = {hi for name, _, hi in dev if busy_after and busy_after in name}
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy[:-1], busy[1:]) if a[1] not in ends),
                  reverse=True)[:n]
    out = []
    for length, lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        spanning = [(e - s, name) for name, s, e in host if s <= mid <= e]
        label = min(spanning)[1] if spanning else "no host event"
        out.append([label, length * 1e-6])
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list and template brackets."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].split("<")[0].strip()[:120] or name[:120]
