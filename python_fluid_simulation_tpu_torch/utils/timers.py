"""Per-phase wall-clock timing and the profiler hook.

Counterpart of ``python_fluid_simulation_tpu.utils.timers``.  Reference
counterpart: ad-hoc timeit spans around p2g / visco / press / g2p with
per-step prints (cell 13 :4566-4667).  CUDA work is asynchronous, so a
phase's host time means something only when the phase waits for the
device: ``block_on`` synchronises the CUDA devices of the tensors it is
given, which serialises the pipeline, so phase timing is opt-in
(``PhaseTimer(enabled=...)``); whole runs take one synchronise a block
and ``profiler_trace`` for the device's own times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _cuda_devices(obj, out: set):
    """The CUDA devices of every tensor in a nest of tensors, lists,
    tuples, dicts and dataclasses."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _cuda_devices(getattr(obj, f.name), out)
    return out


def block_until_ready(obj):
    """Wait for the CUDA devices of the tensors in `obj` (CPU tensors are
    ready when returned)."""
    for dev in _cuda_devices(obj, set()):
        torch.cuda.synchronize(dev)
    return obj


class PhaseTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            block_until_ready(block_on)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def means_ms(self) -> Dict[str, float]:
        return {k: 1e3 * self.totals[k] / max(1, self.counts[k]) for k in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v:.2f} ms" for k, v in sorted(self.means_ms().items()))


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` scope (CPU, and CUDA where a device is
    present) whose Chrome trace is written to ``<logdir>/trace.json``;
    a no-op for None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
