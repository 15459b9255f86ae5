"""Structured per-step metrics with an optional JSONL sink.

Counterpart of ``python_fluid_simulation_tpu.utils.metrics``.  The
reference's observability is ``print`` + tqdm keyed on simulated time
(cell 13 :4562-4578).  Here every step returns a metrics dict (dt, CG
iterations and residuals per solver, max speed); this module turns
stacked ``simulate`` outputs or per-step dicts into JSONL records.
Values may be tensors on any device, numpy arrays or Python numbers.
"""

from __future__ import annotations

import json
import time
from typing import IO, Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self._fh: Optional[IO] = open(path, "a") if path else None
        self.history = []
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: Dict, **extra):
        rec = {"step": step, "wall_time_s": time.perf_counter() - self._t0}
        for k, v in metrics.items():
            rec[k] = _to_py(v)
        rec.update({k: _to_py(v) for k, v in extra.items()})
        self.history.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def log_scan(self, metrics: Dict, start_step: int = 0):
        """Unstack step-stacked metrics (``simulate``'s) into per-step
        records; tensors are copied to the host once."""
        host = {k: _host(v) for k, v in metrics.items()}
        n = len(next(iter(host.values())))
        for i in range(n):
            self.log(start_step + i, {k: v[i] for k, v in host.items()})

    def close(self):
        if self._fh:
            self._fh.close()


def _host(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _to_py(v):
    a = _host(v)
    if a.ndim == 0:
        return a.item()
    return a.tolist()


def summarize(history) -> Dict:
    """Aggregate per-step records (means over numeric fields)."""
    if not history:
        return {}
    keys = [k for k, v in history[0].items() if isinstance(v, (int, float))]
    return {k: float(np.mean([h[k] for h in history if k in h])) for k in keys}
