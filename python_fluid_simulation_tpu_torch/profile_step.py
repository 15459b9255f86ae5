"""Where the flagship step's time goes on the GPU.

    python3 -m python_fluid_simulation_tpu_torch.profile_step [--steps 3] [--out DIR]

Runs the 48x80x48 buckling step (``buckling_config()`` defaults) on the
card: 3 warm-up steps, then ``--steps`` steps under ``torch.profiler``
(CPU + CUDA activities).  Prints one JSON line with the host-clock step
time, the device busy time (sum of the CUDA kernel and memcpy/memset
times: one stream, so they do not overlap), the idle share, the CUDA
launches per step, and the top operators by device and by host time;
writes the full ``key_averages`` tables to ``<out>/profile_step.txt``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=".")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    cfg = buckling_config()
    state = buckling_scene(cfg, device="cuda")
    geom = build_geom_cache(state.solid)
    for _ in range(3):
        state, _ = step_3d(state, cfg, geom=geom)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step_3d(state, cfg, geom=geom)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = wall / args.steps * 1e3

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    avgs = prof.key_averages()

    def top(key, n=15):
        rows = sorted(avgs, key=lambda a: getattr(a, key), reverse=True)[:n]
        return [
            {"name": a.key, "calls_per_step": a.count / args.steps,
             "device_ms_per_step": a.device_time_total / 1e3 / args.steps,
             "host_self_ms_per_step": a.self_cpu_time_total / 1e3 / args.steps}
            for a in rows
        ]

    busy_ms = busy_us / 1e3 / args.steps
    summary = {
        "device": torch.cuda.get_device_name(0),
        "steps": args.steps,
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "cuda_events_per_step": len(kernels) / args.steps,
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total"),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "profile_step.txt"), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
