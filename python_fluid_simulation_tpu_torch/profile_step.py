"""Where the buckling step's time goes on the GPU.

    python3 -m python_fluid_simulation_tpu_torch.profile_step [--res R] [--steps 3] [--out DIR]

Runs the buckling step on the card: the 48x80x48 flagship
(``buckling_config()`` defaults) without ``--res``, else
``scaled_buckling_config(R)`` (``--res 128``: 77x128x77 cells, 356,256
particles, MG-PCG cell solves).  3 warm-up steps, then ``--steps``
steps timed on the host clock without the profiler, then ``--steps``
steps under ``torch.profiler`` (CPU + CUDA activities).  Prints one JSON
line with the step times, the device busy time (sum of the CUDA kernel
and memcpy/memset times: one stream, so they do not overlap), the idle
share, the CUDA runtime calls per step (kernel launches, cooperative
launches, stream synchronisations), the device time and launches of the
port's own kernels, and the top operators by device and by host time;
writes the full ``key_averages`` tables to
``<out>/profile_step[_<R>].txt``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene, scaled_buckling_config
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d

    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=None, help="scaled_buckling_config(res); default: the flagship")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=".")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    cfg = buckling_config() if args.res is None else scaled_buckling_config(args.res)
    state = buckling_scene(cfg, device="cuda")
    geom = build_geom_cache(state.solid)
    for _ in range(3):
        state, _ = step_3d(state, cfg, geom=geom)
    torch.cuda.synchronize()
    plain_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, _ = step_3d(state, cfg, geom=geom)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step_3d(state, cfg, geom=geom)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = wall / args.steps * 1e3

    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    avgs = prof.key_averages()
    runtime = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    own = {}  # the port's kernels, by name
    for e in kernels:
        name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0].split("<")[0].strip()
        if name.endswith("_kernel") and any(k in name for k in ("pcg", "stencil", "mg_level", "binned")):
            n, us = own.get(name, (0, 0.0))
            own[name] = (n + 1, us + e.time_range.elapsed_us())

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
        "grid": list(cfg.grid.res),
        "particles": int(state.particles.x.shape[0]),
        "precond": cfg.solver.precond,
        "steps": args.steps,
        "unprofiled_step_ms": plain_ms,
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "cuda_events_per_step": len(kernels) / args.steps,
        "runtime_calls_per_step": {k: v / args.steps for k, v in sorted(runtime.items())},
        "own_kernels_per_step": {k: {"launches": n / args.steps, "device_ms": us / 1e3 / args.steps}
                                 for k, (n, us) in sorted(own.items())},
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total"),
    }
    os.makedirs(args.out, exist_ok=True)
    name = "profile_step.txt" if args.res is None else f"profile_step_{args.res}.txt"
    with open(os.path.join(args.out, name), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
