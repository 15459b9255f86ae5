"""Where a step's time goes on the GPU.

    python3 -m python_fluid_simulation_tpu_torch.profile_step [--scene buckling|coiling] [--res R]
        [--viscosity-precond jacobi|mg|auto] [--no-jacobi-precond] [--pressure-dt-scaled]
        [--viscosity-mode apic|unet|unet_warm] [--unet-bf16] [--mesh N|SXxSZ [--bucketed]] [--graph] [--steps 3]
        [--out DIR]

Runs a step on the card.  ``--scene buckling`` (the default): the
48x80x48 flagship (``buckling_config()`` defaults) without ``--res``,
else ``scaled_buckling_config(R)`` (``--res 128``: 77x128x77 cells,
356,256 particles, MG-PCG cell solves; ``--res 256``: 154x256x154 cells,
2,903,629 particles, Jacobi cell solves through the live-cell Poisson
PCG).  ``--scene coiling``:
``coiling_config(R)`` (default R 256: 64x256x64 cells, 73,644 particles,
MG-PCG cell solves, the 'auto' viscosity preconditioner; ``--res 504``:
the big grid, 126x504x126 cells, 465,868 particles, Jacobi cell solves
through the live-cell Poisson PCG, and with ``--viscosity-precond mg``
the lean two-grid viscosity MG); ``--viscosity-precond`` overrides the configuration's (``mg`` profiles
the MG branch).  ``--no-jacobi-precond`` sets ``jacobi_precond=False``
(the reference's unpreconditioned CG: the non-MG solves run the generic
CG over ``stencil_matvec`` and ``coupled_stencil_matvec``);
``--pressure-dt-scaled`` sets ``pressure_dt_scaled``.
``--viscosity-mode unet|unet_warm`` runs the learned operator: the
full-width UNet (``models/unet3d.py``, width 64, 68,723,203 parameters)
with weights drawn from ``convert.random_flax_unet_params(seed=0)``, in
fp32 (TF32 off), or with ``--unet-bf16`` computing in bf16.  ``--mesh 4``
runs the sharded step on ``make_mesh(4)``, ``--mesh 2x2`` on
``make_mesh2d((2, 2))`` (the slots share the card; the state padded by
``shard_state``); with ``--bucketed`` the particles are bucketed by
slot (``parallel/particles.py`` on ``N`` slots, ``parallel/particles2d.py``
on ``SXxSZ``, the caps sized from the scene's positions) and the step is
the bucketed one.  ``--graph`` profiles the step as a CUDA graph replays
it (``engine/step.py::replaying_step``, with the geometry built once as
here: the first warm-up step captures it, each step copies the state in,
reads the 'auto' flag where there is one, replays and clones the state
out; with ``--mesh`` the sharded or bucketed step, its distributed
solves as WHILE nodes, no flag read); the ranges below are recorded at
capture and are empty in its replays, where the kernels are still
reported by name (but for the kernels of a WHILE body, which the
profiler does not report: the busy time and launches leave them out),
and the JSON line adds the capture's seconds, its pools' bytes and its
nodes.  Every fold
call is a ``pfs_fold`` range in the profile, every live placement of a
segment reduce (``ops/cuda_binned.py::place_live``) a ``pfs_place`` range,
every multigrid V-cycle application a ``pfs_vcycle`` range (the cell
solves' and the batched viscosity preconditioner's, and the lean route's
inner cycle), every learned-operator call
(features, network, extraction) a ``pfs_unet_delta_v`` range.  3 warm-up steps, then ``--steps``
steps timed on the host clock without the profiler, then ``--steps``
steps under ``torch.profiler`` (CPU + CUDA activities).  Prints one JSON
line with the step times, the device busy time (the union of the CUDA
kernel and memcpy/memset intervals: kernels on several streams, as the
halo push route's slots, overlap), the idle
share, the CUDA runtime calls per step (kernel launches, cooperative
launches, stream synchronisations), the device time and launches of the
port's own kernels, the profiled steps' solver iterations, the peak
device memory, a hash of the final particles (x, v, c), and the top
operators by device and by host time;
writes the full ``key_averages`` tables to
``<out>/profile_step[_<scene>][_<R>][_<precond>][_nojacobi][_dtscaled][_<mode>[_bf16]][_mesh<M>[_bucketed]].txt``.
`profile_steps` is the same measurement for any step function
(``chip_smoke.py``'s ``mesh_504`` phase calls it).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import hashlib
import json
import os
import time



def _busy_us(events) -> float:
    """Length of the union of the events' device intervals (us)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def profile_steps(step, state, steps: int):
    """`steps` calls of ``step(state) -> (state, metrics)`` under
    ``torch.profiler`` (CPU + CUDA); returns (state, summary, key
    averages).  The summary has the step ms on the host clock, the device
    busy ms a step (the union of the kernel and memcpy/memset intervals,
    the ``pfs_*`` ranges left out), the idle share, the CUDA runtime calls
    and device events a step, the port's own kernels' launches and device
    ms a step, the ``pfs_fold`` / ``pfs_place`` / ``pfs_vcycle`` /
    ``pfs_unet_delta_v`` ranges, and the top
    operators by device and by host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    metrics = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step(state)
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_ms = wall / steps * 1e3

    events = prof.events()
    # the device side of the pfs_* ranges is an annotation spanning their
    # kernels, not work of its own: left out of the busy time
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("pfs_")]
    busy_us = _busy_us(kernels)
    avgs = prof.key_averages()
    runtime = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("cuda"):
            runtime[e.name] = runtime.get(e.name, 0) + 1
    own = {}  # the port's kernels, by name
    for e in kernels:
        name = e.name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0].split("<")[0].strip()
        if name.endswith("_kernel") and any(k in name for k in ("pcg", "stencil", "mg_", "binned", "place_live",
                                                                "seg_scan", "fold", "matvec", "halo")):
            n, us = own.get(name, (0, 0.0))
            own[name] = (n + 1, us + e.time_range.elapsed_us())

    def top(key, n=15):
        rows = sorted(avgs, key=lambda a: getattr(a, key), reverse=True)[:n]
        return [
            {"name": a.key, "calls_per_step": a.count / steps,
             "device_ms_per_step": a.device_time_total / 1e3 / steps,
             "host_self_ms_per_step": a.self_cpu_time_total / 1e3 / steps}
            for a in rows
        ]

    def ranges(name):
        return [{"calls": a.count / steps, "host_ms": a.cpu_time_total / 1e3 / steps,
                 "device_ms": a.device_time_total / 1e3 / steps} for a in avgs if a.key == name]

    busy_ms = busy_us / 1e3 / steps
    summary = {
        # the folds' and the live placements' ranges: host time (CPU
        # total) and the device time of the kernels they launched, per step
        "fold_per_step": ranges("pfs_fold"),
        "place_per_step": ranges("pfs_place"),
        # the multigrid V-cycle applications' range
        "vcycle_per_step": ranges("pfs_vcycle"),
        # the learned operator's range (features, network, extraction)
        "unet_delta_v_per_step": ranges("pfs_unet_delta_v"),
        "steps": steps,
        # each profiled step's solver iterations (read after the window)
        "solver_iters": {k: [int(m[k]) for m in metrics] for k in ("density_iters", "viscosity_iters", "pressure_iters")
                         if k in metrics[0]},
        "step_ms": step_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy_ms / step_ms,
        "cuda_events_per_step": len(kernels) / steps,
        "runtime_calls_per_step": {k: v / steps for k, v in sorted(runtime.items())},
        "own_kernels_per_step": {k: {"launches": n / steps, "device_ms": us / 1e3 / steps}
                                 for k, (n, us) in sorted(own.items())},
        "top_device": top("self_device_time_total"),
        "top_host": top("self_cpu_time_total"),
    }
    return state, summary, avgs


def bucketed_particles(state, cfg, mesh):
    """(spec, particles): the (shard_state'd) particles bucketed by slot
    on `mesh`, by x-slab on a 1D mesh, by x-by-z block on an (x, z) mesh,
    the caps sized from the positions."""
    from python_fluid_simulation_tpu_torch.parallel import particles, particles2d

    g, p = cfg.grid, state.particles
    n = int(p.x.shape[0])
    if len(mesh.axis_names) == 2:
        spec = particles2d.make_bucket_spec_2d(tuple(mesh.shape.values()), g.res[0], g.res[2], n, positions=p.x,
                                               bound_min=g.bound_min, cell_size=g.cell_size)
        return spec, particles2d.bucket_particles_2d(p, mesh, spec, g.bound_min, g.cell_size)
    spec = particles.make_bucket_spec(mesh.size, g.res[0], n, positions=p.x, bound_min=g.bound_min,
                                      cell_size=g.cell_size)
    return spec, particles.bucket_particles(p, mesh, spec, g.bound_min, g.cell_size)


def main() -> int:
    import torch
    from torch.profiler import record_function

    from python_fluid_simulation_tpu_torch.engine.scenes import (
        buckling_config,
        buckling_scene,
        coiling_config,
        coiling_scene,
        scaled_buckling_config,
    )
    from python_fluid_simulation_tpu_torch.convert import random_flax_unet_params, unet_state_dict_from_flax
    from python_fluid_simulation_tpu_torch.engine import step as step_mod
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
    from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_fold, scatter
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d, shard_state
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("buckling", "coiling"), default="buckling")
    ap.add_argument("--res", type=int, default=None,
                    help="buckling: scaled_buckling_config(res), default the flagship; coiling: coiling_config(res), default 256")
    ap.add_argument("--viscosity-precond", choices=("jacobi", "mg", "auto"), default=None)
    ap.add_argument("--no-jacobi-precond", action="store_true", help="SolverConfig(jacobi_precond=False)")
    ap.add_argument("--pressure-dt-scaled", action="store_true", help="SolverConfig(pressure_dt_scaled=True)")
    ap.add_argument("--viscosity-mode", choices=("apic", "unet", "unet_warm"), default="apic")
    ap.add_argument("--unet-bf16", action="store_true", help="the UNet computes in bf16 (parameters fp32)")
    ap.add_argument("--mesh", default=None, help="the sharded step: N slots (make_mesh), or SXxSZ (make_mesh2d)")
    ap.add_argument("--bucketed", action="store_true", help="with --mesh: the particles bucketed by slot")
    ap.add_argument("--graph", action="store_true", help="replay the step as a captured CUDA graph")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=".")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")

    if args.scene == "coiling":
        cfg = coiling_config(args.res or 256)
        state = coiling_scene(cfg, device="cuda")
    else:
        cfg = buckling_config() if args.res is None else scaled_buckling_config(args.res)
        state = buckling_scene(cfg, device="cuda")
    solver = {}
    if args.viscosity_precond:
        solver["viscosity_precond"] = args.viscosity_precond
    if args.no_jacobi_precond:
        solver["jacobi_precond"] = False
    if args.pressure_dt_scaled:
        solver["pressure_dt_scaled"] = True
    solver["viscosity_mode"] = args.viscosity_mode
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **solver))
    unet = None
    if args.viscosity_mode != "apic":
        unet = UNet3D(width=64, dtype=torch.bfloat16 if args.unet_bf16 else torch.float32)
        unet.load_state_dict(unet_state_dict_from_flax(random_flax_unet_params(64, seed=0)))
        unet = unet.to("cuda").eval()

    def fold_range(*a, **kw):
        with record_function("pfs_fold"):
            return cuda_fold.fold(*a, **kw)

    place_live = cuda_binned.place_live

    # wraps: the range carries place_live's attributes, so the launch count
    # place_live keeps under its module name stays an attribute to add to
    @functools.wraps(place_live)
    def place_range(*a, **kw):
        with record_function("pfs_place"):
            return place_live(*a, **kw)

    unet_delta_v = step_mod.unet_delta_v

    def unet_range(*a, **kw):
        with record_function("pfs_unet_delta_v"):
            return unet_delta_v(*a, **kw)

    def vcycle_ranges(make):
        """`make` (a preconditioner factory) with each application of what
        it returns in a ``pfs_vcycle`` range."""
        @functools.wraps(make)
        def build(*a, **kw):
            pre = make(*a, **kw)

            @functools.wraps(pre)
            def apply(r):
                with record_function("pfs_vcycle"):
                    return pre(r)

            return apply

        return build

    scatter.fold = fold_range
    cuda_binned.place_live = place_range
    pressure.make_mg_preconditioner = vcycle_ranges(pressure.make_mg_preconditioner)
    viscosity.make_batched_mg_preconditioner = vcycle_ranges(viscosity.make_batched_mg_preconditioner)
    step_mod.unet_delta_v = unet_range
    mesh = None
    if args.mesh:
        sx, _, sz = args.mesh.partition("x")
        mesh = make_mesh2d((int(sx), int(sz))) if sz else make_mesh(int(sx))
        state = shard_state(state, mesh)
        if args.bucketed:
            state = dataclasses.replace(state, particles=bucketed_particles(state, cfg, mesh)[1])
    elif args.bucketed:
        raise SystemExit("profile_step: --bucketed needs --mesh")
    geom = build_geom_cache(state.solid, mesh)
    if args.graph:
        step = step_mod.replaying_step(cfg, geom=geom, unet=unet, replayer=functools.partial(
            step_mod.StepReplayer, mesh=mesh, bucketed=args.bucketed))
    else:
        step = functools.partial(step_3d, cfg=cfg, geom=geom, unet=unet, mesh=mesh, bucketed=args.bucketed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        state, _ = step(state)
    torch.cuda.synchronize()
    plain_ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, _ = step(state)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)

    state, summary, avgs = profile_steps(step, state, args.steps)
    captures = [c for r in getattr(step, "replayers", {}).values() for c in r.captured.values()]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "scene": args.scene,
        "grid": list(cfg.grid.res),
        "particles": int(state.particles.x.shape[0]),
        "precond": cfg.solver.precond,
        "viscosity_precond": cfg.solver.viscosity_precond,
        "jacobi_precond": cfg.solver.jacobi_precond,
        "pressure_dt_scaled": cfg.solver.pressure_dt_scaled,
        "viscosity_mode": cfg.solver.viscosity_mode,
        "unet_dtype": None if unet is None else str(unet.dtype),
        "mesh": None if mesh is None else mesh.shape,
        "bucketed": args.bucketed,
        "graph": args.graph,
        "capture_seconds": [c.seconds for c in captures],
        "graph_pool_bytes": [c.pool_bytes for c in captures],
        # the graph's top-level nodes and each WHILE body's (the profiler
        # reports no kernel of a WHILE body: its busy time leaves them out)
        "graph_nodes": [c.nodes for c in captures],
        "loop_body_nodes": [list(c.loop_nodes) for c in captures],
        "visc_mg_after": int(torch.as_tensor(state.visc_mg)),
        "unprofiled_step_ms": plain_ms,
        # the particles after every step of the run, for comparing two
        # builds' runs from the same scene bit for bit
        "particles_sha256": hashlib.sha256(b"".join(
            getattr(state.particles, k).cpu().numpy().tobytes() for k in ("x", "v", "c"))).hexdigest(),
        # the peak over the warm-up, timed and profiled steps
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        **summary,
    }
    os.makedirs(args.out, exist_ok=True)
    name = "profile_step"
    if args.scene != "buckling":
        name += f"_{args.scene}"
    if args.res is not None:
        name += f"_{args.res}"
    if args.viscosity_precond:
        name += f"_{args.viscosity_precond}"
    if args.no_jacobi_precond:
        name += "_nojacobi"
    if args.pressure_dt_scaled:
        name += "_dtscaled"
    if args.viscosity_mode != "apic":
        name += f"_{args.viscosity_mode}" + ("_bf16" if args.unet_bf16 else "")
    if mesh is not None:
        name += f"_mesh{args.mesh}" + ("_bucketed" if args.bucketed else "")
    if args.graph:
        name += "_graph"
    name += ".txt"
    with open(os.path.join(args.out, name), "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
        f.write("\n")
        f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=60))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
