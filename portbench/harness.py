"""One run of one cell: set-up, the window, the check, the result line.

Set-up (counted in ``setup_s``, from process start to the window's first
dispatch): the inputs from the seed, the port's scene and geometry on
the card, ``start_steps`` steps through ``simulate`` from the scene (the
first call builds the kernel library into the port's ``_build/`` inside
the checkout, runs the eager warm-up step and captures the CUDA graph),
then one block from the start state, so the window captures and builds
nothing.

The window (``--trace 0``): blocks of ``segment_steps`` steps, each one
``simulate`` call from the same start state and one synchronise (the
block's metrics read to the host), until ``--seconds`` have passed.
Every block does the same work.  ``--trace 1`` times ``TRACE_BLOCKS``
blocks on the host clock, then records as many under ``torch.profiler``
and reports the per-layer metrics.

Then the check (not timed, after ``memory_peak_bytes`` is read and the
port's graphs are freed): see ``check.py``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import catalog, check, inputs, trace, window
from portbench.catalog import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "python_fluid_simulation_tpu")
ITER_KEYS = ("density_iters", "viscosity_iters", "pressure_iters")
CONVERGED_KEYS = ("density_converged", "viscosity_converged", "pressure_converged")
WHILE_TEST = "while_test_kernel"  # the kernel a WHILE node's test runs before its body
HOST_THREADS = 4
CHECK_STEPS = 3  # steps of the last block the reference repeats, drawn from the seed, the last always
TRACE_BLOCKS = 2  # blocks a --trace 1 run times untraced, then records under the profiler


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _host_metrics(m: dict) -> dict:
    """A block's per-step iterations and convergence, read to the host in
    one transfer (the block's one synchronise)."""
    keys = ITER_KEYS + CONVERGED_KEYS + ("dt",)
    flat = torch.stack([m[k].to(torch.float64) for k in keys]).cpu().numpy()
    return {k: flat[i] for i, k in enumerate(keys)}


def _unconverged(host: dict) -> int:
    ok = np.ones_like(host[CONVERGED_KEYS[0]], dtype=bool)
    for k in CONVERGED_KEYS:
        ok &= host[k] > 0.5
    return int((~ok).sum())


def timed_window(prog, s0, cell, seconds: float, cuda: bool) -> dict:
    """Blocks until ``seconds`` have passed: steps, unconverged steps,
    every step's ms, each block's host ms and the window's host seconds."""
    from portbench.program import TimedReplayer

    steps, failed, step_ms, block_ms, last = 0, 0, [], [], None
    t_begin = time.perf_counter()
    while True:
        if cuda:
            marks = TimedReplayer.marks = []
        t_block = time.perf_counter()
        state, m = prog.simulate(s0, cell.segment_steps)
        if cuda:
            TimedReplayer.marks = None
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        host = _host_metrics(m)
        t_now = time.perf_counter()
        if cuda:
            step_ms += window.block_step_ms([0.0] + [marks[0].elapsed_time(e) for e in marks[1:]],
                                            marks[0].elapsed_time(end))
        else:  # the CPU path (tests only): the block's host time, shared evenly
            step_ms += [(t_now - t_block) * 1e3 / cell.segment_steps] * cell.segment_steps
        block_ms.append((t_now - t_block) * 1e3)
        steps += cell.segment_steps
        failed += _unconverged(host)
        last = state
        if t_now - t_begin >= seconds:
            break
    return {"steps": steps, "failed": failed, "step_ms": step_ms, "block_ms": block_ms, "seconds": t_now - t_begin,
            "last": last}


def traced_window(prog, s0, cell) -> dict:
    """``TRACE_BLOCKS`` blocks timed on the host clock without the
    profiler (the seconds a step that ``step_mfu`` reads), then as many
    under it: the device's busy time, device time by kernel, every step's
    iterations.

    Busy is the union of the device's activities.  Of a WHILE node (the
    generic CG loops) the profiler shows in a replay one iteration of the
    body; the others run in the gap that follows the node's test kernel,
    which is therefore counted busy: an upper estimate, as the gap also
    holds the body's launch latencies."""
    from torch.profiler import ProfilerActivity, profile

    t_begin = time.perf_counter()
    for _ in range(TRACE_BLOCKS):
        _host_metrics(prog.simulate(s0, cell.segment_steps)[1])
    untraced_s = time.perf_counter() - t_begin
    iters, failed, state = [], 0, None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_begin = time.perf_counter()
        for _ in range(TRACE_BLOCKS):
            state, m = prog.simulate(s0, cell.segment_steps)
            host = _host_metrics(m)
            failed += _unconverged(host)
            iters += [{k: float(host[k][i]) for k in ITER_KEYS} for i in range(cell.segment_steps)]
        t_end = time.perf_counter()
    events = prof.events()
    dev = trace.device_events(events)
    host_ev = trace.host_events(events)
    visible_s = trace.union_us((lo, hi) for _, lo, hi in dev) * 1e-6
    names = {}
    for name, (n, us) in trace.by_name(dev).items():
        key = trace.short_name(name)
        c, u = names.get(key, (0, 0.0))
        names[key] = (c + n, u + us)
    hidden_s = sum(trace.gaps_after(dev, WHILE_TEST)) * 1e-6
    ops = [(k, us * 1e-6) for k, (_, us) in names.items()]
    if hidden_s:
        ops.append(("WHILE-body iterations the replay's trace omits (the gaps after the test kernels, "
                    "launch latencies included)", hidden_s))
    ops.sort(key=lambda kv: -kv[1])
    return {
        "window_s": t_end - t_begin,
        "untraced_step_s": untraced_s / (TRACE_BLOCKS * cell.segment_steps),
        "busy_s": visible_s + hidden_s,
        "visible_busy_s": visible_s,
        "hidden_busy_s": hidden_s,
        "while_nodes": prog.loop_nodes(),
        "steps": TRACE_BLOCKS * cell.segment_steps,
        "iters": iters,
        "failed": failed,
        "kernels": {k: {"launches": n, "seconds": us * 1e-6} for k, (n, us) in names.items()},
        "breakdown": {"device_ops": [[k, s] for k, s in ops[:10]],
                      "idle_gaps": trace.idle_gaps(dev, host_ev, busy_after=WHILE_TEST)},
        "last": state,
    }


def checked(prog, ref_side, s0, window_last, cell, seed: int, picks=None) -> tuple:
    """(compared numbers, probe of the reference's cell systems, notes):
    see ``check.py``.  ``picks``: the block's steps the reference repeats
    (None: ``CHECK_STEPS`` of them drawn from the seed, as a run does)."""
    from portbench.program import particles_of, state_parts

    states, metrics = prog.chained(s0, cell.segment_steps)
    last = particles_of(states[-1])
    win = particles_of(window_last)
    repeat = max(check.max_abs(last[k], win[k]) for k in ("x", "v", "c"))
    if picks is None:
        picks = check.sample_steps(seed, cell.segment_steps, min(CHECK_STEPS, cell.segment_steps))
    pairs = [(state_parts(states[k]), particles_of(states[k + 1]), metrics[k]["dt"]) for k in picks]
    first_next, first_m = prog.simulate(prog.scene, 1)
    start = (state_parts(prog.scene), particles_of(first_next), first_m["dt"][0])
    solid_phi = prog.scene.solid.phi
    prog_iters = [{k: int(metrics[k_][k]) for k in ITER_KEYS} for k_ in picks]
    # keep only what the comparison reads, on the host, and free the port's graphs
    def host(d):
        return {k: v.cpu() for k, v in d.items()}

    pairs = [(host(a), host(b), float(dt)) for a, b, dt in pairs]
    start = (host(start[0]), host(start[1]), float(start[2]))
    solid_phi = solid_phi.cpu()
    del states, metrics, first_next, first_m, last, win
    prog.release()

    rows, probes, ref_iters = [], [], []
    for before, after, dt in [start] + pairs:
        out, rdt, rm, probe = ref_side.step(before)
        rows.append(check.step_gaps(after, dt, out, rdt))
        probes.append(probe)
        ref_iters.append({k: int(rm[k]) for k in ITER_KEYS})
    numbers = check.widest(rows)
    numbers["solid_phi_m"] = check.max_abs(ref_side.solid.phi, solid_phi)
    numbers["block_repeat"] = repeat
    live = {}
    for key in ("density_live", "pressure_live"):
        vals = [p[key] for p in probes[1:] if key in p]
        if vals:
            live[key] = statistics.fmean(vals)
    notes = {"steps_checked": picks, "program_iters": prog_iters, "reference_iters": ref_iters[1:],
             "start_step": rows[0], "per_step": rows[1:]}
    return numbers, live, notes


def limits_of(cell) -> dict:
    return dict(cell.limits, block_repeat=0.0)


def is_correct(numbers: dict, limits: dict) -> bool:
    return all(math.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, t0: float, device: str = "cuda",
             root: Path = ROOT) -> dict:
    """One run; the result line's object (see the README)."""
    from portbench.program import Program

    bench = catalog.load_benchmark(root)
    cell = catalog.load_cell(name, root)
    config = catalog.load_config(cell.config, root)
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rb = inputs.body_table(config)
    pos = inputs.particle_positions(config, seed)
    prog = Program(config, cell.viscosity_mode, rb, pos, device)
    s0, _ = prog.simulate(prog.scene, cell.start_steps)
    prog.simulate(s0, cell.segment_steps)  # warm-up: every shape the window uses
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    metrics, extra = {}, {}
    if trace_on:
        tw = traced_window(prog, s0, cell)
        attempted, failed, last = tw["steps"], tw["failed"], tw.pop("last")
    else:
        ww = timed_window(prog, s0, cell, seconds, cuda)
        attempted, failed, last = ww["steps"], ww["failed"], ww["last"]
    peak_bytes = int(torch.cuda.max_memory_allocated()) if cuda else 0

    ref_side = check.Reference(config, cell.viscosity_mode, rb, device)
    numbers, live, notes = checked(prog, ref_side, s0, last, cell, seed)
    limits = limits_of(cell)
    correct = is_correct(numbers, limits)

    device_name = torch.cuda.get_device_name() if cuda else "cpu"
    e2e = {m["name"]: m for m in catalog.cell_metrics(bench, name, "end_to_end")}
    if trace_on:
        ctx = {
            "device_name": device_name, "res": prog.cfg.grid.res, "particles": int(pos.shape[0]),
            "cell_precond": prog.cfg.solver.precond, "viscosity_precond": prog.cfg.solver.viscosity_precond,
            "live": live, **tw,
        }
        for m in catalog.cell_metrics(bench, name, "per_layer"):
            value = catalog.load_metric(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tw["busy_s"], "window_s": tw["window_s"]}
    else:
        values = {
            "steps_per_s": window.rate(ww["steps"], ww["seconds"]),
            "step_ms_p95": window.percentile_nearest_rank(ww["step_ms"], 95),
            "peak_mem_gb": peak_bytes / 1e9,
            "setup_s": setup_s,
        }
        for key, m in e2e.items():
            metrics[key] = {"value": values[key], "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": 1,
                   "memory_peak_bytes": peak_bytes, **extra},
    }
    if trace_on:
        result["breakdown"] = tw["breakdown"]
    result["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    diag = {"seed": seed, "setup_s": setup_s, "live_cells": live, **notes}
    if trace_on:
        diag.update({k: tw[k] for k in ("visible_busy_s", "hidden_busy_s", "while_nodes", "window_s", "busy_s",
                                        "untraced_step_s")})
        diag["kernels"] = dict(sorted(tw["kernels"].items(), key=lambda kv: -kv[1]["seconds"])[:25])
    else:
        diag["window_s"] = ww["seconds"]
        diag["step_ms_quartiles"] = statistics.quantiles(ww["step_ms"], n=4)
        diag["block_ms"] = ww["block_ms"]
    return {"result": result, "diag": diag}


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = catalog.load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    diag = dict(out["diag"], card=power_limit())
    print(json.dumps(diag, default=float), file=sys.stderr)
    for key, row in out["result"]["compared"].items():
        print(f"compared {key} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0
