#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``python_fluid_simulation_tpu_torch`` (never JAX) through its main
path — the 48x80x48 buckling funnel (``buckling_config()`` defaults,
89,648 particles, 'apic' viscosity, CFL dt, Jacobi PCG, static solids) —
and checks every CUDA kernel of that path against its plain PyTorch
version on the card.  Phases, each printing one JSON line:

  device   the card (and its ``nvidia-smi`` name / power limit)
  build    one nvcc call over csrc/*.cu, with ptxas' register lines
  kernels  each kernel on the real density / pressure / viscosity
           systems of the third flagship step vs its plain version:
           errors, iterations, CUDA-event times, the bound from bytes
           and operations
  main     1 warm-up + 10 timed steps with the launch counters reset
           just before; solves converged, particles finite, and steps
           1-3 on the card each vs the same step on the CPU from the
           same state

The last lines are the ``nvidia-smi`` line, a ``{"kernels": [...]}``
line, and ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before any
result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
# fp32 operations a cell / a face does per PCG iteration (matvec, two
# dots, three vector updates, the Jacobi divide), counted from the
# kernels' arithmetic
CELL_OPS_PER_ITER = 27
FACE_OPS_PER_ITER = 85
KERNEL_TOL = dict(rtol=2e-3, atol=2e-4)  # solution vs plain version
MATVEC_TOL = dict(rtol=1e-5, atol=1e-6)  # coupled matvec vs plain version
# card step vs the port's CPU step from the same state: fp32 rounding of
# differently ordered sums, as between the port and the JAX package on the
# CPU (tests/test_torch_step.py); measured well inside on the H100
STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
CHECKED_STEPS = (0, 1, 2)  # step 0 solves no viscosity; 1 and 2 do


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms of `fn()` over `reps` calls between CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def capture_systems(step_3d, state, cfg, geom):
    """Run one step with recorders around the two kernel wrappers as the
    solver modules call them; returns the captured solver inputs."""
    from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

    captured = {"cell": [], "coupled": []}
    orig_cell, orig_coupled = pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg

    def rec_cell(*args, **kw):
        captured["cell"].append((args, kw))
        return orig_cell(*args, **kw)

    def rec_coupled(*args, **kw):
        captured["coupled"].append((args, kw))
        return orig_coupled(*args, **kw)

    pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg = rec_cell, rec_coupled
    try:
        step_3d(state, cfg, geom=geom)
    finally:
        pressure.cell_poisson_pcg, viscosity.coupled_visc_pcg = orig_cell, orig_coupled
    return captured


def max_err(a, b):
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


def check_close(name, got, ref, tol):
    import torch

    if not torch.allclose(got, ref, **tol):
        d, rel = max_err(got, ref)
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs {d}, rel {rel}, tol {tol})")


def cell_kernel_phase(systems):
    """Cell-Poisson PCG on the density and pressure systems."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_stencils import (
        cell_poisson_pcg,
        cell_poisson_pcg_plain,
    )

    rows = []
    for label, (args, kw) in zip(("density", "pressure"), systems):
        b, diag, coefs, pd = args
        x_k, it_k, res_k, _, _ = cell_poisson_pcg(*args, **kw)
        repeatable = bool(torch.equal(x_k, cell_poisson_pcg(*args, **kw)[0]))
        x_p, it_p, res_p, _, _ = cell_poisson_pcg_plain(*args, **kw)
        check_close(f"cell_poisson_pcg[{label}]", x_k, x_p, KERNEL_TOL)
        if abs(int(it_k) - int(it_p)) > 2:
            raise AssertionError(f"cell_poisson_pcg[{label}]: iterations {int(it_k)} vs plain {int(it_p)}")
        ms = cuda_time_ms(lambda: cell_poisson_pcg(*args, **kw), 20)
        plain_ms = cuda_time_ms(lambda: cell_poisson_pcg_plain(*args, **kw), 2)
        n = b.numel()
        nbytes = (9 + 1) * n * 4  # b, diag, 6 coefs, pd read once; x written once
        ops = (int(it_k) * CELL_OPS_PER_ITER + 4) * n
        err, rel = max_err(x_k, x_p)
        rows.append(dict(
            system=label, shape=list(b.shape), iters=int(it_k), plain_iters=int(it_p),
            res=float(res_k), plain_res=float(res_p), max_abs_err=err, max_rel_err=rel,
            bitwise_repeatable=repeatable, ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
            bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
        ))
    return rows


def coupled_kernel_phase(system):
    """Coupled viscosity PCG (and its matvec) on the viscosity system."""
    import torch

    from python_fluid_simulation_tpu_torch.ops.cuda_cg import (
        SPHI_CLASSES,
        VOL_CLASSES,
        coupled_visc_pcg,
        coupled_visc_pcg_plain,
    )

    (b, x0, pd, sphi_c, vol_c, s_mu), kw = system
    # matvec: with b = 0 and max_iter = 0 the final residual is -A x0
    zeros = tuple(torch.zeros_like(t) for t in b)
    mv_kw = dict(kw, max_iter=0)
    *_, r_k = coupled_visc_pcg(zeros, x0, pd, sphi_c, vol_c, s_mu, **mv_kw)
    *_, r_p = coupled_visc_pcg_plain(zeros, x0, pd, sphi_c, vol_c, s_mu, **mv_kw)
    mv_err = 0.0
    for a in range(3):
        check_close(f"coupled matvec[{a}]", r_k[a], r_p[a], MATVEC_TOL)
        mv_err = max(mv_err, max_err(r_k[a], r_p[a])[0])

    x_k, it_k, res_k, *_ = coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw)
    x_k2 = coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw)[0]
    repeatable = all(bool(torch.equal(u, w)) for u, w in zip(x_k, x_k2))
    x_p, it_p, res_p, *_ = coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, **kw)
    err = rel = 0.0
    for a in range(3):
        check_close(f"coupled_visc_pcg[{a}]", x_k[a], x_p[a], KERNEL_TOL)
        e, r = max_err(x_k[a], x_p[a])
        err, rel = max(err, e), max(rel, r)
    if abs(int(it_k) - int(it_p)) > 2:
        raise AssertionError(f"coupled_visc_pcg: iterations {int(it_k)} vs plain {int(it_p)}")
    ms = cuda_time_ms(lambda: coupled_visc_pcg(b, x0, pd, sphi_c, vol_c, s_mu, **kw), 20)
    plain_ms = cuda_time_ms(lambda: coupled_visc_pcg_plain(b, x0, pd, sphi_c, vol_c, s_mu, **kw), 2)
    n = sum(t.numel() for t in b)
    n_geom = sum(vol_c[c].numel() for c in VOL_CLASSES) + sum(sphi_c[c].numel() for c in SPHI_CLASSES)
    nbytes = (3 * n + n + n_geom) * 4  # b, x0, pd and geometry read once; x written once
    ops = (int(it_k) * FACE_OPS_PER_ITER + FACE_OPS_PER_ITER) * n
    return dict(
        system="viscosity", shapes=[list(t.shape) for t in b], iters=int(it_k),
        plain_iters=int(it_p), res=float(res_k), plain_res=float(res_p),
        max_abs_err=err, max_rel_err=rel, matvec_max_abs_err=mv_err, bitwise_repeatable=repeatable,
        ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops,
        bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_OPS_PER_S * 1e3,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script only runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, step_3d
    from python_fluid_simulation_tpu_torch.ops import _cuda_build, cuda_cg, cuda_stencils

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    # -- device
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})

    # -- build: one nvcc call over every csrc/*.cu
    t0 = time.perf_counter()
    info = _cuda_build.build()
    _cuda_build.LIB.get()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "ptxas info" in ln and ("registers" in ln or "Compiling entry" in ln or "spill" in ln)
             or "bytes stack frame" in ln]
    emit({"phase": "build", "nvcc_seconds": info.seconds, "cached": info.cached,
          "sources": [p.name for p in _cuda_build.sources()], "ptxas": ptxas,
          "seconds": time.perf_counter() - t0})

    # -- kernels on the real systems of a flagship step
    t0 = time.perf_counter()
    cfg = buckling_config()
    state0 = buckling_scene(cfg, seed=0, device="cuda")
    n_particles = int(state0.particles.x.shape[0])
    if cfg.grid.res != (48, 80, 48) or n_particles != 89648:
        raise AssertionError(f"unexpected flagship: grid {cfg.grid.res}, {n_particles} particles")
    geom = build_geom_cache(state0.solid)
    # the first steps start from rest (the viscosity solve exits at once),
    # so the systems are taken from the third step
    state2 = state0
    for _ in range(2):
        state2, _ = step_3d(state2, cfg, geom=geom)
    captured = capture_systems(step_3d, state2, cfg, geom)
    del state2
    if len(captured["cell"]) != 2 or len(captured["coupled"]) != 1:
        raise AssertionError(f"expected 2 cell solves and 1 coupled solve, got {len(captured['cell'])}, {len(captured['coupled'])}")
    cell_rows = cell_kernel_phase(captured["cell"])
    coupled_row = coupled_kernel_phase(captured["coupled"][0])
    del captured
    emit({"phase": "kernels", "cell_poisson_pcg": cell_rows, "coupled_visc_pcg": coupled_row,
          "seconds": time.perf_counter() - t0})

    # -- main path: launch counts reset just before, read just after
    t0 = time.perf_counter()
    cuda_stencils.cell_poisson_pcg.launches = 0
    cuda_cg.coupled_visc_pcg.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = state0
    states = [state0]  # the states around the checked steps
    step_ms, metrics = [], []
    for _ in range(11):
        ts = time.perf_counter()
        state, m = step_3d(state, cfg, geom=geom)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if len(states) <= max(CHECKED_STEPS) + 1:
            states.append(state)
        metrics.append({k: v.item() for k, v in m.items()})
    launches = {"cell_poisson_pcg": cuda_stencils.cell_poisson_pcg.launches,
                "coupled_visc_pcg": cuda_cg.coupled_visc_pcg.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    for k in ("x", "v", "c"):
        if not torch.isfinite(getattr(state.particles, k)).all():
            raise AssertionError(f"non-finite particle {k} after 11 steps")
    for i, m in enumerate(metrics):
        for solver in ("density", "viscosity", "pressure"):
            if not m[f"{solver}_converged"]:
                raise AssertionError(f"step {i}: {solver} solve did not converge: {m}")

    # reported, not asserted: the first step again, bit for bit
    first = state_to_numpy(states[1])
    again, _ = step_3d(state0, cfg, geom=geom)
    step_repeatable = all(bool((getattr(again.particles, k).cpu().numpy() == first[k]).all()) for k in ("x", "v", "c"))

    # each checked step on the card vs the same step on the CPU (plain
    # versions) from the card's state before it
    tc = time.perf_counter()
    step_err = {}
    for i in CHECKED_STEPS:
        cpu_state, _ = step_3d(state_from_numpy(state_to_numpy(states[i]), device="cpu"), cfg)
        cpu, card = state_to_numpy(cpu_state), state_to_numpy(states[i + 1])
        step_err[i] = {k: float(abs(card[k] - cpu[k]).max()) for k in STEP_TOL}
        for k, tol in STEP_TOL.items():
            if not step_err[i][k] <= tol:
                raise AssertionError(f"step {i} on the card vs CPU: max |d{k}| {step_err[i][k]} > {tol}")
    cpu_seconds = time.perf_counter() - tc
    del states
    timed = step_ms[1:]
    emit({"phase": "main", "grid": list(cfg.grid.res), "particles": n_particles,
          "warmup_step_ms": step_ms[0], "step_ms": timed, "median_step_ms": statistics.median(timed),
          "iters": {s: [m[f"{s}_iters"] for m in metrics] for s in ("density", "viscosity", "pressure")},
          "launches": launches, "max_memory_allocated": peak,
          "first_step_bitwise_repeatable": step_repeatable,
          "cpu_steps_seconds": cpu_seconds, "card_vs_cpu_by_step": step_err, "step_tol": STEP_TOL,
          "seconds": time.perf_counter() - t0})

    # -- summary: the nvidia-smi line, the kernels line, then the result
    def entry(name, source, replaces, row, n):
        bound = max(row["bytes_ms"], row["ops_ms"])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": bound,
                "bound_by": "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations",
                "library_ms": None}

    # the cell kernel is timed on the pressure system; its error is the
    # larger of the density and pressure systems'
    pres = dict(cell_rows[1], max_abs_err=max(r["max_abs_err"] for r in cell_rows))
    kernels = [
        entry("cell_poisson_pcg", "python_fluid_simulation_tpu_torch/csrc/cell_poisson_pcg.cu",
              "python_fluid_simulation_tpu/ops/pallas_stencils.py:125", pres,
              launches["cell_poisson_pcg"]),
        entry("coupled_visc_pcg", "python_fluid_simulation_tpu_torch/csrc/coupled_visc_pcg.cu",
              "python_fluid_simulation_tpu/ops/pallas_cg.py:673", coupled_row,
              launches["coupled_visc_pcg"]),
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
