"""The harness's check on the CPU at a tiny size: a sound run comes out
correct; with the timed path broken underneath (the port's step swapped
for a faulty one), or with the lower-precision control in the program's
place, it comes out not correct."""

import time

import pytest
import torch
from _tiny import write_tiny

from portbench import catalog, check, harness
from portbench.control import control_readings
from python_fluid_simulation_tpu_torch.engine import step as step_mod
from python_fluid_simulation_tpu_torch.state import Particles, SimState


def _run(root):
    return harness.run_cell("tiny.apic", 2**31 + 11, 0.2, False, time.perf_counter(), device="cpu", root=root)


def _unchanged(state, out):
    return SimState(particles=state.particles, solid=out.solid, t=out.t, step_idx=out.step_idx,
                    visc_mg=out.visc_mg)


def _half_left_out(state, out):
    n = state.particles.x.shape[0] // 2
    p, q = state.particles, out.particles
    keep = torch.arange(q.x.shape[0]) < n
    pick = lambda new, old: torch.where(keep.reshape(-1, *([1] * (new.ndim - 1))), new, old)  # noqa: E731
    return SimState(particles=Particles(pick(q.x, p.x), pick(q.v, p.v), pick(q.c, p.c), q.m), solid=out.solid,
                    t=out.t, step_idx=out.step_idx, visc_mg=out.visc_mg)


def _answer_altered(state, out):
    v = out.particles.v.clone()
    v[len(v) // 3, 1] += 1e-3
    p = out.particles
    return SimState(particles=Particles(p.x, v, p.c, p.m), solid=out.solid, t=out.t, step_idx=out.step_idx,
                    visc_mg=out.visc_mg)


def test_a_sound_run_is_correct(tmp_path):
    torch.set_num_threads(1)
    out = _run(write_tiny(tmp_path))
    r = out["result"]
    assert r["correct"] is True and r["attempted"] >= 4 and r["failed"] == 0
    assert list(r)[-1] == "compared" and r["compared"]["block_repeat"]["limit"] == 0.0
    assert set(r["metrics"]) == {"steps_per_s", "step_ms_p95", "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered],
                         ids=["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    torch.set_num_threads(1)
    sound = step_mod.step_3d

    def broken(state, cfg, *args, **kw):
        out, m = sound(state, cfg, *args, **kw)
        return fault(state, out), m

    monkeypatch.setattr(step_mod, "step_3d", broken)
    out = _run(write_tiny(tmp_path))
    assert out["result"]["correct"] is False


def test_the_control_is_not_correct(tmp_path):
    torch.set_num_threads(1)
    root = write_tiny(tmp_path)
    cell = catalog.load_cell("tiny.apic", root)
    config = catalog.load_config("tiny", root)
    got = control_readings(cell, config, 7, "cpu")
    numbers = check.widest([got["start"], *[{k: v for k, v in row.items() if k != "step"} for row in got["steps"]]])
    numbers.update(solid_phi_m=got["solid_phi_m"], block_repeat=0.0)
    assert not harness.is_correct(numbers, harness.limits_of(cell))


def test_a_window_that_drops_a_step_is_not_correct(tmp_path, monkeypatch):
    """The window's blocks run one step fewer than they count while single
    steps (the check's chain) stay sound: only ``block_repeat`` sees it."""
    from portbench import program

    torch.set_num_threads(1)
    sound = program.simulate

    def short(state, cfg, steps, **kw):
        return sound(state, cfg, steps - 1 if steps > 1 else steps, **kw)

    monkeypatch.setattr(program, "simulate", short)
    r = _run(write_tiny(tmp_path))["result"]
    assert r["correct"] is False and r["compared"]["block_repeat"]["value"] > 0
