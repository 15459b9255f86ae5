"""The frozen plain reference against the port's plain step (the port's
CPU route) on coarse scenes, held to the port's step tolerances
(``tests/test_torch_step.py``'s STEP_TOL)."""

import dataclasses

import pytest
import torch

from portbench.reference import config as rconfig
from portbench.reference import state as rstate
from portbench.reference.engine.step import step_3d as ref_step
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene, scaled_buckling_config
from python_fluid_simulation_tpu_torch.engine.step import step_3d

TOL = {"x": 1e-5, "v": 1e-4, "c": 1e-3}


def reference_step_of(state, cfg, low=None):
    """The reference's step from the port's state and config, and its
    probe of the cell systems' live cells."""
    p, s = state.particles, state.solid
    ref_state = rstate.SimState(rstate.Particles(p.x, p.v, p.c, p.m), rstate.SolidState(s.phi, s.v, s.rb),
                                state.t, state.step_idx, state.visc_mg)
    probe = {}
    out, m = ref_step(ref_state, rconfig.SimConfig.from_json(cfg.to_json()), low=low, probe=probe)
    return (out, m), probe


def _mg(cfg):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="mg"))


@pytest.mark.parametrize("label", ["jacobi", "mg"])
def test_reference_steps_match_the_ports_plain_steps(label):
    torch.set_num_threads(1)
    cfg = buckling_config(dx=0.05) if label == "jacobi" else _mg(scaled_buckling_config(24))
    state = buckling_scene(cfg, device="cpu")
    for _ in range(3):
        nxt, m = step_3d(state, cfg)
        (ref, rm), probe = reference_step_of(state, cfg)
        for k, tol in TOL.items():
            got, want = getattr(nxt.particles, k), getattr(ref.particles, k)
            assert float((got - want).abs().max()) <= tol, k
        for k in ("density_iters", "viscosity_iters", "pressure_iters", "dt"):
            assert float(m[k]) == float(rm[k]), k
        assert ("density_live" in probe) == (label == "jacobi")
        state = nxt


def test_lower_precision_control_moves_the_step():
    torch.set_num_threads(1)
    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    for _ in range(2):
        state, _ = step_3d(state, cfg)
    (good, _), _ = reference_step_of(state, cfg)
    (bad, _), _ = reference_step_of(state, cfg, low=torch.bfloat16)
    assert float((good.particles.x - bad.particles.x).abs().max()) > 10 * TOL["x"]
