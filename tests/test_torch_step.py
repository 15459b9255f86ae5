"""The PyTorch port's whole step against the JAX package, on CPU.

* ``buckling_scene`` at the flagship dx seeds exactly the JAX scene's
  89,648 particles at the same positions (same numpy generator).
* 2 steps of ``step_3d`` on the buckling funnel cut to dx = 0.05
  (12x20x12 cells) against the JAX ``simulate``: the solves agree to
  their tolerance and the particle state to fp32 rounding carried
  through two steps (x atol 1e-5 m, v atol 1e-4 m/s, APIC rows atol
  1e-3 1/s on entries up to ~2).
* the same 2 steps with ``dt_mode='fixed'`` (the configured dt, no CFL),
  and with ``precond='mg'`` (the MG-PCG cell solves of the 128^3-class
  configuration) at the same tolerances; on CPU tensors no kernel
  wrapper counts a launch.
* ``scaled_buckling_config(r)`` equals the JAX configuration field for
  field.
* unported options (preconditioners the port does not have) raise
  NotImplementedError (moving solids are ported:
  ``tests/test_torch_moving_solid.py``); the viscosity MG route
  above 4M face cells (the lean two-grid route) runs.
* the 6-step dam break against ``tests/golden_dam_break.npz`` at
  test_golden.py's config and tolerances.
"""

import os

import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import (
    buckling_config,
    buckling_scene,
    dam_break_scene,
    scaled_buckling_config,
)
from python_fluid_simulation_tpu_torch.engine.step import simulate, step_3d

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_dam_break.npz")


def test_flagship_scene_matches_jax_exactly():
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene

    cfg = buckling_config()
    assert cfg.grid.res == (48, 80, 48) and cfg.grid.dual_res == (97, 161, 97)
    state = buckling_scene(cfg, device="cpu")
    want = j_scene(j_cfg())
    x = state.particles.x.numpy()
    assert x.shape == (89648, 3)
    np.testing.assert_array_equal(x, np.asarray(want.particles.x))
    np.testing.assert_array_equal(state.particles.m.numpy(), np.asarray(want.particles.m))
    np.testing.assert_array_equal(state.solid.rb.numpy(), np.asarray(want.solid.rb))
    np.testing.assert_allclose(state.solid.phi.numpy(), np.asarray(want.solid.phi), atol=1e-6)


def _coarse_pair(dt_mode, precond="jacobi"):
    """2 steps of the coarse buckling scene through both packages from
    the same start state."""
    import dataclasses

    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    def with_precond(c):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, precond=precond))

    j_state = j_scene(j_cfg(dx=0.05))
    j_final, j_metrics = j_simulate(j_state, with_precond(j_cfg(dx=0.05, dt_mode=dt_mode)), 2)
    cfg = with_precond(buckling_config(dx=0.05, dt_mode=dt_mode))
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    final, metrics = simulate(state, cfg, 2)
    return j_final, j_metrics, final, metrics


@pytest.fixture(scope="module")
def coarse_pair():
    return _coarse_pair("cfl")


def test_two_coarse_steps_match_jax(coarse_pair):
    j_final, j_metrics, final, metrics = coarse_pair
    assert final.particles.x.shape == (1424, 3)
    for solver in ("density", "viscosity", "pressure"):
        got = metrics[f"{solver}_iters"].numpy()
        want = np.asarray(j_metrics[f"{solver}_iters"])
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)
        assert metrics[f"{solver}_converged"].all()
    assert metrics["viscosity_iters"][1] > 0  # the second step really solves
    np.testing.assert_allclose(metrics["dt"].numpy(), np.asarray(j_metrics["dt"]), rtol=1e-6)
    np.testing.assert_allclose(final.particles.x.numpy(), np.asarray(j_final.particles.x), atol=1e-5)
    np.testing.assert_allclose(final.particles.v.numpy(), np.asarray(j_final.particles.v), atol=1e-4)
    np.testing.assert_allclose(final.particles.c.numpy(), np.asarray(j_final.particles.c), atol=1e-3)
    assert float(final.t) == pytest.approx(float(j_final.t), rel=1e-6)
    assert int(final.step_idx) == 2 and int(final.visc_mg) == int(j_final.visc_mg)


def test_fixed_dt_steps_match_jax(coarse_pair):
    """dt_mode='fixed' takes the configured dt (1/300 s) every step.  In
    this scene the CFL dt is 1/300 s too, so the port's fixed run must be
    bitwise its CFL run.  Against the JAX fixed run: x and v at the CFL
    test's tolerances; APIC rows at atol 5e-3, because the JAX package's
    own fixed and CFL runs (same float32 dt) already differ by 3.6e-3 on
    a few of these entries (XLA folds the literal dt differently)."""
    j_final, j_metrics, final, metrics = _coarse_pair("fixed")
    np.testing.assert_array_equal(metrics["dt"].numpy(), np.float32(1.0 / 300.0))
    np.testing.assert_array_equal(np.asarray(j_metrics["dt"]), np.float32(1.0 / 300.0))
    cfl_final, cfl_metrics = coarse_pair[2], coarse_pair[3]
    for k, v in state_to_numpy(final).items():
        np.testing.assert_array_equal(v, state_to_numpy(cfl_final)[k], err_msg=k)
    for solver in ("density", "viscosity", "pressure"):
        got = metrics[f"{solver}_iters"].numpy()
        np.testing.assert_array_equal(got, cfl_metrics[f"{solver}_iters"].numpy())
        want = np.asarray(j_metrics[f"{solver}_iters"])
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)
    np.testing.assert_allclose(final.particles.x.numpy(), np.asarray(j_final.particles.x), atol=1e-5)
    np.testing.assert_allclose(final.particles.v.numpy(), np.asarray(j_final.particles.v), atol=1e-4)
    np.testing.assert_allclose(final.particles.c.numpy(), np.asarray(j_final.particles.c), atol=5e-3)
    assert float(final.t) == pytest.approx(2.0 / 300.0, rel=1e-6)


def _launch_counts():
    from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_cg, cuda_fold, cuda_mg, cuda_scan, cuda_stencils

    return [f.launches for f in (
        cuda_stencils.cell_poisson_pcg, cuda_stencils.stencil_matvec, cuda_cg.coupled_visc_pcg,
        cuda_cg.coupled_matvec_geom, cuda_mg.vcycle_tail, cuda_binned.serial_reduce, cuda_scan.seg_scan_sorted,
        cuda_binned.place_live, cuda_binned.segment_broadcast, cuda_fold.fold,
    )]


def test_mg_steps_match_jax():
    """precond='mg' (both cell solves through the V-cycle-preconditioned
    CG) on the coarse scene: at the CFL test's tolerances, with the
    cell solves needing fewer iterations than Jacobi."""
    before = _launch_counts()
    j_final, j_metrics, final, metrics = _coarse_pair("cfl", precond="mg")
    assert _launch_counts() == before  # CPU tensors launch no kernel
    for solver in ("density", "viscosity", "pressure"):
        got = metrics[f"{solver}_iters"].numpy()
        want = np.asarray(j_metrics[f"{solver}_iters"])
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)
        assert metrics[f"{solver}_converged"].all()
    assert metrics["pressure_iters"][1] > 0
    np.testing.assert_allclose(final.particles.x.numpy(), np.asarray(j_final.particles.x), atol=1e-5)
    np.testing.assert_allclose(final.particles.v.numpy(), np.asarray(j_final.particles.v), atol=1e-4)
    np.testing.assert_allclose(final.particles.c.numpy(), np.asarray(j_final.particles.c), atol=1e-3)


@pytest.mark.parametrize("res", [64, 128, 256])
def test_scaled_buckling_config_matches_jax(res):
    import dataclasses

    from python_fluid_simulation_tpu.engine.scenes import scaled_buckling_config as j_scaled

    got, want = scaled_buckling_config(res), j_scaled(res)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.solver.precond == {64: "jacobi", 128: "mg", 256: "jacobi"}[res]
    if res == 128:
        assert got.grid.res == (77, 128, 77)


def test_step_is_deterministic_and_state_roundtrips():
    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    a, _ = step_3d(state, cfg)
    b, _ = step_3d(state_from_numpy(state_to_numpy(state), device="cpu"), cfg)
    for k, v in state_to_numpy(a).items():
        np.testing.assert_array_equal(v, state_to_numpy(b)[k])


def test_unported_options_raise():
    import dataclasses

    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    for bad in (
        dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="ic")),
        dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_precond="ic")),
    ):
        with pytest.raises(NotImplementedError):
            step_3d(state, bad)


@pytest.mark.parametrize("viscosity_precond", ["mg", "auto"])
def test_viscosity_mg_above_4m_face_cells_raises(viscosity_precond, monkeypatch):
    """The viscosity MG route above 4M face cells (the JAX package's lean
    two-grid route, refused by the port before it was ported) raises
    nothing now: the step accepts ``scaled_buckling_config(256)`` (a
    154x256x154 grid, 6.1M face cells an axis) with an MG viscosity
    preconditioner, and the MG solve takes the lean preconditioner
    exactly above ``viscosity.MG_FACE_CELLS`` face cells of axis 0 (shown
    on 2 coarse coiling steps, 6x24x6 cells, with the switch set just
    below and at their 1,008 face cells)."""
    import dataclasses

    from python_fluid_simulation_tpu_torch.engine.scenes import coiling_config, coiling_scene
    from python_fluid_simulation_tpu_torch.engine.step import _check_supported
    from python_fluid_simulation_tpu_torch.solvers import viscosity

    def with_precond(c):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, viscosity_precond=viscosity_precond))

    _check_supported(with_precond(scaled_buckling_config(256)))
    cfg = with_precond(coiling_config(24))
    state = dataclasses.replace(coiling_scene(cfg, device="cpu"), visc_mg=2)
    built = []
    for name in ("make_viscosity_mg_preconditioner_lean", "make_viscosity_mg_preconditioner"):
        fn = getattr(viscosity, name)
        monkeypatch.setattr(viscosity, name, lambda *a, _fn=fn, _name=name, **kw: built.append(_name) or _fn(*a, **kw))
    face_cells = 7 * 24 * 6
    for switch, want in ((face_cells - 1, "make_viscosity_mg_preconditioner_lean"),
                         (face_cells, "make_viscosity_mg_preconditioner")):
        built.clear()
        monkeypatch.setattr(viscosity, "MG_FACE_CELLS", switch)
        _, metrics = simulate(state, cfg, 2)
        assert built == [want, want], (switch, built)
        assert metrics["viscosity_converged"].all()


def test_dam_break_golden():
    """test_golden.py's scene, config and tolerances, run by the port."""
    cfg = SimConfig(
        grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 12),
        physics=PhysicsConfig(rho=1000.0, mu=0.5, dt=1.0 / 60.0),
        solver=SolverConfig(max_iter=400, pallas="off"),
        particle_dx=1.0 / 24,
        dt_mode="cfl",
        duration=10.0,
    )
    final, _ = simulate(dam_break_scene(cfg, seed=3, device="cpu"), cfg, 6)
    ref = np.load(GOLDEN)
    np.testing.assert_allclose(final.particles.x.numpy(), ref["x"], atol=2e-3)
    np.testing.assert_allclose(final.particles.v.numpy(), ref["v"], atol=5e-2)
    np.testing.assert_allclose(float(final.t), float(ref["t"]), rtol=1e-5)
