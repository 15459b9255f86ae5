"""The reference's unpreconditioned CG (``jacobi_precond=False``), the
dt-scaled pressure assembly and the prepared-matvec APIs of the PyTorch
port against the JAX package, on CPU.

* Row 5 (``make_stencil_matvec``): `prepare_pressure_matvec` and
  `prepare_density_matvec` against the JAX functions with
  ``use_pallas="on"`` (the Pallas kernel in interpret mode) and ``"off"``
  at test_pallas.py's size and tolerance (rtol = atol = 1e-5, fp32
  products summed in another order); diagonals equal.
* Rows 7-8 (``make_blocked_coupled_matvec``, ``make_coupled_stencil_
  matvec``): `prepare_viscosity_matvec` against ``use_pallas`` "on",
  "blocked" and "off" at test_pallas.py's two sizes and tolerance; the
  preconditioner diagonals equal; the plain version of the kernel
  bitwise the port's `viscosity_matvec_3d` and geometry matvec.
* The unit matvecs and diagonals of the pressure and density systems
  against JAX: rtol = atol = 1e-5 and equal.
* The solves with the new options on a small dam break: iterations
  equal, solutions at tests/test_torch_solvers.py's SOLVE_TOL; the
  unpreconditioned cell solve within 3 iterations (see its test).
* 3 coarse buckling steps (12x20x12 cells) with ``jacobi_precond=False``
  and with ``pressure_dt_scaled=True`` against JAX ``simulate``, at
  tests/test_torch_step.py's bounds (iterations within 2; x atol 1e-5 m,
  v 1e-4 m/s, APIC rows 1e-3 1/s).
* The slice at full width: one flagship step (48x80x48, 89,648
  particles) with ``jacobi_precond=False`` from the JAX state after one
  such step, with tests/test_torch_flagship.py's exact-sum patch of the
  JAX package's CPU segment sums applied inside the test.  x and v
  within 1e-5 m / 1e-4 m/s (tests/test_torch_flagship.py's bounds);
  iterations as close as the port is to itself with its dot products
  summed in float64, and APIC rows as close at every particle whose G2P
  home cell both packages decide alike; a particle decided apart sits on
  a face plane and is held to a float64 G2P from its home cell (see the
  test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.ops.fractions import compute_solid_frac_3d as j_frac
from python_fluid_simulation_tpu.ops.indexing import split_parity as j_split
from python_fluid_simulation_tpu.solvers import density as jden
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu.solvers import viscosity as jvis
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config
from python_fluid_simulation_tpu_torch.engine.step import simulate
from python_fluid_simulation_tpu_torch.ops import cuda_cg, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_3d
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import density, pressure, viscosity
from tests.test_torch_parity_decisions import FACE_BIAS, _g2p_f64
from tests.test_torch_solvers import SOLVE_TOL, _as, _fluid_state, _t

torch.set_num_threads(1)

MATVEC_TOL = dict(rtol=1e-5, atol=1e-5)  # test_pallas.py's
STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
N = (8, 10, 12)  # test_pallas.py's sizes
N_BLOCKED = (11, 7, 9)


def _shapes(n):
    return [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]


def _cell_geom(seed=0, n=N):
    rng = np.random.default_rng(seed)
    sphi = rng.standard_normal(tuple(2 * k + 1 for k in n)).astype(np.float32)
    lphi = rng.standard_normal(n).astype(np.float32)
    p = rng.standard_normal(n).astype(np.float32)
    return sphi, lphi, p


def _launches():
    return (cuda_stencils.stencil_matvec.launches, cuda_stencils.coupled_stencil_matvec.launches)


@pytest.mark.parametrize("use_pallas", ["on", "off"])
@pytest.mark.parametrize("system", ["pressure", "density", "density_wz_bug"])
def test_prepared_cell_matvec_matches_jax(system, use_pallas):
    """Row 5: the prepared matvec is `stencil_matvec` on the system's
    fields; the geometry form of the matvec agrees too."""
    sphi, lphi, p = _cell_geom()
    w_j, w_t = j_frac(jnp.asarray(sphi)), compute_solid_frac_3d(_t(sphi))
    before = _launches()
    if system == "pressure":
        mv_j, d_j = jpr.prepare_pressure_matvec(w_j, jnp.asarray(lphi), use_pallas=use_pallas)
        mv_t, d_t = pressure.prepare_pressure_matvec(w_t, _t(lphi))
        unit = pressure.pressure_matvec_3d(_t(p), w_t, _t(lphi))
    else:
        bug = system == "density_wz_bug"
        mv_j, d_j = jden.prepare_density_matvec(w_j, jnp.asarray(lphi), wz_bug=bug, use_pallas=use_pallas)
        mv_t, d_t = density.prepare_density_matvec(w_t, _t(lphi), wz_bug=bug)
        unit = density.density_matvec(_t(p), w_t, _t(lphi), wz_bug=bug)
    q_t = mv_t(_t(p))
    assert _launches() == before  # CPU tensors launch no kernel
    np.testing.assert_allclose(q_t.numpy(), np.asarray(mv_j(jnp.asarray(p))), **MATVEC_TOL)
    np.testing.assert_allclose(q_t.numpy(), unit.numpy(), **MATVEC_TOL)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("unit_diag_weight", [False, True])
def test_pressure_unit_matvec_and_diag_match_jax(unit_diag_weight):
    sphi, lphi, p = _cell_geom(3)
    w_j, w_t = j_frac(jnp.asarray(sphi)), compute_solid_frac_3d(_t(sphi))
    want = jpr.pressure_matvec_3d(jnp.asarray(p), w_j, jnp.asarray(lphi), unit_diag_weight)
    got = pressure.pressure_matvec_3d(_t(p), w_t, _t(lphi), unit_diag_weight)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATVEC_TOL)
    np.testing.assert_array_equal(
        pressure.pressure_diag_3d(w_t, _t(lphi), unit_diag_weight).numpy(),
        np.asarray(jpr.pressure_diag_3d(w_j, jnp.asarray(lphi), unit_diag_weight)),
    )
    # the weighted coefficients and the unit diagonal make the density system
    d_t, c_t, pd_t = pressure.pressure_coefficients(w_t, _t(lphi), unit_diag_weight)
    d_j, c_j, pd_j = jpr.pressure_coefficients(w_j, jnp.asarray(lphi), unit_diag_weight)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(pd_t.numpy(), np.asarray(pd_j))
    for (o_t, x_t), (o_j, x_j) in zip(c_t, c_j):
        assert o_t == tuple(o_j)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))


@pytest.mark.parametrize("wz_bug", [False, True])
def test_density_unit_matvec_and_diag_match_jax(wz_bug):
    sphi, lphi, p = _cell_geom(4)
    w_j, w_t = j_frac(jnp.asarray(sphi)), compute_solid_frac_3d(_t(sphi))
    want = jden.density_matvec(jnp.asarray(p), w_j, jnp.asarray(lphi), wz_bug)
    got = density.density_matvec(_t(p), w_t, _t(lphi), wz_bug)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MATVEC_TOL)
    np.testing.assert_array_equal(density.density_diag(_t(lphi)).numpy(), np.asarray(jden.density_diag(jnp.asarray(lphi))))


def _visc_system(n, seed):
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in n)
    sphi = rng.standard_normal(dual).astype(np.float32)
    vol = rng.random(dual).astype(np.float32)
    v = [rng.standard_normal(s).astype(np.float32) for s in _shapes(n)]
    return sphi, vol, v


@pytest.mark.parametrize("use_pallas", ["on", "blocked", "off"])
@pytest.mark.parametrize("n, seed", [(N, 1), (N_BLOCKED, 8)])
def test_prepared_viscosity_matvec_matches_jax(n, seed, use_pallas):
    """Rows 7 and 8: the prepared matvec (`coupled_stencil_matvec` on
    the 45 term fields) against both TPU kernels (interpret mode) and
    the XLA route."""
    sphi, vol, v = _visc_system(n, seed)
    s_mu = np.float32(0.3)
    mv_j, pd_j = jvis.prepare_viscosity_matvec(
        jnp.float32(s_mu), j_split(jnp.asarray(sphi), 3), j_split(jnp.asarray(vol), 3), _shapes(n),
        use_pallas=use_pallas,
    )
    mv_t, pd_t = viscosity.prepare_viscosity_matvec(
        torch.tensor(s_mu), split_parity(_t(sphi), 3), split_parity(_t(vol), 3), _shapes(n),
    )
    before = _launches()
    q_t = mv_t(tuple(_t(x) for x in v))
    assert _launches() == before
    q_j = mv_j(tuple(jnp.asarray(x) for x in v))
    for a in range(3):
        np.testing.assert_allclose(q_t[a].numpy(), np.asarray(q_j[a]), **MATVEC_TOL)
        np.testing.assert_array_equal(pd_t[a].numpy(), np.asarray(pd_j[a]))


def test_coupled_stencil_matvec_plain_is_the_ports_operator():
    """The kernel's plain version on `viscosity_term_fields` is bitwise
    the port's `viscosity_matvec_3d` and its geometry-recompute matvec
    (the MG route's operator); its term table is the fields' order; the
    wrapper routes CPU tensors to it and refuses other devices."""
    n = (9, 11, 10)
    sphi, vol, v = _visc_system(n, 21)
    sphi_c, vol_c = split_parity(_t(sphi), 3), split_parity(_t(vol), 3)
    s_mu = torch.tensor(np.float32(0.37))
    vs = tuple(_t(x) for x in v)
    diags, per_axis, _ = viscosity.viscosity_term_fields(s_mu, sphi_c, vol_c, _shapes(n))
    assert tuple(tuple((f, tuple(o)) for f, o, _ in terms) for terms in per_axis) == cuda_stencils.coupled_terms()
    q = cuda_stencils.coupled_stencil_matvec_plain(diags, per_axis, vs)
    for ref in (viscosity.viscosity_matvec_3d(vs, s_mu, sphi_c, vol_c), cuda_cg.coupled_matvec_plain(sphi_c, vol_c, s_mu, vs)):
        for a in range(3):
            np.testing.assert_array_equal(q[a].numpy(), ref[a].numpy())
    got = cuda_stencils.coupled_stencil_matvec(diags, per_axis, vs)
    for a in range(3):
        np.testing.assert_array_equal(got[a].numpy(), q[a].numpy())
    with pytest.raises(ValueError):
        cuda_stencils.coupled_stencil_matvec(diags, per_axis, tuple(x.to("meta") for x in vs))
    # what the kernel is packed from: the fields' order, layout and type
    packed = cuda_stencils.pack_coupled_stencil(diags, per_axis)
    assert packed.ptrs.shape == (45,) and packed.terms.shape == (3, 14, 4)
    assert packed.dims.tolist() == [list(s) for s in _shapes(n)]
    for bad in ([per_axis[0][::-1], *per_axis[1:]],
                [[(f, o, c.double()) for f, o, c in per_axis[0]], *per_axis[1:]],
                [[(f, o, c.transpose(0, 1)) for f, o, c in per_axis[0]], *per_axis[1:]]):
        with pytest.raises(ValueError):
            cuda_stencils.pack_coupled_stencil(diags, bad)


@pytest.fixture(scope="module")
def fluid():
    return _fluid_state()


def _jit(fn, traced, **static):
    """fn(**traced, **static) as one jax.jit program: called eagerly,
    the JAX solvers dispatch (and compile) op by op, several times
    slower on CPU."""
    return jax.jit(lambda t: fn(**t, **static))(traced)


def _jax_cell_inputs(d):
    return dict(v_faces=_as(d["gv"], jnp.asarray), sv=_as(d["sv_c"], jnp.asarray), lphi=_as(d["lphi"], jnp.asarray),
                w_faces=_as(d["w_faces"], jnp.asarray))


VISC_CASES = [("jacobi", None), ("mg", None), ("auto", False), ("auto", True)]


@pytest.mark.parametrize("kind, flag", VISC_CASES)
def test_unpreconditioned_viscosity_solve_matches_jax(fluid, kind, flag):
    """``jacobi_precond=False``: 'jacobi' runs CG with no preconditioner
    over the materialised matvec, 'mg' and the MG branch of 'auto' the
    MG-PCG route, and the Jacobi branch of 'auto' CG over the
    materialised matvec WITH the Jacobi preconditioner (the JAX
    package's branches).  Iterations equal."""
    cfg, d = fluid
    dt = np.float32(cfg.physics.dt)
    ph = cfg.physics
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400, jacobi_precond=False, precond_kind=kind)
    want = _jit(
        jvis.viscosity_solve_3d,
        dict(dt=jnp.float32(dt), v_faces=_as(d["gv"], jnp.asarray), sphi=_as(d["sphi_c"], jnp.asarray),
             lvol=_as(d["lvol"], jnp.asarray), auto_use_mg=None if flag is None else jnp.bool_(flag)),
        mu=ph.mu, rho=ph.rho, cell_vol=cfg.grid.cell_vol, use_pallas="off", **kw,
    )
    got = viscosity.viscosity_solve_3d(
        torch.tensor(dt), ph.mu, ph.rho, *(_as(d[k], _t) for k in ("gv", "sphi_c", "lvol")), cfg.grid.cell_vol,
        auto_use_mg=None if flag is None else torch.tensor(flag), **kw,
    )
    assert int(want.stats.iters) > 1 and bool(got.stats.converged)
    assert int(got.stats.iters) == int(want.stats.iters)
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), **SOLVE_TOL)
    if (kind, flag) == ("auto", False):  # preconditioned, unlike 'jacobi' without a flag
        plain = viscosity.viscosity_solve_3d(
            torch.tensor(dt), ph.mu, ph.rho, *(_as(d[k], _t) for k in ("gv", "sphi_c", "lvol")), cfg.grid.cell_vol,
            **dict(kw, precond_kind="jacobi"),
        )
        assert int(plain.stats.iters) != int(got.stats.iters)


CELL_CASES = [("mg", False, False), ("jacobi", True, True), ("mg", True, True)]


@pytest.mark.parametrize("precond, jacobi_precond, scaled", CELL_CASES)
def test_cell_solve_options_match_jax(fluid, precond, jacobi_precond, scaled):
    """`pressure_solve_3d` with ``jacobi_precond=False`` (which 'mg'
    ignores) and with ``dt_scale`` (the dt-scaled assembly: (dt A) x =
    dt b) against JAX: iterations equal, pressure at SOLVE_TOL,
    velocities at test_torch_solvers.py's atol 1e-3."""
    cfg, d = fluid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400, jacobi_precond=jacobi_precond)
    names = ("gv", "sv_c", "lphi", "w_faces")
    want = _jit(
        jpr.pressure_solve_3d, dict(_jax_cell_inputs(d), dt_scale=jnp.float32(dt) if scaled else None),
        cell_size=cfg.grid.cell_size, use_pallas="off", precond_kind=precond, **kw,
    )
    got = pressure.pressure_solve_3d(
        *(_as(d[k], _t) for k in names), cfg.grid.cell_size, precond=precond,
        dt_scale=torch.tensor(dt) if scaled else None, **kw,
    )
    assert int(want.stats.iters) > 1 and bool(got.stats.converged)
    assert int(got.stats.iters) == int(want.stats.iters)
    np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), **SOLVE_TOL)
    for a in range(3):
        np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), atol=1e-3)


def _dot64(a, b):
    """`solvers/cg.py::tree_dot` accumulated in float64 and rounded to
    float32: the same dot products summed in another order."""
    out = None
    for x, y in zip(a, b):
        v = torch.sum(x.double() * y.double()).float()
        out = v if out is None else out + v
    return out


@pytest.mark.parametrize("scaled", [False, True])
def test_unpreconditioned_cell_solve_matches_jax(fluid, scaled, monkeypatch):
    """'jacobi' with ``jacobi_precond=False``: CG with no preconditioner
    over `stencil_matvec` from x0 = 0 (and with ``dt_scale``, over
    dt A).  Its residual is not monotone, so where it first crosses the
    threshold depends on the rounding of the dot products, and the JAX
    package sums them in another order: at tol 1e-3 the two stop up to 3
    iterations apart on this system and leave ~2e-3 of difference at a
    cell.  So the solutions are compared converged (tol 1e-5, rel_tol
    1e-6) at SOLVE_TOL, and the iterations held within 3 of JAX's for
    the port as shipped and with its dots accumulated in float64."""
    from python_fluid_simulation_tpu_torch.solvers import cg as port_cg

    cfg, d = fluid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-5, rel_tol=1e-6, max_iter=400, jacobi_precond=False)
    names = ("gv", "sv_c", "lphi", "w_faces")
    want = _jit(
        jpr.pressure_solve_3d, dict(_jax_cell_inputs(d), dt_scale=jnp.float32(dt) if scaled else None),
        cell_size=cfg.grid.cell_size, use_pallas="off", **kw,
    )
    jac = pressure.pressure_solve_3d(*(_as(d[k], _t) for k in names), cfg.grid.cell_size, **dict(kw, jacobi_precond=True))
    for dot in (port_cg.tree_dot, _dot64):
        monkeypatch.setattr(port_cg, "tree_dot", dot)
        got = pressure.pressure_solve_3d(
            *(_as(d[k], _t) for k in names), cfg.grid.cell_size, dt_scale=torch.tensor(dt) if scaled else None, **kw,
        )
        assert bool(got.stats.converged) and int(got.stats.iters) > int(jac.stats.iters)
        assert abs(int(got.stats.iters) - int(want.stats.iters)) <= 3, (dot.__name__, int(got.stats.iters), int(want.stats.iters))
        np.testing.assert_allclose(got.pressure.numpy(), np.asarray(want.pressure), **SOLVE_TOL)
        for a in range(3):
            np.testing.assert_allclose(got.v_faces[a].numpy(), np.asarray(want.v_faces[a]), atol=1e-3)


def test_unpreconditioned_density_solve_matches_jax(fluid):
    cfg, d = fluid
    g = cfg.grid
    dt = np.float32(cfg.physics.dt)
    kw = dict(tol=1e-3, rel_tol=1e-3, max_iter=400, jacobi_precond=False)
    geo = ("sphi_c", "lphi", "w_faces")
    want = _jit(
        jden.density_solve_3d, {"dt": jnp.float32(dt), **{k: _as(d[k], jnp.asarray) for k in ("px", "pm", "lphi")},
                                "sphi": _as(d["sphi_c"], jnp.asarray), "w_faces": _as(d["w_faces"], jnp.asarray)},
        rho0=cfg.physics.rho, pvol=cfg.particle_dx**3, bound_min=g.bound_min, cell_size=g.cell_size,
        use_pallas="off", **kw,
    )
    got = density.density_solve_3d(
        cfg.physics.rho, torch.tensor(dt), *(_as(d[k], _t) for k in ("px", "pm")), cfg.particle_dx**3,
        *(_as(d[k], _t) for k in geo), g.bound_min, g.cell_size, **kw,
    )
    assert int(want.stats.iters) > 3
    assert int(got.stats.iters) == int(want.stats.iters)
    np.testing.assert_allclose(got.px.numpy(), np.asarray(want.px), atol=2e-5)  # test_torch_solvers.py's


def _state_dict(j_state):
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    return {k: np.asarray(v) for k, v in start.items()}


def _with(cfg, **solver):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **solver))


@pytest.mark.parametrize("option", [dict(jacobi_precond=False), dict(pressure_dt_scaled=True)])
def test_coarse_steps_with_option_match_jax(option):
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    j_state = j_scene(j_cfg(dx=0.05))
    j_final, j_metrics = j_simulate(j_state, _with(j_cfg(dx=0.05), **option), 3)
    final, metrics = simulate(state_from_numpy(_state_dict(j_state), device="cpu"), _with(buckling_config(dx=0.05), **option), 3)
    for solver in ("density", "viscosity", "pressure"):
        got = metrics[f"{solver}_iters"].numpy()
        want = np.asarray(j_metrics[f"{solver}_iters"])
        assert np.all(np.abs(got - want) <= 2), (solver, got, want)
        assert metrics[f"{solver}_converged"].all()
    assert metrics["viscosity_iters"][1] > 0
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


SPLIT_MAX = 3  # particles whose G2P home cell the two packages may decide apart


def _home_cells(x, cfg, corner_setup):
    """Each particle's G2P home cell for each velocity component's face
    bias: (3, K, 3) int32."""
    g = cfg.grid
    return np.stack([np.asarray(corner_setup(x, g.bound_min, g.cell_size, bias)) for bias in FACE_BIAS])


def test_unpreconditioned_flagship_step_matches_exact_sum_jax(monkeypatch):
    """One flagship step with ``jacobi_precond=False`` (density ~190,
    pressure ~270, viscosity ~63 CG iterations) from the JAX state after
    one such step, against the JAX step with exact segment sums (see
    tests/test_torch_flagship.py: the JAX package's CPU cumsum route
    changes these solves' iterations).

    Unpreconditioned CG at tol = rel_tol = 1e-3 stops where its
    non-monotone residual first crosses the threshold, which the
    rounding of its dot products moves.  So the step is run twice: as
    shipped, and with the port's dots accumulated in float64 (`_dot64`).
    Measured: 186 / 63 / 267 and 187 / 63 / 263 iterations against JAX's
    190 / 63 / 271; x 1.0e-6 and 1.1e-6 m, v 1.1e-5 and 1.6e-5 m/s, APIC
    rows 6.4e-3 (67 particles above 1e-3) and 5.5e-3 (81).  So x and v
    are held to the step bounds, and both port steps' iterations to
    within 8 of JAX's.

    The rows jump where G2P's home cell ``floor((x - bound_min) / h -
    bias)`` changes (the gradient of the trilinear weights), and the
    particles are seeded on an h / 2 lattice, so some sit on a face plane:
    there a one-ulp difference of position, or JAX's jitted program
    multiplying by the rounded reciprocal of h where the formula divides
    (tests/test_torch_parity_decisions.py), puts the two packages on
    either side of the plane, and fp32 cannot decide which is right.  So
    the rows are held to 2e-2, with at most 0.2% of the particles above
    1e-3, at every particle whose home cells the two packages decide
    alike (the port's by its own formula, JAX's by its jitted one).  A
    particle decided apart (at most SPLIT_MAX; measured 1, rows 0.385
    apart: y 0.6124999, two ulps under the plane y = 49 h, against JAX's
    0.6125, on it) must have its two positions on either side of that
    face plane or within one fp32 ulp of it, by the float64 value of the
    formula; each package's home cell must be the float64 formula's from
    its own position unless that position is within one ulp of the plane;
    and each package's rows must be the rows of a float64 G2P from its
    position and home cell over the port's face velocities: within 1e-3
    for the port, and within 2e-2 for JAX, whose face velocities differ
    from the port's by rounding.
    """
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate
    from python_fluid_simulation_tpu.ops import transfers as jt
    from python_fluid_simulation_tpu_torch.engine import step as step_mod
    from python_fluid_simulation_tpu_torch.ops import transfers as pt
    from python_fluid_simulation_tpu_torch.solvers import cg as port_cg

    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        cfg_j = _with(j_cfg(), jacobi_precond=False)
        j_state1, _ = j_simulate(j_scene(cfg_j), cfg_j, 1)
        j_final, j_metrics = j_simulate(j_state1, cfg_j, 1)
        j_state1, j_final = jax.device_get((j_state1, j_final))
    finally:
        jax.clear_caches()
    start = state_from_numpy(_state_dict(j_state1), device="cpu")
    cfg = _with(buckling_config(), jacobi_precond=False)
    g = cfg.grid
    res, bmin, h = g.res, g.bound_min, g.cell_size
    j_x, j_c = np.asarray(j_final.particles.x), np.asarray(j_final.particles.c)
    j_cells = _home_cells(jnp.asarray(j_x), cfg, jax.jit(lambda p, *a: jt._corner_setup(p, *a)[0], static_argnums=(1, 2, 3)))
    g2p_inputs = []
    g2p_all = step_mod.g2p_all

    def recording_g2p_all(gv, *args):
        g2p_inputs.append([t.numpy().copy() for t in gv])
        return g2p_all(gv, *args)

    monkeypatch.setattr(step_mod, "g2p_all", recording_g2p_all)
    for dot in (port_cg.tree_dot, _dot64):
        monkeypatch.setattr(port_cg, "tree_dot", dot)
        g2p_inputs.clear()
        final, metrics = simulate(start, cfg, 1)
        assert final.particles.x.shape == (89648, 3)
        assert metrics["viscosity_iters"][0] > 0
        for solver in ("density", "viscosity", "pressure"):
            got, want = int(metrics[f"{solver}_iters"][0]), int(np.asarray(j_metrics[f"{solver}_iters"])[0])
            assert want > 50 and abs(got - want) <= 8, (dot.__name__, solver, got, want)
            assert metrics[f"{solver}_converged"].all()
        for k in ("x", "v"):
            np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                       atol=STEP_TOL[k], err_msg=f"{dot.__name__} {k}")
        p_x, p_c = final.particles.x.numpy(), final.particles.c.numpy()
        p_cells = _home_cells(final.particles.x, cfg, lambda *a: pt._corner_setup(*a)[0].numpy())
        split = (p_cells != j_cells).any(axis=(0, 2))
        rows = np.abs(p_c - j_c).reshape(89648, -1).max(axis=1)
        alike = rows[~split]
        over = int((alike > STEP_TOL["c"]).sum())
        assert alike.max() <= 2e-2 and over <= 0.002 * rows.size, (dot.__name__, alike.max(), over)
        assert split.sum() <= SPLIT_MAX, (dot.__name__, np.flatnonzero(split))
        gvs = g2p_inputs[0]
        for i in np.flatnonzero(split):
            comps, dims = np.nonzero(p_cells[:, i] != j_cells[:, i])
            plane = np.maximum(p_cells[comps, i, dims], j_cells[comps, i, dims])  # the face plane between the cells
            sides = []
            for x, cells, c, tol in ((p_x[i], p_cells[:, i], p_c[i], STEP_TOL["c"]), (j_x[i], j_cells[:, i], j_c[i], 2e-2)):
                x64, bm64, h64 = (np.asarray(t, np.float32).astype(np.float64) for t in (x, bmin, h))
                t64 = (x64 - bm64) / h64 - np.asarray(FACE_BIAS, np.float64)  # (component, dim)
                # the package's home cell is the float64 formula's from its
                # own position, or that position lies within one fp32 ulp
                # of the plane, where fp32 cannot decide
                near = np.abs(t64[comps, dims] - plane) * h64[dims] <= np.spacing(x[dims])
                assert (near | (cells[comps, dims] == np.floor(t64[comps, dims]))).all(), (i, x, cells)
                sides.append(np.where(near, 0, np.sign(t64[comps, dims] - plane)))
                _, pc64 = _g2p_f64(gvs, x, res, bm64, h64, home_shift=cells - np.floor(t64).astype(int))
                np.testing.assert_allclose(c, pc64, atol=tol, err_msg=f"{dot.__name__} particle {i}")
            # the two positions lie on either side of the plane (or on it)
            assert (sides[0] * sides[1] <= 0).all(), (i, p_x[i], j_x[i])
