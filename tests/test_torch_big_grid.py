"""The big-grid (> 4M cells) route of the PyTorch port against the JAX
package, on CPU: the blocked Poisson PCG (the plain version of
csrc/poisson_pcg.cu on its fused route) and the lean two-grid
viscosity MG route.

* ``fused_poisson_pcg`` (plain) against ``make_fused_poisson_cg(...,
  interpret=True)`` on tests/test_pallas.py's ghost-fluid pressure system
  and on a density system, from x0 = 0 and from a random x0: iterations
  equal, x within rtol 1e-4 / atol 1e-6 of max|x|, res, res0 and thresh
  within rtol 1e-4 (measured: 9-11 iterations, equal; x 1.5e-7 of
  max|x| at most, res 2.0e-6 relative).  From x0 = 0 it equals ``cell_poisson_pcg_plain`` (the
  gate's other side): iterations equal and x bitwise, thresh within one
  fp32 rounding of rel_tol^2.
* ``viscosity_axis_block_stencil`` per axis, plain and symmetrised,
  against the JAX function: atol 1e-6 (measured bitwise); unsymmetrised
  it is bitwise the same-axis part of ``viscosity_term_fields``.
* the lean preconditioner against the JAX one built as
  ``_lean_mg_setup`` (test_pallas.py) builds it, on random
  active-supported vectors: rtol 1e-5 / atol 1e-6 (the batched V-cycle's
  tolerance: its levels >= 1 relax in the TPU chain's form; measured
  2.4e-7 at most); it is symmetric, as test_pallas.py checks the JAX one.
* lean MG-PCG against the JAX ``cg(geom_mv, b, x0, precond=lean)``:
  iterations equal, x atol 1e-5 (measured 13 and 13 iterations, x
  7.2e-7); it matches plain CG in no more iterations (13 against 22;
  test_pallas.py's lean PCG test).
* the slice as a whole: 2 coiling steps at ``coiling_config(32)`` from
  visc_mg = 2 with both port gates lowered (every Jacobi cell solve takes
  ``fused_poisson_pcg``, every viscosity MG solve the lean route) against
  the JAX step (see `test_big_route_coiling_steps_match_jax`).
* the viscosity MG route picks the lean preconditioner exactly above
  ``MG_FACE_CELLS`` (tests/test_torch_step.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import pallas_cg
from python_fluid_simulation_tpu.ops.fractions import compute_solid_frac_3d as j_frac
from python_fluid_simulation_tpu.ops.indexing import split_parity as j_split
from python_fluid_simulation_tpu.solvers import cg as jcg
from python_fluid_simulation_tpu.solvers import density as jden
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu.solvers import viscosity as jvisc
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import coiling_config
from python_fluid_simulation_tpu_torch.engine.step import simulate
from python_fluid_simulation_tpu_torch.ops import cuda_cg, cuda_mg, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity
from python_fluid_simulation_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

N = (8, 10, 12)  # tests/test_pallas.py's grid
DUAL = tuple(2 * k + 1 for k in N)
SHAPES = [tuple(k + (1 if i == a else 0) for i, k in enumerate(N)) for a in range(3)]
PCG_REL = dict(rtol=1e-4, atol=1e-6)  # x: atol is a fraction of max|x|
STENCIL_ATOL = 1e-6
LEAN_TOL = dict(rtol=1e-5, atol=1e-6)
LEAN_PCG_ATOL = 1e-5
SOLVE_TOL = dict(rtol=2e-3, atol=2e-4)  # test_pallas.py's lean PCG test
STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)  # tests/test_torch_step.py
TIGHT = dict(tol=1e-5, rel_tol=1e-5, max_iter=500)  # tests/test_step.py's MG coiling test


def _t(a):
    return torch.from_numpy(np.array(a))


def _cell_system(kind):
    """test_pallas.py::test_fused_poisson_cg_matches_generic's pressure
    system, or a density system on the same geometry."""
    rng = np.random.default_rng(9)
    sphi = jnp.asarray(rng.standard_normal(DUAL).astype(np.float32))
    rng.standard_normal(N)  # test_pallas.py's unused lphi draw
    lphi = jnp.asarray(np.where(np.random.default_rng(10).random(N) < 0.6, -1.0, 1.0).astype(np.float32))
    w = j_frac(sphi)
    if kind == "pressure":
        v = tuple(jnp.asarray(rng.standard_normal(s).astype(np.float32)) for s in SHAPES)
        sv = jnp.zeros(DUAL + (3,), jnp.float32)
        b = jpr.pressure_rhs_3d(v, sv, lphi, w, (0.1, 0.1, 0.1))
        diag, coefs, pd = jpr.pressure_coefficients(w, lphi)
    else:
        gm = jnp.asarray(rng.uniform(0.0, 2.0, N).astype(np.float32))
        gvol = jnp.asarray(rng.uniform(0.5, 1.5, N).astype(np.float32) * 1e-3)
        b = jden.density_rhs(1.0, 1.0 / 60.0, gm, gvol, lphi, w, (0.1, 0.1, 0.1))
        diag, coefs, pd = jden.density_coefficients(w, lphi)
    x0 = rng.standard_normal(N).astype(np.float32) * float(np.abs(np.asarray(b)).max())
    return b, diag, coefs, pd, x0


@pytest.mark.parametrize("kind", ["pressure", "density"])
@pytest.mark.parametrize("from_zero", [True, False])
def test_fused_poisson_pcg_plain_matches_pallas_interpret(kind, from_zero):
    b, diag, coefs, pd, x0 = _cell_system(kind)
    if from_zero:
        x0 = np.zeros(N, np.float32)
    kw = dict(tol=1e-5, rel_tol=1e-5, max_iter=500)
    solve = pallas_cg.make_fused_poisson_cg(diag, coefs, pd, interpret=True, **kw)
    xj, itj, resj, res0j, thrj = solve(b, jnp.asarray(x0))
    tcoefs = [(tuple(off), _t(c)) for off, c in coefs]
    before = cuda_stencils.fused_poisson_pcg.launches
    x, it, res, res0, thr = cuda_stencils.fused_poisson_pcg(
        _t(b), torch.from_numpy(x0), _t(diag), tcoefs, _t(pd), **kw)
    assert cuda_stencils.fused_poisson_pcg.launches == before  # CPU: the plain version
    assert int(it) == int(itj) and int(it) > 3, (int(it), int(itj))
    xj = np.asarray(xj)
    scale = np.abs(xj).max()
    np.testing.assert_allclose(x.numpy(), xj, rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * scale)
    for got, want in ((res, resj), (res0, res0j), (thr, thrj)):
        np.testing.assert_allclose(float(got), float(want), rtol=PCG_REL["rtol"])
    assert float(res) < float(thr)
    if from_zero:  # the gate's two sides compute the same solve
        xc, itc, resc, res0c, thrc = cuda_stencils.cell_poisson_pcg_plain(
            _t(b), _t(diag), tcoefs, _t(pd), **kw)
        assert int(itc) == int(it)
        np.testing.assert_array_equal(xc.numpy(), x.numpy())
        assert float(res0c) == float(res0)
        np.testing.assert_allclose(float(thrc), float(thr), rtol=2e-7)
    with pytest.raises(ValueError):
        cuda_stencils.fused_poisson_pcg(_t(b).to("meta"), torch.from_numpy(x0), _t(diag), tcoefs, _t(pd), **kw)


def _lean_geometry(seed=29):
    """test_pallas.py::_lean_mg_setup's geometry: (rng, sphi_c, vol_c) as
    JAX and torch parity-class dicts."""
    rng = np.random.default_rng(seed)
    sphi = rng.standard_normal(DUAL).astype(np.float32)
    rng.standard_normal(N)
    vol = rng.uniform(0.1, 1.0, DUAL).astype(np.float32)
    j = (j_split(jnp.asarray(sphi), 3), j_split(jnp.asarray(vol), 3))
    t = (split_parity(torch.from_numpy(sphi), 3), split_parity(torch.from_numpy(vol), 3))
    return rng, j, t


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_viscosity_axis_block_stencil_matches_jax(axis, symmetrize):
    _, (jsphi, jvol), (sphi, vol) = _lean_geometry(31 + axis)
    want = jvisc.viscosity_axis_block_stencil(axis, 0.7, jsphi, jvol, SHAPES[axis], symmetrize=symmetrize)
    got = viscosity.viscosity_axis_block_stencil(axis, torch.tensor(0.7), sphi, vol, SHAPES[axis], symmetrize=symmetrize)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=STENCIL_ATOL)
    assert [tuple(o) for o, _ in got[1]] == [tuple(o) for o, _ in want[1]]
    for (_, c), (_, w) in zip(got[1], want[1]):
        np.testing.assert_allclose(c.numpy(), np.asarray(w), atol=STENCIL_ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=STENCIL_ATOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    # unsymmetrised, it is the same-axis part of the term fields
    diags, same, pdiags = viscosity.viscosity_term_fields(torch.tensor(0.7), sphi, vol, SHAPES, same_axis_only=True)
    if not symmetrize:
        np.testing.assert_array_equal(got[0].numpy(), diags[axis].numpy())
        for (_, c), (_, _, w) in zip(got[1], same[axis]):
            np.testing.assert_array_equal(c.numpy(), w.numpy())
        np.testing.assert_array_equal(got[2].numpy(), pdiags[axis].numpy())


def _lean_pair(seed=29, mu=0.7):
    """The lean preconditioner of both packages on one geometry, the JAX
    one as test_pallas.py::_lean_mg_setup builds it."""
    rng, (jsphi, jvol), (sphi, vol) = _lean_geometry(seed)
    blk = pallas_cg.make_blocked_coupled_matvec_geom(jsphi, jvol, mu, SHAPES, interpret=True, same_axis_only=True)
    jpre = jvisc.make_viscosity_mg_preconditioner_lean(mu, jsphi, jvol, SHAPES, False, blk)
    s_mu = torch.tensor(mu)
    tpre = viscosity.make_viscosity_mg_preconditioner_lean(
        s_mu, sphi, vol, SHAPES,
        lambda vs: cuda_cg.coupled_matvec_geom(sphi, vol, s_mu, vs, same_axis_only=True))
    act = [viscosity.viscosity_axis_block_stencil(a, s_mu, sphi, vol, SHAPES[a])[3].numpy() for a in range(3)]
    return rng, (jsphi, jvol), (sphi, vol, s_mu), jpre, tpre, act


def _masked(rng, act):
    return tuple(np.where(a, rng.standard_normal(a.shape).astype(np.float32), 0.0).astype(np.float32) for a in act)


@pytest.mark.parametrize("seed", [29, 37])
def test_lean_preconditioner_matches_jax(seed):
    rng, _, _, jpre, tpre, act = _lean_pair(seed)
    before = (cuda_cg.coupled_matvec_geom.launches, cuda_mg.vcycle_tail.launches, cuda_stencils.stencil_matvec.launches)
    for _ in range(2):
        r = _masked(rng, act)
        want = jpre(tuple(jnp.asarray(x) for x in r))
        got = tpre(tuple(torch.from_numpy(x) for x in r))
        for a in range(3):
            np.testing.assert_allclose(got[a].numpy(), np.asarray(want[a]), **LEAN_TOL)
    assert (cuda_cg.coupled_matvec_geom.launches, cuda_mg.vcycle_tail.launches,
            cuda_stencils.stencil_matvec.launches) == before


def test_lean_preconditioner_is_symmetric():
    """<M^-1 u, w> == <u, M^-1 w> on active-supported vectors
    (test_pallas.py::test_lean_viscosity_mg_preconditioner_is_symmetric's
    bound)."""
    rng, _, _, _, tpre, act = _lean_pair()
    u = tuple(torch.from_numpy(x) for x in _masked(rng, act))
    w = tuple(torch.from_numpy(x) for x in _masked(rng, act))
    mu_, mw = tpre(u), tpre(w)
    lhs = sum(float(torch.sum(x.double() * y.double())) for x, y in zip(mu_, w))
    rhs = sum(float(torch.sum(x.double() * y.double())) for x, y in zip(u, mw))
    scale = sum(float(torch.sum(x.double() ** 2)) ** 0.5 for x in mu_)
    assert abs(lhs - rhs) < 1e-4 * max(scale, 1.0), (lhs, rhs)


def test_lean_mg_pcg_matches_jax():
    rng, (jsphi, jvol), (sphi, vol, s_mu), jpre, tpre, act = _lean_pair()
    jmv = pallas_cg.make_blocked_coupled_matvec_geom(jsphi, jvol, 0.7, SHAPES, interpret=True)

    def tmv(vs):
        return cuda_cg.coupled_matvec_geom(sphi, vol, s_mu, vs)

    x_true = tuple(torch.from_numpy(x) for x in _masked(rng, act))
    b = tmv(x_true)
    x0 = tuple(torch.zeros(s) for s in SHAPES)
    tol, rel_tol = 1e-6, 1e-8
    kw = dict(tol2=float(np.float32(tol) ** 2), rel2=float(np.float32(rel_tol**2)), max_iter=600)
    x_mg, st_mg, _, _ = cg(tmv, b, x0, precond=tpre, **kw)
    jb = tuple(jnp.asarray(t.numpy()) for t in b)
    jx0 = tuple(jnp.zeros(s, jnp.float32) for s in SHAPES)
    xj, stj = jcg.cg(jmv, jb, jx0, tol=tol, rel_tol=rel_tol, max_iter=600, precond=jpre)
    assert int(st_mg.iters) == int(stj.iters) and bool(st_mg.converged), (int(st_mg.iters), int(stj.iters))
    for a in range(3):
        np.testing.assert_allclose(x_mg[a].numpy(), np.asarray(xj[a]), atol=LEAN_PCG_ATOL)
    # test_pallas.py::test_lean_viscosity_mg_pcg_matches_jacobi_pcg: the
    # same solution as plain CG, in no more iterations
    x_cg, st_cg, _, _ = cg(tmv, b, x0, precond=None, **kw)
    for a in range(3):
        np.testing.assert_allclose(x_mg[a].numpy(), x_cg[a].numpy(), **SOLVE_TOL)
    assert int(st_mg.iters) <= int(st_cg.iters), (int(st_mg.iters), int(st_cg.iters))


def test_big_route_coiling_steps_match_jax(monkeypatch):
    """2 steps of ``coiling_config(32)`` (8x32x8 cells, 'auto' from
    visc_mg = 2, test_step.py's MG coiling tolerances) through both
    packages, both routes of the big grid taken at this size:

    * the port: ``pressure.FUSED_POISSON_CELLS`` and
      ``viscosity.MG_FACE_CELLS`` patched to 0, so both Jacobi cell solves
      run ``fused_poisson_pcg`` and the viscosity solve the lean MG-PCG;
    * the JAX step: ``pallas_cg.fused_poisson_cg_available`` patched to
      True, so its cell solves run ``make_fused_poisson_cg`` (interpret
      mode on CPU), as its big-grid Jacobi route does.  Its big viscosity
      branch (``_mg_solve``, > 4M face cells) is chosen by a literal and
      needs the TPU layout, so no patch of that decision alone reaches it
      on CPU; the test replaces the block preconditioner the JAX step
      builds (``make_viscosity_mg_preconditioner``) by the composition
      the big branch runs: ``make_viscosity_mg_preconditioner_lean`` over
      the same-axis ``make_blocked_coupled_matvec_geom`` (interpret mode),
      inside the step's own ``cg``.  Its outer operator stays the XLA
      matvec of the CPU route, which computes the geometry matvec's
      products (~1 ulp apart).

    Iterations equal in every solve; x, v and APIC rows within STEP_TOL
    (measured: density 16/16, viscosity 0/6, pressure 15/14 iterations,
    equal; x 2.4e-7 m, v 4.2e-7 m/s, rows 8.8e-5 1/s).  Nothing in the JAX package changes: the patches live in this test.
    """
    from python_fluid_simulation_tpu.engine.scenes import coiling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import coiling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    res = 32

    def solver(c):
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, viscosity_precond="auto", **TIGHT))

    seen = {}
    term_fields = jvisc.viscosity_term_fields

    def rec_term_fields(s_mu, sphi, vol, face_shapes, strict_fluid=False):
        seen["args"] = (s_mu, sphi, vol, [tuple(s) for s in face_shapes])
        return term_fields(s_mu, sphi, vol, face_shapes, strict_fluid)

    def lean(_diags, _per_axis):
        s_mu, sphi, vol, shapes = seen["args"]
        blk = pallas_cg.make_blocked_coupled_matvec_geom(sphi, vol, s_mu, shapes, interpret=True, same_axis_only=True)
        seen["lean"] = seen.get("lean", 0) + 1
        return jvisc.make_viscosity_mg_preconditioner_lean(s_mu, sphi, vol, shapes, False, blk)

    j_state = j_scene(j_cfg(res))._replace(visc_mg=np.int32(2))
    jax.clear_caches()
    with monkeypatch.context() as m:
        m.setattr(pallas_cg, "fused_poisson_cg_available", lambda shape, interpret=False: True)
        m.setattr(jvisc, "viscosity_term_fields", rec_term_fields)
        m.setattr(jvisc, "make_viscosity_mg_preconditioner", lean)
        j_final, j_metrics = j_simulate(j_state, solver(j_cfg(res)), 2)
        j_final = jax.tree_util.tree_map(np.asarray, j_final)
        j_metrics = {k: np.asarray(v) for k, v in j_metrics.items()}
    jax.clear_caches()
    assert seen.get("lean", 0) >= 1

    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx, "visc_mg": np.int32(2),
    }
    state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    calls = {"fused": 0, "cell": 0, "lean": 0}

    def count(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(pressure, "FUSED_POISSON_CELLS", 0)
    monkeypatch.setattr(viscosity, "MG_FACE_CELLS", 0)
    monkeypatch.setattr(pressure, "fused_poisson_pcg", count("fused", pressure.fused_poisson_pcg))
    monkeypatch.setattr(pressure, "cell_poisson_pcg", count("cell", pressure.cell_poisson_pcg))
    monkeypatch.setattr(viscosity, "make_viscosity_mg_preconditioner_lean",
                        count("lean", viscosity.make_viscosity_mg_preconditioner_lean))
    before = cuda_stencils.fused_poisson_pcg.launches
    final, metrics = simulate(state, solver(coiling_config(res)), 2)
    assert cuda_stencils.fused_poisson_pcg.launches == before  # CPU: no kernel launch
    assert calls == {"fused": 4, "cell": 0, "lean": 2}, calls
    assert final.particles.x.shape[0] > 0
    for s in ("density", "viscosity", "pressure"):
        got, want = metrics[f"{s}_iters"].numpy(), j_metrics[f"{s}_iters"]
        assert np.array_equal(got, want), (s, got, want)
        assert metrics[f"{s}_converged"].all()
    assert metrics["viscosity_iters"][1] > 0  # the second step really solves
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), getattr(j_final.particles, k),
                                   atol=tol, err_msg=k)
    assert int(final.visc_mg) == int(j_final.visc_mg) == 2
