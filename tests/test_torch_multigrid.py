"""The port's cell-Poisson multigrid (``solvers/multigrid.py``) and the
plain versions of its two kernels (``ops/cuda_stencils.py::
stencil_matvec``, ``ops/cuda_mg.py`` level chains of the V-cycle's tail) against the JAX
package, on CPU.

* hierarchy (Galerkin diag / coefficients at every level), ``_restrict``
  and ``_prolong``: bitwise — the same pair sums, axis by axis in the
  same order;
* level chains vs ``pallas_mg.make_level_kernels(interpret=True)``:
  max |difference| <= 1e-6 of the field's max |value| (a few fp32 ulps:
  XLA rounds the interpreted chain's relaxation differently in the last
  bit, and 24 coarse relaxations carry it);
* one V-cycle vs the JAX V-cycle with the interpreted Pallas chains and
  vs its XLA V-cycle (``x + omega r / safe_diag`` on every level, where
  the port's levels >= 1 follow the TPU chain's ``x + r * inv``): rtol
  1e-5 / atol 1e-6, the tolerance test_pallas.py holds between those two
  JAX V-cycles;
* 7-point matvec vs ``prepare_pressure_matvec(use_pallas="blocked")``:
  rtol 1e-5 / atol 1e-5 (test_pallas.py's tolerance for that kernel).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import pallas_mg
from python_fluid_simulation_tpu.ops.fractions import compute_solid_frac_3d as j_frac
from python_fluid_simulation_tpu.solvers import multigrid as jmg
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu_torch.ops import cuda_mg, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_3d
from python_fluid_simulation_tpu_torch.solvers import multigrid as tmg
from python_fluid_simulation_tpu_torch.solvers import pressure

torch.set_num_threads(1)

N = (24, 20, 22)
VCYCLE_TOL = dict(rtol=1e-5, atol=1e-6)
CHAIN_REL = 1e-6


def _system(n=N, seed=0):
    """test_pallas.py's V-cycle system: random fluid cells, face weights
    in [0.2, 1]."""
    rng = np.random.default_rng(seed)
    lphi = rng.standard_normal(n).astype(np.float32) - 0.5
    w = [rng.uniform(0.2, 1.0, tuple(k + (1 if i == a else 0) for i, k in enumerate(n))).astype(np.float32)
         for a in range(3)]
    dj, cj, _ = jpr.pressure_coefficients([jnp.asarray(x) for x in w], jnp.asarray(lphi))
    dt, ct, _ = pressure.pressure_coefficients([torch.from_numpy(x) for x in w], torch.from_numpy(lphi))
    return (dj, cj), (dt, ct), rng


def test_hierarchy_matches_jax():
    (dj, cj), (dt, ct), _ = _system()
    lj, lt = jmg.build_hierarchy(dj, cj), tmg.build_hierarchy(dt, ct)
    assert [tuple(lv.diag.shape) for lv in lt] == [(24, 20, 22), (12, 10, 11), (6, 5, 6), (3, 3, 3)]
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        # the CUDA wrappers take contiguous fields only
        assert b.diag.is_contiguous() and all(c.is_contiguous() for _, c in b.coefs)
        np.testing.assert_array_equal(b.diag.numpy(), np.asarray(a.diag))
        np.testing.assert_array_equal(b.safe_diag.numpy(), np.asarray(a.safe_diag))
        assert [o for o, _ in b.coefs] == [tuple(o) for o, _ in a.coefs] == list(cuda_stencils.OFFSETS)
        for (_, x), (_, y) in zip(a.coefs, b.coefs):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))


@pytest.mark.parametrize("fine", [(13, 9, 11), (12, 10, 8)])
def test_restrict_and_prolong_match_jax(fine):
    rng = np.random.default_rng(sum(fine))
    coarse = tuple((s + 1) // 2 for s in fine)
    r = rng.standard_normal(fine).astype(np.float32)
    e = rng.standard_normal(coarse).astype(np.float32)
    np.testing.assert_array_equal(
        tmg._restrict(torch.from_numpy(r), coarse).numpy(), np.asarray(jmg._restrict(jnp.asarray(r), coarse))
    )
    np.testing.assert_array_equal(
        tmg._prolong(torch.from_numpy(e), fine).numpy(), np.asarray(jmg._prolong(jnp.asarray(e), fine))
    )


def _close_rel(got, want, rel):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (np.abs(got - want).max(), np.abs(want).max())


def test_level_chains_plain_match_pallas_interpret():
    (dj, cj), (dt, ct), rng = _system()
    lj, lt = jmg.build_hierarchy(dj, cj)[1], tmg.build_hierarchy(dt, ct)[1]
    kw = dict(omega=0.8, n_smooth=2, coarse_iters=24)
    kj = pallas_mg.make_level_kernels(lj.diag, lj.coefs, interpret=True, **kw)
    before = cuda_mg.vcycle_tail.launches

    def chain(b, x0, iters, resid):
        return cuda_mg.level_chain_plain(lt.diag, lt.coefs, b, x0, iters=iters, omega=0.8, emit_resid=resid)

    b = rng.standard_normal(lt.diag.shape).astype(np.float32)
    x = rng.standard_normal(lt.diag.shape).astype(np.float32)
    xj, rj = kj.presmooth_resid(jnp.asarray(b))
    xt, rt = chain(torch.from_numpy(b), None, 2, True)
    _close_rel(xt.numpy(), xj, CHAIN_REL)
    _close_rel(rt.numpy(), rj, CHAIN_REL)
    _close_rel(chain(torch.from_numpy(b), torch.from_numpy(x), 2, False).numpy(),
               kj.postsmooth(jnp.asarray(x), jnp.asarray(b)), CHAIN_REL)
    _close_rel(chain(torch.from_numpy(b), None, 24, False).numpy(), kj.coarse_solve(jnp.asarray(b)), CHAIN_REL)
    # the chains' wrapper is the V-cycle's tail: the CPU runs its plain
    # version, and a meta tensor is refused
    tail = cuda_mg.make_vcycle_tail(tmg.build_hierarchy(dt, ct), **kw)
    r0 = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    cuda_mg.vcycle_tail(tail, r0, r0)
    assert cuda_mg.vcycle_tail.launches == before
    with pytest.raises(ValueError):
        cuda_mg.vcycle_tail(tail, r0.to("meta"), r0.to("meta"))


def test_vcycle_matches_jax_fused_and_xla(monkeypatch):
    (dj, cj), (dt, ct), rng = _system()
    r = rng.standard_normal(N).astype(np.float32)
    z_t = tmg.make_mg_preconditioner(dt, ct)(torch.from_numpy(r)).numpy()
    z_xla = np.asarray(jmg.make_mg_preconditioner(dj, cj)(jnp.asarray(r)))
    make = pallas_mg.make_level_kernels
    monkeypatch.setattr(pallas_mg, "level_kernels_available", lambda s: True)
    monkeypatch.setattr(pallas_mg, "make_level_kernels", lambda d, c, **kw: make(d, c, **{**kw, "interpret": True}))
    z_fused = np.asarray(jmg.make_mg_preconditioner(dj, cj)(jnp.asarray(r)))
    np.testing.assert_allclose(z_t, z_fused, **VCYCLE_TOL)
    np.testing.assert_allclose(z_t, z_xla, **VCYCLE_TOL)
    # inactive rows pass r through
    inactive = dt.numpy() <= 0
    assert inactive.any()
    np.testing.assert_array_equal(z_t[inactive], r[inactive])


def test_stencil_matvec_plain_matches_blocked_pallas():
    n = (13, 9, 17)
    rng = np.random.default_rng(7)
    sphi = rng.standard_normal(tuple(2 * k + 1 for k in n)).astype(np.float32)
    lphi = rng.standard_normal(n).astype(np.float32)
    mv_b, _ = jpr.prepare_pressure_matvec(j_frac(jnp.asarray(sphi)), jnp.asarray(lphi), use_pallas="blocked")
    diag, coefs, _ = pressure.pressure_coefficients(compute_solid_frac_3d(torch.from_numpy(sphi)), torch.from_numpy(lphi))
    p = rng.standard_normal(n).astype(np.float32)
    before = cuda_stencils.stencil_matvec.launches
    got = cuda_stencils.stencil_matvec(diag, coefs, torch.from_numpy(p))
    assert cuda_stencils.stencil_matvec.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(mv_b(jnp.asarray(p))), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), cuda_stencils.stencil_matvec_plain(diag, coefs, torch.from_numpy(p)).numpy())
    with pytest.raises(ValueError):
        cuda_stencils.stencil_matvec(diag, coefs, torch.from_numpy(p).to("meta"))


@pytest.mark.parametrize("opts", [None, (1, 3, 8)])
def test_mg_cell_solve_matches_jax(opts):
    """A free-surface tank (test_pallas.py's MG test, smaller): the MG-PCG
    solve against the JAX package's MG route (XLA V-cycle), solution
    rtol 2e-3 / atol 2e-4 and iterations within 2, like the Jacobi
    solves of test_torch_solvers.py; MG needs far fewer iterations than
    Jacobi on this system."""
    n = (16, 16, 16)
    rng = np.random.default_rng(0)
    lphi = np.ones(n, np.float32)
    lphi[2:-2, 2:-6, 2:-2] = -1.0
    sphi = np.ones(tuple(2 * k + 1 for k in n), np.float32)
    v = [rng.standard_normal(tuple(k + (1 if i == a else 0) for i, k in enumerate(n))).astype(np.float32) for a in range(3)]
    sv = np.zeros(sphi.shape + (3,), np.float32)
    w_j = j_frac(jnp.asarray(sphi))
    b_j = jpr.pressure_rhs_3d([jnp.asarray(x) for x in v], jnp.asarray(sv), jnp.asarray(lphi), w_j, (0.05,) * 3)
    kw = dict(tol=1e-4, rel_tol=3e-6, max_iter=400)
    x_j, st_j = jpr.solve_cell_poisson(b_j, w_j, jnp.asarray(lphi), use_pallas="off", precond_kind="mg", mg_opts=opts, **kw)
    coefs = pressure.pressure_coefficients(compute_solid_frac_3d(torch.from_numpy(sphi)), torch.from_numpy(lphi))
    b_t = torch.from_numpy(np.asarray(b_j))
    x_t, st_t = pressure.solve_cell_poisson(b_t, coefs, precond="mg", mg_opts=opts, **kw)
    _, st_jac = pressure.solve_cell_poisson(b_t, coefs, **kw)
    assert bool(st_t.converged) and bool(st_j.converged)
    assert abs(int(st_t.iters) - int(st_j.iters)) <= 2, (int(st_t.iters), int(st_j.iters))
    assert int(st_t.iters) < int(st_jac.iters) // 2, (int(st_t.iters), int(st_jac.iters))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=2e-3, atol=2e-4)
