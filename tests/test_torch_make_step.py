"""The port's ``make_step`` and ``simulate`` and the factored CG loop
against the JAX package, on CPU.

* 3 steps of the port's ``make_step(cfg)`` and ``simulate`` on the
  buckling funnel cut to dx = 0.05 (12x20x12 cells, 1,424 particles)
  against JAX ``make_step(cfg)`` and JAX ``simulate`` from the same
  state: x atol 1e-5 m, v atol 1e-4 m/s, APIC rows atol 1e-3 1/s (the
  step tests' bounds); the stacked metrics have JAX's keys, each of
  shape (3,), and the same iteration counts.  As in
  ``tests/test_torch_flagship.py``, the JAX package's CPU
  ``segment_sum_sorted`` (a difference of one global cumsum, off by
  rounding noise) is replaced inside this test by
  ``jax.ops.segment_sum``, which sums in row order as the port does:
  with the cumsum route the third step's v missed 1e-4 by 3e-5 at 3 of
  4,272 entries.  On the CPU ``make_step``
  is the eager step with the geometry built inside it, and ``simulate``
  builds it once: the two are bitwise equal.
* the generic CG (``solvers/cg.py``), whose body is now one function
  over the carried tensors, looped on the host: bitwise the loop it
  replaced (copied below), and against JAX's generic ``cg`` on a
  multigrid-preconditioned and an unpreconditioned (``jacobi_precond=
  False``) pressure system of the coarse scene (the unpreconditioned one
  with both packages' dots through one float64-accumulated dot and JAX's
  loop op by op: the same arithmetic, bitwise).  The captured loop's
  in-place carry (``_captured_loop``: the body writes the buffers a CUDA
  graph WHILE node iterates on) is run with a host stand-in for the
  node, bitwise the eager loop.
* ``make_step`` takes a mesh; ``bucketed=True`` without one raises
  ValueError, an unported preconditioner NotImplementedError.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, make_step, simulate
from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset
from python_fluid_simulation_tpu_torch.solvers import cg as cg_mod
from python_fluid_simulation_tpu_torch.solvers.cg import SolveStats, threshold, tree_dot
from python_fluid_simulation_tpu_torch.solvers.multigrid import make_mg_preconditioner
from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_coefficients, prepare_stencil_matvec

torch.set_num_threads(1)

STEPS = 3
ITERS = ("density_iters", "viscosity_iters", "pressure_iters")


def _jax_start():
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg

    j_state = j_scene(j_cfg(dx=0.05))
    start = {
        "x": j_state.particles.x, "v": j_state.particles.v, "c": j_state.particles.c, "m": j_state.particles.m,
        "phi": j_state.solid.phi, "sv": j_state.solid.v, "rb": j_state.solid.rb,
        "t": j_state.t, "step_idx": j_state.step_idx,
    }
    return j_state, {k: np.asarray(v) for k, v in start.items()}


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


@pytest.fixture(scope="module")
def runs():
    """Both packages' make_step and simulate, 3 steps from one state."""
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.step import make_step as j_make_step
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate
    from python_fluid_simulation_tpu.ops import scatter as j_scatter

    j_state, start = _jax_start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
        jax.clear_caches()  # no step traced before the patch may be reused
        try:
            j_step = j_make_step(j_cfg(dx=0.05))
            j_stepped, j_step_metrics = j_state, []
            for _ in range(STEPS):
                j_stepped, m = j_step(j_stepped)
                j_step_metrics.append(m)
            j_final, j_metrics = j_simulate(j_state, j_cfg(dx=0.05), STEPS)
            j_stepped, j_final = jax.device_get((j_stepped, j_final))
        finally:
            jax.clear_caches()

    cfg = buckling_config(dx=0.05)
    step = make_step(cfg)
    stepped, step_metrics = state_from_numpy(start, device="cpu"), []
    for _ in range(STEPS):
        stepped, m = step(stepped)
        step_metrics.append(m)
    final, metrics = simulate(state_from_numpy(start, device="cpu"), cfg, STEPS)
    return dict(j_stepped=j_stepped, j_step_metrics=j_step_metrics, j_final=j_final, j_metrics=j_metrics,
                stepped=stepped, step_metrics=step_metrics, final=final, metrics=metrics)


def _close_to_jax(got, want):
    np.testing.assert_allclose(got.particles.x.numpy(), np.asarray(want.particles.x), atol=1e-5)
    np.testing.assert_allclose(got.particles.v.numpy(), np.asarray(want.particles.v), atol=1e-4)
    np.testing.assert_allclose(got.particles.c.numpy(), np.asarray(want.particles.c), atol=1e-3)
    assert float(got.t) == pytest.approx(float(want.t), rel=1e-6)
    assert int(got.step_idx) == int(want.step_idx) == STEPS
    assert int(got.visc_mg) == int(want.visc_mg)


def test_make_step_matches_jax_make_step(runs):
    _close_to_jax(runs["stepped"], runs["j_stepped"])
    for m, jm in zip(runs["step_metrics"], runs["j_step_metrics"]):
        assert set(m) == set(jm)
        for k in ITERS:
            assert int(m[k]) == int(jm[k]), (k, int(m[k]), int(jm[k]))
    assert int(runs["step_metrics"][-1]["viscosity_iters"]) > 0  # the later steps really solve


def test_simulate_matches_jax_simulate(runs):
    _close_to_jax(runs["final"], runs["j_final"])
    metrics, j_metrics = runs["metrics"], runs["j_metrics"]
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        assert tuple(v.shape) == tuple(np.shape(j_metrics[k])) == (STEPS,), k
    for k in ITERS:
        np.testing.assert_array_equal(metrics[k].numpy(), np.asarray(j_metrics[k]), err_msg=k)
    np.testing.assert_allclose(metrics["dt"].numpy(), np.asarray(j_metrics["dt"]), rtol=1e-6)


def test_make_step_equals_simulate_bitwise(runs):
    """The geometry built inside each step (make_step) or once (simulate)
    is the same arithmetic: the runs agree bit for bit."""
    for k, v in state_to_numpy(runs["stepped"]).items():
        np.testing.assert_array_equal(v, state_to_numpy(runs["final"])[k], err_msg=k)
    for k, v in runs["metrics"].items():
        np.testing.assert_array_equal(v.numpy(), torch.stack([m[k] for m in runs["step_metrics"]]).numpy(), err_msg=k)


def _old_cg(matvec, b, x0, *, tol2, rel2, max_iter, precond=None):
    """The generic CG loop as it was before its body was factored out."""
    q0 = matvec(x0)
    r = tuple(bb - q for bb, q in zip(b, q0))
    z = precond(r) if precond is not None else r
    delta = tree_dot(r, z)
    res0 = tree_dot(r, r) if precond is not None else delta
    thresh = threshold(tol2, rel2, res0)
    x, d, res, k = tuple(x0), z, res0, 0
    while bool(res >= thresh) and k < max_iter and bool(delta != 0):
        q = matvec(d)
        dq = tree_dot(d, q)
        alpha = torch.where(dq != 0, delta / dq, torch.zeros_like(dq))
        x = tuple(alpha * dd + xx for dd, xx in zip(d, x))
        r = tuple(-alpha * qq + rr for qq, rr in zip(q, r))
        z = precond(r) if precond is not None else r
        new_delta = tree_dot(r, z)
        res = tree_dot(r, r) if precond is not None else new_delta
        beta = torch.where(delta != 0, new_delta / delta, torch.zeros_like(delta))
        d = tuple(beta * dd + zz for dd, zz in zip(d, z))
        delta = new_delta
        k += 1
    stats = SolveStats(iters=torch.tensor(k, dtype=torch.int32), residual=res, initial_residual=res0,
                       converged=res < thresh)
    return x, stats, thresh, r


TOL2, REL2 = float(np.float32(1e-3) ** 2), float(np.float32(1e-6**2))  # squared_tols(1e-3, 1e-6)


@pytest.fixture(scope="module")
def system():
    """The pressure system of the coarse scene's liquid (its own level set
    and the solid fractions), with a seeded right-hand side on the rows
    in the system."""
    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    g = cfg.grid
    lphi = compute_fluid_levelset(state.particles.x, g.res, g.bound_min, g.cell_size, g.dx, pm=state.particles.m)
    diag, coefs, pd = pressure_coefficients(build_geom_cache(state.solid).w_faces, lphi)
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.standard_normal(tuple(diag.shape)).astype(np.float32)) * (diag > 0)
    assert int((diag > 0).sum()) == 360
    return b, (diag, coefs, pd)


def _port_solve(system, precond, solver, max_iter=600, x0=None):
    b, coefficients = system
    diag, coefs, _ = coefficients
    mv, _ = prepare_stencil_matvec(coefficients)
    pre = None
    if precond == "mg":
        mg = make_mg_preconditioner(diag, coefs)

        def pre(r):
            return (mg(r[0]),)

    x0 = torch.zeros_like(b) if x0 is None else x0
    (x,), stats, thresh, (r,) = solver(lambda v: (mv(v[0]),), (b,), (x0,), tol2=TOL2, rel2=REL2,
                                       max_iter=max_iter, precond=pre)
    return x, stats, thresh, r


def _host_while(body, k, res, thresh, delta, max_iter):
    """The WHILE node's semantics on the host: the test before the first
    body and after each one, k + 1 after each body."""
    while bool((res >= thresh) & (k < max_iter) & (delta != 0)):
        body()
        k.add_(1)


def _captured_solver(monkeypatch):
    """`cg` with the loop `_captured_loop` records, its node stood in by
    `_host_while`."""
    monkeypatch.setattr(cg_mod, "captured_while", _host_while)

    def solve(matvec, b, x0, *, tol2, rel2, max_iter, precond=None):
        carry, res0, thresh = cg_mod.cg_init(matvec, b, x0, tol2=tol2, rel2=rel2, precond=precond)
        carry = cg_mod._captured_loop(carry, thresh, max_iter, matvec, precond)
        stats = SolveStats(iters=carry.k, residual=carry.res, initial_residual=res0, converged=carry.res < thresh)
        return carry.x, stats, thresh, carry.r

    return solve


@pytest.mark.parametrize("max_iter", [600, 5])
@pytest.mark.parametrize("precond", ["mg", None])
def test_factored_cg_loop_is_the_old_loop_bitwise(system, precond, max_iter, monkeypatch):
    """The eager loop over `cg_iteration` and the captured loop's in-place
    carry reproduce the old loop bit for bit: x, r, iterations, residuals
    (max_iter 5: the cap ends the loop)."""
    want = _port_solve(system, precond, _old_cg, max_iter)
    got = _port_solve(system, precond, cg_mod.cg, max_iter)
    x0 = torch.zeros_like(system[0])
    got_captured = _port_solve(system, precond, _captured_solver(monkeypatch), max_iter, x0=x0)
    assert not x0.any()  # the captured loop iterates on buffers of its own
    for label, run in (("eager", got), ("captured", got_captured)):
        x, stats, thresh, r = run
        assert torch.equal(x, want[0]) and torch.equal(r, want[3]), label
        assert stats.iters.dtype == torch.int32 and int(stats.iters) == int(want[1].iters), label
        assert int(stats.iters) == max_iter or max_iter == 600, label
        for k in ("residual", "initial_residual", "converged"):
            assert torch.equal(getattr(stats, k), getattr(want[1], k)), (label, k)
        assert torch.equal(thresh, want[2])


def _dot64(a, b):
    """Sum of the dots of matching arrays of two sequences, accumulated in
    float64 and rounded once to fp32."""
    tot = np.float64(0)
    for x, y in zip(a, b):
        tot += np.dot(np.asarray(x, np.float64).ravel(), np.asarray(y, np.float64).ravel())
    return np.float32(tot)


@pytest.mark.parametrize("precond", ["mg", None])
def test_factored_cg_matches_jax_cg(system, precond, monkeypatch):
    """Against JAX's generic ``cg`` (its ``lax.while_loop``) over the same
    fields: the JAX matvec is the plain 7-point form of
    ``prepare_pressure_matvec`` and the JAX V-cycle its own
    ``make_mg_preconditioner``.

    MG: JAX's jitted solve as shipped; both take 6 iterations (measured)
    and x agrees within 1e-5 of its largest entry (measured 1.1e-7 on
    entries up to 2.15: the dots sum in another order).

    Unpreconditioned: its residual is not monotone, so where it first
    crosses the threshold moves with the rounding of each iteration
    (84 / 81 iterations measured as shipped).  Two orders differ: the
    dots' summation, and XLA's CPU program contracting ``alpha * d + x``
    and the matvec's ``out + c * shift(p)`` into fused multiply-adds
    (one rounding where the formula has two).  So both packages' dots go
    through one float64-accumulated dot and JAX's loop runs op by op
    (``jax.disable_jit``), as its eager ops round: then the two solves are
    the same arithmetic, with equal iterations (82) and x equal bit for
    bit, and x within 1e-5 of its largest entry."""
    import jax.numpy as jnp

    from python_fluid_simulation_tpu.ops.indexing import shift
    from python_fluid_simulation_tpu.solvers import cg as j_cg_mod
    from python_fluid_simulation_tpu.solvers.multigrid import make_mg_preconditioner as j_mg

    if precond is None:
        monkeypatch.setattr(cg_mod, "tree_dot", lambda a, b: torch.tensor(_dot64([t.numpy() for t in a],
                                                                                 [t.numpy() for t in b])))

        def j_dot(a, b):
            la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
            return jax.pure_callback(lambda *t: _dot64(t[:len(la)], t[len(la):]),
                                     jax.ShapeDtypeStruct((), jnp.float32), *la, *lb)

        monkeypatch.setattr(j_cg_mod, "_tree_dot", j_dot)
    b, (diag, coefs, _) = system
    x, stats, _, _ = _port_solve(system, precond, cg_mod.cg)
    jd = jnp.asarray(diag.numpy())
    jc = [(off, jnp.asarray(c.numpy())) for off, c in coefs]

    def j_mv(p):
        out = jd * p
        for off, c in jc:
            out = out + c * shift(p, off, 0.0)
        return out

    j_pre = j_mg(jd, jc) if precond == "mg" else None
    jb = jnp.asarray(b.numpy())
    with jax.disable_jit(precond is None):
        j_x, j_stats = j_cg_mod.cg(j_mv, jb, jnp.zeros_like(jb), tol=1e-3, rel_tol=1e-6, max_iter=600, precond=j_pre)
    assert bool(stats.converged) and bool(j_stats.converged)
    assert int(stats.iters) == int(j_stats.iters) == {"mg": 6, None: 82}[precond]
    scale = float(np.abs(np.asarray(j_x)).max())
    np.testing.assert_allclose(x.numpy(), np.asarray(j_x), atol=1e-5 * scale)
    if precond is None:
        np.testing.assert_array_equal(x.numpy(), np.asarray(j_x))


def test_make_step_refuses_mesh_and_bucketed():
    """A mesh is taken (``tests/test_torch_mesh_make_step.py`` holds the
    step against JAX's); ``bucketed`` without one and an unported
    preconditioner are refused."""
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh

    cfg = buckling_config(dx=0.05)
    assert callable(make_step(cfg, mesh=make_mesh(4, "cpu")))
    assert callable(make_step(cfg, mesh=make_mesh(4, "cpu"), bucketed=True))
    with pytest.raises(ValueError, match="bucketed mode needs a mesh"):
        make_step(cfg, bucketed=True)
    with pytest.raises(NotImplementedError):
        make_step(dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="ic")))
