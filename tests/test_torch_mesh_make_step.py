"""The port's captured-step entry points with a mesh, ``make_step(cfg,
mesh=[, bucketed=True])`` and ``simulate(..., mesh=[, bucketed=True])``,
and the factored distributed PCG loops, on CPU.

* On the buckling funnel cut to dx = 0.05 (12x20x12 cells, 1,424
  particles; tests/test_torch_make_step.py's scene, masses made unique
  so that a particle is matched across two bucketed layouts by its mass)
  on a 1D mesh of 4 slots (slabs 3 cells wide) and a (2, 2) (x, z) mesh
  (6 x 6), sharded and bucketed: the port's ``make_step`` and
  ``simulate`` against JAX ``make_step(cfg, mesh=[, bucketed=True])``
  (2 steps) or JAX ``simulate(..., mesh=[, bucketed=True])`` (3 steps)
  on the 8 virtual CPU devices, from the same state: x atol 1e-5 m,
  v atol 1e-4 m/s, APIC rows atol 1e-3 1/s (the step tests' bounds),
  the particles matched by mass; JAX's metric keys, the same iteration
  counts, ``visc_mg``, ``bucket_lost`` 0.  Each configuration compiles
  one JAX program (~30 s cold), so two are held against JAX
  ``make_step`` and two against JAX ``simulate``; on the CPU the port's
  ``make_step`` and ``simulate`` are the same eager steps, asserted
  bitwise in every configuration.  As in tests/test_torch_make_step.py
  the JAX package's CPU ``segment_sum_sorted`` is replaced inside this
  test by ``jax.ops.segment_sum``.
* The two distributed loops (``parallel/halo.py``), now an init and one
  iteration over a ``CGCarry`` looped by ``solvers/cg.py::loop``: on a
  1D and a (2, 2) CPU mesh, the host loop is bitwise the loop it
  replaced (copied below), and the captured loop's in-place carry, its
  WHILE node stood in by a host loop, is bitwise the host loop; both
  return the iterations as a device int32.  Over a mesh of two devices
  the captured solves run one loop a device (the host stand-in checks
  that every device's exit test agrees) and return the eager solve's
  bits.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu_torch.convert import state_from_numpy
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import StepReplayer, make_step, simulate
from python_fluid_simulation_tpu_torch.ops.fractions import compute_solid_frac_3d
from python_fluid_simulation_tpu_torch.ops.indexing import sample, split_parity
from python_fluid_simulation_tpu_torch.parallel import halo
from python_fluid_simulation_tpu_torch.parallel.mesh import (
    Mesh,
    gather_blocks,
    make_mesh,
    make_mesh2d,
    split_blocks,
)
from python_fluid_simulation_tpu_torch.solvers import cg as cg_mod
from python_fluid_simulation_tpu_torch.solvers import viscosity
from python_fluid_simulation_tpu_torch.solvers.pressure import pressure_coefficients

torch.set_num_threads(1)

DX = 0.05
ITERS = ("density_iters", "viscosity_iters", "pressure_iters")
# (mesh kind, bucketed, the JAX entry point it is held against, steps)
CASES = [("1d", False, "make_step", 2), ("2d", True, "make_step", 2),
         ("2d", False, "simulate", 3), ("1d", True, "simulate", 3)]


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


def _meshes(kind):
    from python_fluid_simulation_tpu.parallel import mesh as j_mesh

    if kind == "1d":
        return j_mesh.make_mesh(4), make_mesh(4, "cpu")
    return j_mesh.make_mesh2d((2, 2)), make_mesh2d((2, 2), "cpu")


def _jax_bucketed(j_state, j_m, kind, cfg):
    """The JAX state's particles bucketed over ``j_m`` (JAX's functions)."""
    g = cfg.grid
    n = j_state.particles.x.shape[0]
    pos = np.asarray(j_state.particles.x)
    if kind == "1d":
        from python_fluid_simulation_tpu.parallel import particles as j_p

        spec = j_p.make_bucket_spec(4, g.res[0], n, positions=pos, bound_min=g.bound_min, cell_size=g.cell_size)
        return j_p.bucket_particles(j_state.particles, j_m, spec, g.bound_min, g.cell_size)
    from python_fluid_simulation_tpu.parallel import particles2d as j_p2d

    spec = j_p2d.make_bucket_spec_2d((2, 2), g.res[0], g.res[2], n, positions=pos, bound_min=g.bound_min,
                                     cell_size=g.cell_size)
    return j_p2d.bucket_particles_2d(j_state.particles, j_m, spec, g.bound_min, g.cell_size)


def _numpy_state(s):
    return {k: np.asarray(v) for k, v in {
        "x": s.particles.x, "v": s.particles.v, "c": s.particles.c, "m": s.particles.m,
        "phi": s.solid.phi, "sv": s.solid.v, "rb": s.solid.rb, "t": s.t, "step_idx": s.step_idx}.items()}


def _jax_run(kind, bucketed, entry, steps):
    """(the start state as numpy, JAX's states after each step as numpy
    (make_step) or its final state (simulate), its metrics a step)."""
    import jax.numpy as jnp

    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg_of
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import make_step as j_make_step
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate
    from python_fluid_simulation_tpu.parallel.mesh import shard_state as j_shard_state

    j_cfg = j_cfg_of(dx=DX)
    j_state = j_scene(j_cfg)
    n = j_state.particles.x.shape[0]
    m = np.asarray(j_state.particles.m) * (1.0 + 1e-4 * np.arange(n, dtype=np.float32))
    j_state = j_state._replace(particles=j_state.particles._replace(m=jnp.asarray(m)),
                               visc_mg=jnp.int32(0), t=jnp.float32(j_state.t),
                               step_idx=jnp.int32(j_state.step_idx))
    j_m, _ = _meshes(kind)
    j_state = j_shard_state(j_state, j_m)
    # the scalars replicated over the mesh, as the step returns them: the
    # second make_step call reuses the first one's program
    j_state = j_state._replace(visc_mg=jax.device_put(j_state.visc_mg, NamedSharding(j_m, PartitionSpec())))
    if bucketed:
        j_state = j_state._replace(particles=_jax_bucketed(j_state, j_m, kind, j_cfg))
    start = _numpy_state(jax.device_get(j_state))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
        jax.clear_caches()  # no step traced before the patch may be reused
        try:
            if entry == "make_step":
                step = j_make_step(j_cfg, mesh=j_m, bucketed=bucketed)
                states, metrics = [], []
                s = j_state
                for _ in range(steps):
                    s, mm = step(s)
                    states.append(_numpy_state(jax.device_get(s)) | {"visc_mg": np.asarray(s.visc_mg)})
                    metrics.append(jax.device_get(mm))
            else:
                s, stacked = j_simulate(j_state, j_cfg, steps, mesh=j_m, bucketed=bucketed)
                states = [_numpy_state(jax.device_get(s)) | {"visc_mg": np.asarray(s.visc_mg)}]
                stacked = jax.device_get(stacked)
                metrics = [{k: v[i] for k, v in stacked.items()} for i in range(steps)]
        finally:
            jax.clear_caches()
    return start, states, metrics


@pytest.fixture(scope="module", params=CASES, ids=[f"{k}-{'bucketed' if b else 'sharded'}-{e}" for k, b, e, _ in CASES])
def case(request):
    kind, bucketed, entry, steps = request.param
    start, j_states, j_metrics = _jax_run(kind, bucketed, entry, steps)
    _, mesh = _meshes(kind)
    cfg = buckling_config(dx=DX)
    step = make_step(cfg, mesh=mesh, bucketed=bucketed)
    s, stepped, step_metrics = state_from_numpy(start, device="cpu"), [], []
    for _ in range(steps):
        s, mm = step(s)
        stepped.append(s)
        step_metrics.append(mm)
    final, metrics = simulate(state_from_numpy(start, device="cpu"), cfg, steps, mesh=mesh, bucketed=bucketed)
    return dict(kind=kind, bucketed=bucketed, entry=entry, steps=steps, j_states=j_states, j_metrics=j_metrics,
                stepped=stepped, step_metrics=step_metrics, final=final, metrics=metrics)


def _matched(x, v, c, m):
    """(x, v, c, m) of the live rows, ordered by (unique) mass."""
    live = m > 0
    order = np.argsort(m[live])
    return tuple(a[live][order] for a in (x, v, c, m))


def _close_to_jax(got, want):
    gx, gv, gc, gm = _matched(*(getattr(got.particles, k).numpy() for k in "xvcm"))
    wx, wv, wc, wm = _matched(want["x"], want["v"], want["c"], want["m"])
    np.testing.assert_array_equal(gm, wm)  # the same particle set
    np.testing.assert_allclose(gx, wx, atol=1e-5)
    np.testing.assert_allclose(gv, wv, atol=1e-4)
    np.testing.assert_allclose(gc, wc, atol=1e-3)
    assert float(got.t) == pytest.approx(float(want["t"]), rel=1e-6)
    assert int(got.step_idx) == int(want["step_idx"])
    assert int(got.visc_mg) == int(want["visc_mg"])


def _same_metrics(got, want, bucketed):
    assert set(got) == set(want)
    assert ("bucket_lost" in got) == bucketed
    for k in ITERS:
        assert int(got[k]) == int(want[k]), (k, int(got[k]), int(want[k]))
    for k in ("density_converged", "viscosity_converged", "pressure_converged"):
        assert bool(got[k]) and bool(want[k]), k
    if bucketed:
        assert int(got["bucket_lost"]) == int(want["bucket_lost"]) == 0
    np.testing.assert_allclose(float(got["dt"]), float(want["dt"]), rtol=1e-6)


def test_mesh_entry_points_match_jax(case):
    """The port's make_step and simulate with a mesh against the JAX
    entry point of this case, step by step (make_step) or at the end with
    every step's metrics (simulate)."""
    steps, bucketed = case["steps"], case["bucketed"]
    if case["entry"] == "make_step":
        for s, m, ws, wm in zip(case["stepped"], case["step_metrics"], case["j_states"], case["j_metrics"]):
            _close_to_jax(s, ws)
            _same_metrics(m, wm, bucketed)
    else:
        _close_to_jax(case["final"], case["j_states"][0])
        assert all(tuple(v.shape) == (steps,) for v in case["metrics"].values())
        for i, wm in enumerate(case["j_metrics"]):
            _same_metrics({k: v[i] for k, v in case["metrics"].items()}, wm, bucketed)
    assert int(case["step_metrics"][-1]["viscosity_iters"]) > 0  # the later steps really solve


def test_mesh_make_step_equals_simulate_bitwise(case):
    """On the CPU both entry points run the eager sharded step, the
    geometry built inside each step (make_step) or once (simulate)."""
    last, final = case["stepped"][-1], case["final"]
    for k in "xvcm":
        assert torch.equal(getattr(last.particles, k), getattr(final.particles, k)), k
    assert torch.equal(torch.as_tensor(last.t), torch.as_tensor(final.t))
    for k, v in case["metrics"].items():
        assert torch.equal(v, torch.stack([m[k] for m in case["step_metrics"]])), k


# ---------------------------------------------------------------------------
# the factored distributed loops
# ---------------------------------------------------------------------------

def _scalar_on(t, dev):
    """The old loops' copy of a scalar to a slot's device."""
    return t if t.device == dev else t.to(dev)


def _old_cell_poisson(mesh, b, diag, coefs, precond_diag, *, tol=1e-3, rel_tol=1e-3, max_iter=600):
    """`halo.distributed_cell_poisson` as it was before its loop was split
    into an init and an iteration."""
    pairs = halo._mesh_spatial(mesh)
    spec = halo._block_spec(pairs, b.ndim)
    orig_shape = tuple(b.shape)

    def split(a, fill=0.0):
        return split_blocks(mesh, halo._pad_to_mesh(a, pairs, fill), spec)

    b_l, diag_l, pd_l = split(b), split(diag), split(precond_diag, fill=1.0)
    offs = [tuple(off) for off, _ in coefs]
    coef_ls = [split(c) for _, c in coefs]
    lshape = tuple(b_l[0].shape)
    devs = mesh.devices
    n = mesh.size

    def matvec(p_l):
        p_h = halo._halo_all(mesh, p_l, pairs)
        out = []
        for s in range(n):
            o = diag_l[s] * p_l[s]
            for off, c_l in zip(offs, coef_ls):
                o = o + c_l[s] * halo._slice_offset(p_h[s], off, pairs, lshape)
            out.append(o)
        return out

    r = list(b_l)
    z = [r[s] / pd_l[s] for s in range(n)]
    delta = halo.psum_dot(r, z)
    res0 = halo.psum_dot(r, r)
    thresh = halo.converged_threshold(tol, rel_tol, res0)
    x = [torch.zeros_like(t) for t in b_l]
    d, res, k = z, res0, 0
    while k < max_iter and bool((res >= thresh) & (delta != 0)):
        q = matvec(d)
        dq = halo.psum_dot(d, q)
        alpha = torch.where(dq != 0, delta / dq, torch.zeros_like(dq))
        a_s = [_scalar_on(alpha, dev) for dev in devs]
        x = [x[s] + a_s[s] * d[s] for s in range(n)]
        r = [r[s] - a_s[s] * q[s] for s in range(n)]
        z = [r[s] / pd_l[s] for s in range(n)]
        nd = halo.psum_dot(r, z)
        res = halo.psum_dot(r, r)
        beta = torch.where(delta != 0, nd / delta, torch.zeros_like(nd))
        b_s = [_scalar_on(beta, dev) for dev in devs]
        d = [z[s] + b_s[s] * d[s] for s in range(n)]
        delta = nd
        k += 1
    xg = halo._unpad(gather_blocks(mesh, x, spec), orig_shape)
    return xg, torch.tensor(k, dtype=torch.int32, device=res0.device), res, res0


def _old_coupled_cg(mesh, b_faces, x0_faces, diags, per_axis_terms, precond_diags, *, tol=1e-3, rel_tol=1e-3,
                    max_iter=600):
    """`halo.distributed_coupled_cg` as it was before its loop was split."""
    pairs = halo._mesh_spatial(mesh)
    split_axes = [arr_axis for _, arr_axis, _ in pairs]
    d = len(b_faces)
    shapes = [tuple(v.shape) for v in b_faces]
    common = {arr_axis: halo._padded_extent(max(s[arr_axis] for s in shapes), n_dev) for _, arr_axis, n_dev in pairs}
    spec = halo._block_spec(pairs, len(shapes[0]))
    n = mesh.size
    devs = mesh.devices

    def split(v, fill=0.0):
        for arr_axis, target in common.items():
            v = halo._pad_axis(v, target, arr_axis, fill)
        return split_blocks(mesh, v, spec)

    bs = [split(v) for v in b_faces]
    x0s = [split(v) for v in x0_faces]
    ds = [split(v) for v in diags]
    pds = [split(v, fill=1.0) for v in precond_diags]
    terms = []
    for a in range(d):
        for field, voff, coef in per_axis_terms[a]:
            terms.append((a, field, tuple(int(o) for o in voff), split(coef)))
    lshape = tuple(bs[0][0].shape)
    block_shapes = [tuple(bs[a][0].shape) for a in range(d)]

    def matvec(vs):
        vhs = [halo._halo_all(mesh, vs[f], pairs) for f in range(d)]
        outs = [[ds[a][s] * vs[a][s] for s in range(n)] for a in range(d)]
        for a, field, voff, c_l in terms:
            rest_off = tuple(0 if ax in split_axes else voff[ax] for ax in range(len(voff)))
            tgt = tuple(lshape[ax] if ax in split_axes else block_shapes[a][ax] for ax in range(len(voff)))
            for s in range(n):
                q = vhs[field][s]
                for ax in split_axes:
                    q = q.narrow(ax, 1 + voff[ax], lshape[ax])
                outs[a][s] = outs[a][s] + c_l[s] * sample(q, rest_off, tgt, 0.0)
        return outs

    def gdot(us, vs):
        return halo.psum_dot([tuple(u[s] for u in us) for s in range(n)], [tuple(v[s] for v in vs) for s in range(n)])

    def axpy(alpha, xs, ys):
        a_s = [_scalar_on(alpha, dev) for dev in devs]
        return [[ys[f][s] + a_s[s] * xs[f][s] for s in range(n)] for f in range(d)]

    q0 = matvec(x0s)
    r = [[bs[f][s] - q0[f][s] for s in range(n)] for f in range(d)]
    z = [[r[f][s] / pds[f][s] for s in range(n)] for f in range(d)]
    delta = gdot(r, z)
    res0 = gdot(r, r)
    thresh = halo.converged_threshold(tol, rel_tol, res0)
    x, dd, res, k = x0s, z, res0, 0
    while k < max_iter and bool((res >= thresh) & (delta != 0)):
        q = matvec(dd)
        dq = gdot(dd, q)
        alpha = torch.where(dq != 0, delta / dq, torch.zeros_like(dq))
        x = axpy(alpha, dd, x)
        r = axpy(-alpha, q, r)
        z = [[r[f][s] / pds[f][s] for s in range(n)] for f in range(d)]
        nd = gdot(r, z)
        res = gdot(r, r)
        beta = torch.where(delta != 0, nd / delta, torch.zeros_like(nd))
        dd = axpy(beta, dd, z)
        delta = nd
        k += 1
    xs = tuple(halo._unpad(gather_blocks(mesh, x[f], spec), shapes[f]) for f in range(d))
    return xs, torch.tensor(k, dtype=torch.int32, device=res0.device), res, res0


def _host_while(body, k, res, thresh, delta, max_iter):
    """The WHILE nodes' semantics on the host: each scalar a tensor, or a
    tuple of replicas with one node a device, all running one recorded
    body; every node's test before the first body and after each one
    (every node must agree, or the bodies would part), k + 1 after each
    body.  Records the nodes of each loop in ``_host_while.loops``."""
    ks, ress, threshs, deltas = (t if isinstance(t, tuple) else (t,) for t in (k, res, thresh, delta))
    _host_while.loops.append(len(ks))
    while True:
        go = {bool((r >= t) & (kk < max_iter) & (d != 0)) for kk, r, t, d in zip(ks, ress, threshs, deltas)}
        assert len(go) == 1, "the per-device loops disagree on their exit"
        if not go.pop():
            break
        body()
        for kk in ks:
            kk.add_(1)


_host_while.loops = []


NN = (10, 8, 7)  # x and z extents that divide neither mesh (padded blocks)


def _cell_args(seed=3):
    """A pressure system over a fluid box with random solid fractions and
    a seeded right-hand side on the rows in the system."""
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in NN)
    lphi = torch.ones(NN)
    lphi[2:-2, 2:-3, 2:-2] = -1.0
    sphi = torch.from_numpy(rng.standard_normal(dual).astype(np.float32) + 1.5)
    diag, coefs, pd = pressure_coefficients(tuple(compute_solid_frac_3d(split_parity(sphi, 3))), lphi)
    b = torch.from_numpy(rng.standard_normal(NN).astype(np.float32)) * (diag > 0)
    return (b, diag, coefs, pd), dict(tol=1e-5, rel_tol=1e-5)


def _coupled_args(mesh, seed=11):
    """The materialised viscosity system a mesh's viscosity solve hands
    `distributed_coupled_cg` (tests/test_torch_parallel.py's random
    geometry), recorded from the solve."""
    rng = np.random.default_rng(seed)
    dual = tuple(2 * k + 1 for k in NN)
    sphi = torch.from_numpy(rng.standard_normal(dual).astype(np.float32) + 0.5)
    lvol = torch.from_numpy(np.abs(rng.standard_normal(dual)).astype(np.float32) * 1e-4)
    v = tuple(torch.from_numpy(rng.standard_normal(tuple(k + (1 if i == a else 0) for i, k in enumerate(NN)))
                               .astype(np.float32)) for a in range(3))
    seen, solve = {}, halo.distributed_coupled_cg

    def record(m, *args, **kw):
        seen["args"], seen["kw"] = args, kw
        return solve(m, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(halo, "distributed_coupled_cg", record)
        viscosity.viscosity_solve_3d(1.0 / 60, 1.0, 1000.0, v, sphi, lvol, 0.1**3, mesh=mesh, tol=1e-6,
                                     rel_tol=1e-6, max_iter=400)
    return seen["args"], {k: seen["kw"][k] for k in ("tol", "rel_tol")}


def _solve(kind, solver, mesh, max_iter):
    """(the old loop's, the new host loop's, the new captured loop's results
    and the inputs) of one solve."""
    if solver == "cell":
        args, kw = _cell_args()
        old, new = _old_cell_poisson, halo.distributed_cell_poisson
    else:
        args, kw = _coupled_args(mesh)
        old, new = _old_coupled_cg, halo.distributed_coupled_cg
    return old(mesh, *args, max_iter=max_iter, **kw), new(mesh, *args, max_iter=max_iter, **kw), args, kw, new


def _flat(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("max_iter", [400, 5])
@pytest.mark.parametrize("solver", ["cell", "coupled"])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_factored_distributed_loops_are_the_old_loops_bitwise(kind, solver, max_iter, monkeypatch):
    """x, iterations, residual and initial residual of the host loop and
    of the captured loop's in-place carry, bit for bit the old loop's
    (max_iter 5: the cap ends the loop)."""
    mesh = make_mesh(4, "cpu") if kind == "1d" else make_mesh2d((2, 2), "cpu")
    want, got, args, kw, new = _solve(kind, solver, mesh, max_iter)
    inputs = [t.clone() for t in _flat(args[1])] if solver == "coupled" else []
    monkeypatch.setattr(cg_mod, "capturing", lambda device: True)
    monkeypatch.setattr(cg_mod, "captured_while", _host_while)
    got_captured = new(mesh, *args, max_iter=max_iter, **kw)
    if solver == "coupled":  # x0: the captured loop iterates on buffers of its own
        assert all(torch.equal(a, b) for a, b in zip(inputs, _flat(args[1])))
    assert int(want[1]) == max_iter or max_iter == 400
    assert int(want[1]) > 5 and bool(want[2] < halo.converged_threshold(kw["tol"], kw["rel_tol"], want[3])) \
        or max_iter == 5
    for label, run in (("host", got), ("captured", got_captured)):
        assert all(torch.equal(a, b) for a, b in zip(_flat(run[0]), _flat(want[0]))), label
        assert run[1].dtype == torch.int32 and run[1].dim() == 0 and int(run[1]) == int(want[1]), label
        assert torch.equal(run[2], want[2]) and torch.equal(run[3], want[3]), label


@pytest.mark.parametrize("solver", ["cell", "coupled"])
@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_captured_distributed_loop_runs_one_loop_a_device(kind, solver, monkeypatch):
    """A mesh whose slots sit on two devices ('cpu' and 'cpu:0' are two
    devices to a mesh; the 2D mesh puts each x pair on one of them): under
    capture each distributed solve runs one loop a device, each on that
    device's replicas of the scalars, and returns x, the iterations, the
    residual and res0 bit for bit the eager solve's; the step's replayer
    takes the mesh."""
    if kind == "1d":
        mesh = Mesh(["cpu", "cpu:0"], ("x",), (2,))
    else:
        mesh = Mesh(["cpu", "cpu", "cpu:0", "cpu:0"], ("x", "z"), (2, 2))
    if solver == "cell":
        args, kw = _cell_args()
        solve = halo.distributed_cell_poisson
    else:
        args, kw = _coupled_args(mesh)
        solve = halo.distributed_coupled_cg
    eager = solve(mesh, *args, **kw)
    monkeypatch.setattr(cg_mod, "capturing", lambda device: True)
    monkeypatch.setattr(cg_mod, "captured_while", _host_while)
    _host_while.loops.clear()
    captured = solve(mesh, *args, **kw)
    assert _host_while.loops == [2]  # one loop, one node a device
    assert int(eager[1]) > 0 and captured[1].dtype == torch.int32 and int(captured[1]) == int(eager[1])
    assert all(torch.equal(a, b) for a, b in zip(_flat(captured[0]), _flat(eager[0])))
    assert torch.equal(captured[2], eager[2]) and torch.equal(captured[3], eager[3])
    cfg = buckling_config(dx=DX)
    assert StepReplayer(cfg, buckling_scene(cfg, device="cpu"), mesh=mesh).mesh is mesh


# ---------------------------------------------------------------------------
# the entry points around the captured mesh step
# ---------------------------------------------------------------------------

def test_make_step_and_simulate_hold_the_mesh_in_their_capture_key():
    """`simulate`'s held replayer is reused by a call with the same mesh
    object and ``bucketed`` and replaced otherwise (checked on the CPU,
    where a replayer only allocates its input buffers); `make_step`'s
    replayers capture the sharded step."""
    from python_fluid_simulation_tpu_torch.engine.step import SimulateCapture, build_geom_cache
    from python_fluid_simulation_tpu_torch.parallel.mesh import shard_state

    cfg = buckling_config(dx=DX)
    m4, m4b = make_mesh(4, "cpu"), make_mesh(4, "cpu")
    state = shard_state(buckling_scene(cfg, device="cpu"), m4)
    geom = build_geom_cache(state.solid, m4)
    held = SimulateCapture()
    rep = held.replayer_for(cfg, state, geom, None, m4, False)
    assert (rep.mesh, rep.bucketed) == (m4, False) and rep.branch(state.visc_mg) is None
    assert held.replayer_for(cfg, state, geom, None, m4, False) is rep
    for other in ((m4b, False), (m4, True), (None, False)):
        rep2 = held.replayer_for(cfg, state, geom, None, *other)
        assert rep2 is not rep and (rep2.mesh, rep2.bucketed) == other
        rep = rep2
    assert held.replayers == 4
    auto = held.replayer_for(cfg, state, None, None, m4, False)  # the geometry built on slot 0's device
    assert auto.geom is not None and auto is not rep
    step = make_step(cfg, mesh=m4)
    assert step.replayers == {}  # nothing is captured on the CPU
    s1, m1 = step(state)
    assert int(s1.step_idx) == 1 and "bucket_lost" not in m1


def test_cli_mesh_bucketed_resume_is_bitwise(tmp_path):
    """``--mesh 2 --bucketed`` resumed from its step-2 checkpoint keeps the
    checkpoint's bucketed layout: the same state at step 4, bit for bit,
    as the uninterrupted run."""
    import os
    import shutil

    from python_fluid_simulation_tpu_torch import run as cli

    base = ["--device", "cpu", "--scene", "dam_break", "--dx", "0.125", "--max-steps", "4", "--block", "2",
            "--mesh", "2", "--bucketed", "--checkpoint-every", "2"]
    full = str(tmp_path / "full")
    assert cli.main([*base, "--out", full]) == 0
    ck = tmp_path / "from2"
    ck.mkdir()
    for name in ("config.json", "state_2.npz"):
        shutil.copy(os.path.join(full, "ckpt", name), ck / name)
    resumed = str(tmp_path / "resumed")
    assert cli.main([*base, "--out", resumed, "--resume", str(ck)]) == 0
    with np.load(os.path.join(full, "ckpt", "state_4.npz")) as a, \
            np.load(os.path.join(resumed, "ckpt", "state_4.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        assert int((a["arr_3"] > 0).sum()) == 125  # every particle live
