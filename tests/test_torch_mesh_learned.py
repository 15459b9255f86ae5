"""The learned viscosity modes under a mesh ('unet', 'unet_warm' with
``step_3d(mesh=)``) against the JAX package, on the CPU.

The state: the coarse flagship (``buckling_config(dx=0.05)``, 12x20x12
cells, 1,424 particles) after two 'apic' steps of the port, so that the
viscosity solve has work, its masses made unique; the network: a
width-4 UNet from seeded Flax parameters carried through
``convert.unet_state_dict_from_flax``.

* One step of each mode against JAX ``step_3d(mesh=...)`` (jitted, the
  same weights, from the same state): 'unet' on JAX's ``make_mesh(2)``,
  'unet_warm' on its ``make_mesh2d((2, 2))``.  The port runs each mode on
  ``make_mesh(2, "cpu")`` and ``make_mesh2d((2, 2), "cpu")``, and
  'unet_warm' also bucketed on (2, 2); each is held to its mode's JAX
  step at the sharded-vs-single bars, |dx| < 2e-4 m and |dv| < 2e-3 m/s
  (particles matched by mass where bucketed), every solve converged.
* The warm start under a mesh: the viscosity system of the port's
  'unet_warm' step on (2, 2), and JAX ``viscosity_solve_3d(mesh=,
  warm_start=)`` (eager, JAX's (2, 2) mesh) on the same system, its
  ``distributed_coupled_cg`` replaced in the test by a stub that records
  the x0 it is given: the line search's α within 1e-6 (relative) of the
  exact α of the port's fp32 vectors and within 1e-5 of JAX's (projected
  from that x0), x0 within 1e-6 m/s of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.models.unet3d import UNet3D as JUNet3D
from python_fluid_simulation_tpu.parallel import halo as j_halo
from python_fluid_simulation_tpu.parallel import mesh as j_mesh
from python_fluid_simulation_tpu.solvers import viscosity as j_visc
from python_fluid_simulation_tpu_torch.convert import (
    random_flax_unet_params,
    state_from_numpy,
    state_to_numpy,
    unet_state_dict_from_flax,
)
from python_fluid_simulation_tpu_torch.engine import step as step_mod
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import step_3d
from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
from python_fluid_simulation_tpu_torch.parallel import particles2d as p2d
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, make_mesh2d, shard_state
from python_fluid_simulation_tpu_torch.solvers import viscosity

torch.set_num_threads(1)

DX_BAR, DV_BAR = 2e-4, 2e-3
WIDTH, SEED = 4, 0
JAX_MESH = {"unet": "1d", "unet_warm": "2d"}
MASS_STEP = 1e-6
X0_ATOL = 1e-6  # m/s


def _cfg(mode, cfg=None):
    cfg = cfg or buckling_config(dx=0.05)
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode=mode))


@pytest.fixture(scope="module")
def start():
    """The port's unsharded state after two 'apic' steps, as numpy, the
    masses made unique (m (1 + 1e-6 i): distinct in fp32) to match the
    particles across layouts."""
    cfg = buckling_config(dx=0.05)
    s = buckling_scene(cfg, device="cpu")
    for _ in range(2):
        s, _ = step_3d(s, cfg)
    d = state_to_numpy(s)
    d["m"] = d["m"] * (1.0 + MASS_STEP * np.arange(d["m"].shape[0], dtype=np.float32))
    assert np.unique(d["m"]).shape == d["m"].shape
    return d


@pytest.fixture(scope="module")
def nets():
    params = random_flax_unet_params(WIDTH, seed=SEED)
    net = UNet3D(width=WIDTH).eval()
    net.load_state_dict(unet_state_dict_from_flax(params))
    return net, jax.tree.map(jnp.asarray, params)


def _jax_state(d):
    from python_fluid_simulation_tpu.state import Particles, SimState, SolidState

    return SimState(Particles(*(jnp.asarray(d[k]) for k in "xvcm")),
                    SolidState(*(jnp.asarray(d[k]) for k in ("phi", "sv", "rb"))),
                    jnp.asarray(d["t"]), jnp.asarray(d["step_idx"]), jnp.asarray(d["visc_mg"]))


def _jax_mesh(kind):
    return j_mesh.make_mesh(2) if kind == "1d" else j_mesh.make_mesh2d((2, 2))


@pytest.fixture(scope="module")
def jax_steps(start, nets):
    """One jitted JAX mesh step a mode from the start state."""
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_buckling
    from python_fluid_simulation_tpu.engine.step import step_3d as j_step

    _, jparams = nets
    out = {}
    for mode, kind in JAX_MESH.items():
        j_cfg = _cfg(mode, j_buckling(dx=0.05))
        jm = _jax_mesh(kind)
        state = j_mesh.shard_state(_jax_state(start), jm)
        s, m = jax.jit(lambda st, p: j_step(st, j_cfg, JUNet3D(width=WIDTH).apply, p, mesh=jm))(state, jparams)
        out[mode] = jax.device_get((s.particles, m))
    return out


def _port_mesh(kind):
    return make_mesh(2, "cpu") if kind == "1d" else make_mesh2d((2, 2), "cpu")


def _matched(x, v, m):
    live = m > 0
    order = np.argsort(m[live], kind="stable")
    return x[live][order], v[live][order], m[live][order]


@pytest.mark.parametrize("mode, kind, bucketed", [("unet", "1d", False), ("unet", "2d", False),
                                                  ("unet_warm", "1d", False), ("unet_warm", "2d", False),
                                                  ("unet_warm", "2d", True)])
def test_learned_mesh_step_matches_jax_mesh_step(start, nets, jax_steps, mode, kind, bucketed):
    net, _ = nets
    cfg = _cfg(mode)
    mesh = _port_mesh(kind)
    state = shard_state(state_from_numpy(start, device="cpu"), mesh)
    n = int(state.particles.x.shape[0])
    if bucketed:
        g = cfg.grid
        spec = p2d.make_bucket_spec_2d((2, 2), g.res[0], g.res[2], n, positions=state.particles.x,
                                       bound_min=g.bound_min, cell_size=g.cell_size)
        p = p2d.bucket_particles_2d(state.particles, mesh, spec, g.bound_min, g.cell_size)
        state = dataclasses.replace(state, particles=p)
    out, m = step_3d(state, cfg, unet=net, mesh=mesh, bucketed=bucketed)
    for k in ("density", "viscosity", "pressure"):
        assert bool(m[f"{k}_converged"]), k
    if mode == "unet":
        assert int(m["viscosity_iters"]) == 0
    else:
        assert int(m["viscosity_iters"]) > 0
    jp, jm = jax_steps[mode]
    for k in ("density", "viscosity", "pressure"):
        assert abs(int(m[f"{k}_iters"]) - int(jm[f"{k}_iters"])) <= 2, (k, int(m[f"{k}_iters"]), int(jm[f"{k}_iters"]))
    jx, jv = np.asarray(jp.x)[:n], np.asarray(jp.v)[:n]
    x, v = out.particles.x.numpy(), out.particles.v.numpy()
    if bucketed:
        assert int(m["bucket_lost"]) == 0
        x, v, mm = _matched(x, v, out.particles.m.numpy())
        jx, jv, jmm = _matched(jx, jv, np.asarray(jp.m)[:n])
        np.testing.assert_array_equal(mm, jmm)
    dx, dv = float(np.abs(x - jx).max()), float(np.abs(v - jv).max())
    assert dx < DX_BAR and dv < DV_BAR, (dx, dv)


def test_warm_start_under_a_mesh_matches_jax(start, nets, monkeypatch):
    """The line search of the port's (2, 2) 'unet_warm' step against
    JAX ``viscosity_solve_3d(mesh=, warm_start=)`` on the same system."""
    net, _ = nets
    mesh = make_mesh2d((2, 2), "cpu")
    calls, alphas = [], []
    line, solve = viscosity.rescaled_warm_start, viscosity.viscosity_solve_3d

    def rec_line(*a, **k):
        out = line(*a, **k)
        alphas.append((a, out))
        return out

    def rec_solve(*a, **k):
        calls.append((a, k))
        return solve(*a, **k)

    monkeypatch.setattr(viscosity, "rescaled_warm_start", rec_line)
    monkeypatch.setattr(step_mod, "viscosity_solve_3d", rec_solve)
    step_3d(shard_state(state_from_numpy(start, device="cpu"), mesh), _cfg("unet_warm"), unet=net, mesh=mesh)
    assert len(alphas) == 1 and len(calls) == 1
    (matvec, b, ext, warm), (x0, alpha) = alphas[0]
    (dt, mu, rho, v_faces, sphi_c, lvol, cell_vol), kw = calls[0]
    assert kw["mesh"] is mesh

    j_x0 = []

    def j_cg_start(m_, b_, x0_, *a, **k):  # records the start; the solve itself is held by the step test
        j_x0.append(x0_)
        return x0_, jnp.int32(0), jnp.float32(0.0), jnp.float32(1.0)

    monkeypatch.setattr(j_halo, "distributed_coupled_cg", j_cg_start)

    def jnp_(t):
        return jnp.asarray(np.asarray(t))

    j_visc.viscosity_solve_3d(
        jnp_(dt), mu, rho, tuple(jnp_(v) for v in v_faces), {k: jnp_(v) for k, v in sphi_c.items()},
        {k: jnp_(v) for k, v in lvol.items()}, cell_vol, tol=kw["tol"], rel_tol=kw["rel_tol"],
        max_iter=kw["max_iter"], jacobi_precond=kw["jacobi_precond"], use_pallas="off",
        mesh=j_mesh.make_mesh2d((2, 2)), warm_start=tuple(jnp_(w) for w in kw["warm_start"]))
    assert len(j_x0) == 1

    def f64(ts):
        return np.concatenate([np.asarray(t).reshape(-1).astype(np.float64) for t in ts])

    p = tuple(w - e for w, e in zip(warm, ext))
    ap, r = matvec(p), tuple(bb - q for bb, q in zip(b, matvec(ext)))
    exact = float(f64(r) @ f64(ap) / (f64(ap) @ f64(ap)))
    assert float(alpha) != 0.0 and abs(float(alpha) - exact) <= 1e-6 * abs(exact), (float(alpha), exact)
    j_alpha = float((f64(j_x0[0]) - f64(ext)) @ f64(p) / (f64(p) @ f64(p)))
    assert abs(float(alpha) - j_alpha) <= 1e-5 * abs(j_alpha), (float(alpha), j_alpha)
    for a in range(3):
        np.testing.assert_allclose(x0[a].numpy(), np.asarray(j_x0[0][a]), atol=X0_ATOL, rtol=0)
