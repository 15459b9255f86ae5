"""Bucketed particle residency on a 1D slab mesh (``parallel/particles.py``)
against the JAX package, on the CPU: JAX on its 8-CPU mesh, the port on
``make_mesh(8, "cpu")``, from tests/test_bucketed.py's inputs.

* ``make_bucket_spec``, ``bucket_particles`` and ``rebucket``: bitwise
  the JAX package's (the same rows in the same slots in the same order,
  inert rows included) and the same ``lost``, also where an exchange
  buffer or a bucket overflows;
* each shard-local transfer (P2G with the volume classes, the level set,
  G2P, the density scatter and the displacement gather) against the JAX
  package's at tests/test_bucketed.py's tolerances, and against the
  port's own unsharded transfer;
* one bucketed step on tests/test_parallel.py:346-387's scene (the dam
  break at dx 1/16, masses made unique) against JAX ``make_step(cfg,
  mesh=make_mesh(8), bucketed=True)``: the same particle set, |dx| <
  2e-4, |dv| < 2e-3, ``bucket_lost`` 0 on both sides; and the same
  particles bucketed on an (x, z) mesh, one step at the same bars;
* on slabs of an odd width (3, 5 and 7 cells): the transfers and two
  bucketed steps against the port's unsharded ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.parallel import mesh as j_mesh
from python_fluid_simulation_tpu.parallel import particles as j_part
from python_fluid_simulation_tpu.state import Particles as JParticles
from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset
from python_fluid_simulation_tpu_torch.ops.transfers import g2p_all, p2g_all
from python_fluid_simulation_tpu_torch.parallel import particles as part
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh
from python_fluid_simulation_tpu_torch.solvers.density import apply_displacement, scatter_mass_volume
from python_fluid_simulation_tpu_torch.state import Particles

torch.set_num_threads(1)

GRES = (16, 9, 7)
BMIN = (-0.3, 0.0, -0.2)
H = (0.05, 0.05, 0.05)
BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
FSH = [tuple(n + (1 if i == a else 0) for i, n in enumerate(GRES)) for a in range(3)]
VOL = (1e-5, tuple(hh / 2 for hh in H))


def _inputs(k=3000, seed=5):
    """tests/test_bucketed.py's particles (numpy) and its generator."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(BMIN[a] + 1e-4, BMIN[a] + GRES[a] * H[a] - 1e-4, k) for a in range(3)],
                 -1).astype(np.float32)
    arrs = (x, rng.normal(size=(k, 3)).astype(np.float32), rng.normal(size=(k, 3, 3)).astype(np.float32),
            (rng.random(k) + 0.5).astype(np.float32))
    return arrs, rng


def _jp(arrs):
    return JParticles(*(jnp.asarray(a) for a in arrs))


def _tp(arrs):
    return Particles(*(torch.from_numpy(np.array(a)) for a in arrs))


def _same(t_particles, j_particles):
    for k in "xvcm":
        got, want = getattr(t_particles, k).numpy(), np.asarray(getattr(j_particles, k))
        assert got.dtype == want.dtype and np.array_equal(got.view(np.int32), want.view(np.int32)), k


@pytest.fixture(scope="module")
def meshes():
    return j_mesh.make_mesh(8), make_mesh(8, "cpu")


@pytest.fixture(scope="module")
def bucketed(meshes):
    jm, tm = meshes
    arrs, rng = _inputs()
    spec = part.make_bucket_spec(8, GRES[0], arrs[0].shape[0])
    assert spec == tuple(j_part.make_bucket_spec(8, GRES[0], arrs[0].shape[0]))
    jb = jax.device_get(j_part.bucket_particles(_jp(arrs), jm, j_part.BucketSpec(*spec), BMIN, H))
    return arrs, rng, spec, jb


def test_bucket_particles_bitwise_jax(meshes, bucketed):
    jm, tm = meshes
    arrs, _, spec, jb = bucketed
    _same(part.bucket_particles(_tp(arrs), tm, spec, BMIN, H), jb)
    # a bucket too small for its slab: the rows past cap are dropped the same way
    small = part.BucketSpec(8, 200, 64, 2)
    got = part.bucket_particles(_tp(arrs), tm, small, BMIN, H)
    _same(got, jax.device_get(j_part.bucket_particles(_jp(arrs), jm, j_part.BucketSpec(*small), BMIN, H)))
    assert int((got.m > 0).sum()) == 8 * 200
    # the spec from positions (the fullest slab)
    pos_spec = part.make_bucket_spec(8, GRES[0], 3000, positions=torch.from_numpy(arrs[0]), bound_min=BMIN,
                                     cell_size=H)
    assert pos_spec == tuple(j_part.make_bucket_spec(8, GRES[0], 3000, positions=arrs[0], bound_min=BMIN, cell_size=H))
    assert part.spec_from_state(8 * spec.cap, 8, GRES[0]) == tuple(j_part.spec_from_state(8 * spec.cap, 8, GRES[0]))


@pytest.mark.parametrize("exchange_cap", [None, 16])
def test_rebucket_bitwise_jax(meshes, bucketed, exchange_cap):
    """Every particle moved by up to 0.9 cells (tests/test_bucketed.py's
    move); with an exchange buffer of 16 rows the crossers overflow it and
    ``lost`` > 0."""
    jm, tm = meshes
    _, rng, spec, jb = bucketed
    if exchange_cap is not None:
        spec = part.BucketSpec(spec.n_dev, spec.cap, exchange_cap, spec.slab_w)
    bx, bm = np.asarray(jb.x), np.asarray(jb.m)
    shift = (np.random.default_rng(11).uniform(-0.9, 0.9, (bx.shape[0],)) * H[0]).astype(np.float32)
    x = bx.copy()
    x[:, 0] += np.where(bm > 0, shift, np.float32(0.0))
    lo, hi = np.asarray(BMIN, np.float32) + np.float32(1e-4), np.asarray(BMIN, np.float32) + np.asarray(GRES) * \
        np.asarray(H, np.float32) - np.float32(1e-4)
    x = np.clip(x, lo, hi).astype(np.float32)
    moved = (x, np.asarray(jb.v), np.asarray(jb.c), bm)
    j_out, j_lost = jax.jit(lambda pp: j_part.rebucket(pp, jm, j_part.BucketSpec(*spec), BMIN, H))(_jp(moved))
    t_out, t_lost = part.rebucket(_tp(moved), tm, spec, BMIN, H)
    _same(t_out, jax.device_get(j_out))
    assert int(t_lost) == int(j_lost)
    assert (int(t_lost) > 0) == (exchange_cap is not None)
    if exchange_cap is None:
        live = t_out.m > 0
        assert int(live.sum()) == int((bm > 0).sum())
        slab = np.clip(np.floor((t_out.x[:, 0].numpy() - BMIN[0]) / H[0]).astype(int), 0, GRES[0] - 1) // spec.slab_w
        assert np.all(~live.numpy() | (slab == np.arange(8).repeat(spec.cap)))


def _close(got, want, atol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, err_msg=name)


def test_sharded_p2g_levelset_match_jax(meshes, bucketed):
    jm, tm = meshes
    arrs, _, spec, jb = bucketed
    jspec = j_part.BucketSpec(*spec)
    gms_j, gvs_j, cls_j, _ = jax.jit(lambda bp: j_part.sharded_p2g_all(bp, jm, jspec, GRES, FSH, BIAS, BMIN, H,
                                                                        volume=VOL))(jb)
    tb = _tp((jb.x, jb.v, jb.c, jb.m))
    gms, gvs, cls, _ = part.sharded_p2g_all(tb, tm, spec, GRES, FSH, BIAS, BMIN, H, volume=VOL)
    gms_u, gvs_u, cls_u = p2g_all(tb.x, tb.m, tb.v, tb.c, GRES, FSH, BIAS, BMIN, H, volume=VOL)
    for a in range(3):
        for got, want, uns, name in ((gms[a], gms_j[a], gms_u[a], "gm"), (gvs[a], gvs_j[a], gvs_u[a], "gv")):
            assert tuple(got.shape) == FSH[a]
            _close(got, want, 5e-4, f"{name} {a}")
            _close(got, uns, 5e-4, f"{name} {a} vs unsharded")
    assert set(cls) == set(cls_j)
    for k in cls_j:
        _close(cls[k], cls_j[k], 1e-8, f"volume class {k}")
        _close(cls[k], cls_u[k], 1e-8, f"volume class {k} vs unsharded")
    lphi_j = jax.jit(lambda bp: j_part.sharded_fluid_levelset(bp.x, bp.m, jm, jspec, GRES, BMIN, H, H[0]))(jb)
    lphi = part.sharded_fluid_levelset(tb.x, tb.m, tm, spec, GRES, BMIN, H, H[0])
    _close(lphi, lphi_j, 1e-6, "level set")
    _close(lphi, compute_fluid_levelset(tb.x, GRES, BMIN, H, H[0], pm=tb.m), 1e-6, "level set vs unsharded")


def test_sharded_g2p_and_displacement_match_jax(meshes, bucketed):
    jm, tm = meshes
    _, _, spec, jb = bucketed
    jspec = j_part.BucketSpec(*spec)
    rng = np.random.default_rng(6)
    tb = _tp((jb.x, jb.v, jb.c, jb.m))
    live = tb.m.numpy() > 0
    gvs = [rng.normal(size=s).astype(np.float32) for s in FSH]
    _, _, si_j = jax.jit(lambda bp: j_part.sharded_p2g_all(bp, jm, jspec, GRES, FSH, BIAS, BMIN, H))(jb)
    pv_j, pc_j = jax.jit(lambda s_: j_part.sharded_g2p_all([jnp.asarray(g) for g in gvs], jm, jspec, GRES, BIAS, BMIN,
                                                           H, s_))(si_j)
    _, _, si = part.sharded_p2g_all(tb, tm, spec, GRES, FSH, BIAS, BMIN, H)
    pv, pc = part.sharded_g2p_all([torch.from_numpy(g) for g in gvs], tm, spec, GRES, BIAS, BMIN, H, si)
    _close(pv.numpy()[live], np.asarray(pv_j)[live], 1e-4, "pv")
    _close(pc.numpy()[live], np.asarray(pc_j)[live], 1e-3, "pc")
    _, _, usi = p2g_all(tb.x, tb.m, tb.v, tb.c, GRES, FSH, BIAS, BMIN, H, with_sort_info=True)
    pv_u, pc_u = g2p_all([torch.from_numpy(g) for g in gvs], GRES, BIAS, BMIN, H, usi)
    _close(pv.numpy()[live], pv_u.numpy()[live], 1e-4, "pv vs unsharded")
    _close(pc.numpy()[live], pc_u.numpy()[live], 1e-3, "pc vs unsharded")

    # the density scatter and the displacement gather
    gm_j, gvol_j, sid_j = jax.jit(lambda bp: j_part.sharded_scatter_mass_volume(bp.x, bp.m, jm, jspec, GRES, 1e-5,
                                                                                BMIN, H))(jb)
    gm, gvol, sid = part.sharded_scatter_mass_volume(tb.x, tb.m, tm, spec, GRES, 1e-5, BMIN, H)
    _close(gm, gm_j, 5e-4, "density gm")
    _close(gvol, gvol_j, 1e-8, "density gvol")
    gm_u, gvol_u = scatter_mass_volume(tb.x, tb.m, 1e-5, GRES, BMIN, H)
    _close(gm, gm_u, 5e-4, "density gm vs unsharded")
    _close(gvol, gvol_u, 1e-8, "density gvol vs unsharded")
    disp = [(rng.normal(size=s) * 0.01).astype(np.float32) for s in FSH]
    d_j = jax.jit(lambda s_: j_part.sharded_apply_displacement([jnp.asarray(d) for d in disp], jm, jspec, GRES, BMIN,
                                                               H, s_))(sid_j)
    d_t = part.sharded_apply_displacement([torch.from_numpy(d) for d in disp], tm, spec, GRES, BMIN, H, sid)
    _close(d_t.numpy()[live], np.asarray(d_j)[live], 1e-5, "displacement")
    ref = apply_displacement(tb.x, [torch.from_numpy(d) for d in disp], BMIN, H)
    _close((tb.x + d_t).numpy()[live], ref.numpy()[live], 1e-5, "displacement vs unsharded")


def test_bucketed_step_matches_jax_bucketed_make_step(meshes):
    """tests/test_parallel.py:346-387's scene, one bucketed step on each
    side from the same bucketed state."""
    from python_fluid_simulation_tpu.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
    from python_fluid_simulation_tpu.engine.scenes import dam_break_scene
    from python_fluid_simulation_tpu.engine.step import make_step as j_make_step
    from python_fluid_simulation_tpu_torch import config as t_config
    from python_fluid_simulation_tpu_torch.convert import state_from_numpy
    from python_fluid_simulation_tpu_torch.engine.step import step_3d

    jm, tm = meshes
    kw = dict(physics=dict(mu=0.2, dt=1.0 / 60.0), solver=dict(max_iter=200))
    j_cfg = SimConfig(grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / 16),
                      physics=PhysicsConfig(**kw["physics"]), solver=SolverConfig(**kw["solver"]), particle_dx=1.0 / 32)
    cfg = t_config.SimConfig.from_json(j_cfg.to_json())
    state = dam_break_scene(j_cfg)
    n = state.particles.x.shape[0]
    pm = np.asarray(state.particles.m) * (1.0 + 1e-4 * np.arange(n, dtype=np.float32))
    g = j_cfg.grid
    spec = part.make_bucket_spec(8, g.res[0], n, positions=np.asarray(state.particles.x), bound_min=g.bound_min,
                                 cell_size=g.cell_size)
    jp = j_part.bucket_particles(state.particles._replace(m=jnp.asarray(pm)), jm, j_part.BucketSpec(*spec),
                                 g.bound_min, g.cell_size)
    j_state = state._replace(particles=jp)
    out_j, m_j = j_make_step(j_cfg, mesh=jm, bucketed=True)(j_state)
    assert int(m_j["bucket_lost"]) == 0
    start = {"x": jp.x, "v": jp.v, "c": jp.c, "m": jp.m, "phi": state.solid.phi, "sv": state.solid.v,
             "rb": state.solid.rb, "t": state.t, "step_idx": state.step_idx}
    t_state = state_from_numpy({k: np.asarray(v) for k, v in start.items()}, device="cpu")
    _same(part.bucket_particles(_tp((state.particles.x, state.particles.v, state.particles.c, pm)), tm, spec,
                                g.bound_min, g.cell_size), jax.device_get(jp))
    out, m = step_3d(t_state, cfg, mesh=tm, bucketed=True)
    assert int(m["bucket_lost"]) == 0 and m["bucket_lost"].dtype == torch.int32
    for k in ("density", "viscosity", "pressure"):
        assert bool(m[f"{k}_converged"]), k
    mb, mj = out.particles.m.numpy(), np.asarray(out_j.particles.m)
    ob, oj = np.argsort(mb[mb > 0]), np.argsort(mj[mj > 0])
    np.testing.assert_array_equal(mb[mb > 0][ob], mj[mj > 0][oj])  # the same particle set
    assert (mb > 0).sum() == n
    for k, bar in (("x", 2e-4), ("v", 2e-3)):
        got = getattr(out.particles, k).numpy()[mb > 0][ob]
        want = np.asarray(getattr(out_j.particles, k))[mj > 0][oj]
        assert float(np.abs(got - want).max()) < bar, k
    assert dataclasses.is_dataclass(out)
    # the same particles bucketed on an (x, z) mesh: the same bars against JAX's step
    from python_fluid_simulation_tpu_torch.parallel import particles2d as p2d
    from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh2d

    m2 = make_mesh2d((2, 2), "cpu")
    spec2 = p2d.make_bucket_spec_2d((2, 2), g.res[0], g.res[2], n, positions=t_state.particles.x,
                                    bound_min=g.bound_min, cell_size=g.cell_size)
    s2 = dataclasses.replace(t_state, particles=p2d.bucket_particles_2d(t_state.particles, m2, spec2, g.bound_min,
                                                                        g.cell_size))
    out2, m_2 = step_3d(s2, cfg, mesh=m2, bucketed=True)
    assert int(m_2["bucket_lost"]) == 0
    m2b = out2.particles.m.numpy()
    o2 = np.argsort(m2b[m2b > 0])
    np.testing.assert_array_equal(m2b[m2b > 0][o2], mj[mj > 0][oj])
    for k, bar in (("x", 2e-4), ("v", 2e-3)):
        got = getattr(out2.particles, k).numpy()[m2b > 0][o2]
        want = np.asarray(getattr(out_j.particles, k))[mj > 0][oj]
        assert float(np.abs(got - want).max()) < bar, k


@pytest.mark.parametrize("slots, res", [(2, 10), (5, 15)])
def test_bucketed_steps_on_odd_slabs_match_the_unsharded_steps(slots, res):
    """Slabs of an odd width (5 and 3 cells, as coiling_config(504)'s 63
    on two slots): two bucketed dam-break steps (masses made unique)
    against the port's unsharded steps from the same particles, at the
    sharded-vs-unsharded bars, with nothing lost."""
    from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig, SolverConfig
    from python_fluid_simulation_tpu_torch.engine.scenes import dam_break_scene
    from python_fluid_simulation_tpu_torch.engine.step import step_3d
    from python_fluid_simulation_tpu_torch.parallel.mesh import shard_state

    cfg = SimConfig(grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=1.0 / res),
                    physics=PhysicsConfig(mu=0.2, dt=1.0 / 60.0), solver=SolverConfig(max_iter=200),
                    particle_dx=0.5 / res)
    state = dam_break_scene(cfg, device="cpu")
    n = state.particles.x.shape[0]
    pm = state.particles.m * (1.0 + 1e-4 * torch.arange(n, dtype=torch.float32))
    state = dataclasses.replace(state, particles=dataclasses.replace(state.particles, m=pm))
    g, tm = cfg.grid, make_mesh(slots, "cpu")
    spec = part.make_bucket_spec(slots, g.res[0], n, positions=state.particles.x, bound_min=g.bound_min,
                                 cell_size=g.cell_size)
    assert spec.slab_w == res // slots and spec.slab_w % 2 == 1
    sharded = shard_state(state, tm)
    b = dataclasses.replace(sharded, particles=part.bucket_particles(sharded.particles, tm, spec, g.bound_min,
                                                                     g.cell_size))
    u = state
    for _ in range(2):
        b, m = step_3d(b, cfg, mesh=tm, bucketed=True)
        u, _ = step_3d(u, cfg)
        assert int(m["bucket_lost"]) == 0
        assert all(bool(m[f"{k}_converged"]) for k in ("density", "viscosity", "pressure"))
        mb = b.particles.m
        live = mb > 0
        ob, ou = torch.argsort(mb[live]), torch.argsort(u.particles.m)
        assert torch.equal(mb[live][ob], u.particles.m[ou])  # the same particle set
        for k, bar in (("x", 2e-4), ("v", 2e-3)):
            err = float((getattr(b.particles, k)[live][ob] - getattr(u.particles, k)[ou]).abs().max())
            assert err < bar, (k, err)


@pytest.mark.parametrize("slots, nx", [(5, 15), (3, 21)])
def test_sharded_transfers_on_odd_slabs_match_unsharded(slots, nx):
    """Slabs of 3 and 7 cells: the shard-local P2G (with the trailing
    (nx + 1) face plane the last slot keeps apart), level set, G2P and
    density scatter against the port's unsharded transfers on the same
    particles, at tests/test_bucketed.py's tolerances."""
    gres = (nx,) + GRES[1:]
    fsh = [tuple(n + (1 if i == a else 0) for i, n in enumerate(gres)) for a in range(3)]
    rng = np.random.default_rng(7)
    k = 2000
    x = np.stack([rng.uniform(BMIN[a] + 1e-4, BMIN[a] + gres[a] * H[a] - 1e-4, k) for a in range(3)],
                 -1).astype(np.float32)
    arrs = (x, rng.normal(size=(k, 3)).astype(np.float32), rng.normal(size=(k, 3, 3)).astype(np.float32),
            (rng.random(k) + 0.5).astype(np.float32))
    tm = make_mesh(slots, "cpu")
    spec = part.make_bucket_spec(slots, nx, k, positions=torch.from_numpy(x), bound_min=BMIN, cell_size=H)
    assert spec.slab_w % 2 == 1
    tb = part.bucket_particles(_tp(arrs), tm, spec, BMIN, H)
    assert int((tb.m > 0).sum()) == k
    gms, gvs, cls, si = part.sharded_p2g_all(tb, tm, spec, gres, fsh, BIAS, BMIN, H, volume=VOL)
    gms_u, gvs_u, cls_u, usi = p2g_all(tb.x, tb.m, tb.v, tb.c, gres, fsh, BIAS, BMIN, H, volume=VOL,
                                       with_sort_info=True)
    for a in range(3):
        assert tuple(gms[a].shape) == fsh[a]
        _close(gms[a], gms_u[a], 5e-4, f"gm {a}")
        _close(gvs[a], gvs_u[a], 5e-4, f"gv {a}")
    assert set(cls) == set(cls_u)
    for key in cls_u:
        _close(cls[key], cls_u[key], 1e-8, f"volume class {key}")
    lphi = part.sharded_fluid_levelset(tb.x, tb.m, tm, spec, gres, BMIN, H, H[0])
    _close(lphi, compute_fluid_levelset(tb.x, gres, BMIN, H, H[0], pm=tb.m), 1e-6, "level set")
    live = tb.m.numpy() > 0
    gvs_in = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in fsh]
    pv, pc = part.sharded_g2p_all(gvs_in, tm, spec, gres, BIAS, BMIN, H, si)
    pv_u, pc_u = g2p_all(gvs_in, gres, BIAS, BMIN, H, usi)
    _close(pv.numpy()[live], pv_u.numpy()[live], 1e-4, "pv")
    _close(pc.numpy()[live], pc_u.numpy()[live], 1e-3, "pc")
    gm, gvol, _ = part.sharded_scatter_mass_volume(tb.x, tb.m, tm, spec, gres, 1e-5, BMIN, H)
    gm_u, gvol_u = scatter_mass_volume(tb.x, tb.m, 1e-5, gres, BMIN, H)
    _close(gm, gm_u, 5e-4, "density gm")
    _close(gvol, gvol_u, 1e-8, "density gvol")
