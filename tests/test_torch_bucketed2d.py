"""Bucketed particle residency on an (x, z) mesh (``parallel/particles2d.py``)
against the JAX package, on the CPU: JAX on its 8-CPU mesh arranged (4, 2),
the port on ``make_mesh2d((4, 2), "cpu")``, from tests/test_bucketed2d.py's
inputs (GRES (16, 9, 8), 3,000 particles, seed 5).

* ``make_bucket_spec_2d``, ``bucket_particles_2d`` and ``rebucket_2d``:
  bitwise the JAX package's (the same rows in the same slots in the same
  order, inert rows included) and the same ``lost``, also where an
  exchange buffer overflows; the slot order is ``parallel/mesh.py::
  _slot_coords``'; ``spec_from_state_2d`` refuses a slab one cell wide;
* each shard-local transfer against the JAX package's at
  tests/test_bucketed2d.py's tolerances: P2G's face grids, and each
  parity-class volume split into its owned block, its x tail (plane nx),
  its z tail (plane nz) and its corner line; the level set; G2P; the
  density scatter and the displacement gather.

JAX's transfers are computed once for the module (one jitted P2G with the
volume classes serves G2P's sort too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.parallel import mesh as j_mesh
from python_fluid_simulation_tpu.parallel import particles2d as j_p2d
from python_fluid_simulation_tpu.state import Particles as JParticles
from python_fluid_simulation_tpu_torch.parallel import particles2d as p2d
from python_fluid_simulation_tpu_torch.parallel.mesh import _slot_coords, make_mesh2d
from python_fluid_simulation_tpu_torch.state import Particles

torch.set_num_threads(1)

MESH_SHAPE = (4, 2)
GRES = (16, 9, 8)
BMIN = (-0.3, 0.0, -0.2)
H = (0.05, 0.05, 0.05)
BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
FSH = [tuple(n + (1 if i == a else 0) for i, n in enumerate(GRES)) for a in range(3)]
VOL = (1e-5, tuple(hh / 2 for hh in H))
CLASSES = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def _inputs(k=3000, seed=5):
    """tests/test_bucketed2d.py's particles (numpy) and its generator."""
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


def _close(got, want, atol, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def meshes():
    return j_mesh.make_mesh2d(MESH_SHAPE), make_mesh2d(MESH_SHAPE, "cpu")


@pytest.fixture(scope="module")
def bucketed(meshes):
    jm, _ = meshes
    arrs, rng = _inputs()
    spec = p2d.make_bucket_spec_2d(MESH_SHAPE, GRES[0], GRES[2], arrs[0].shape[0])
    assert spec == tuple(j_p2d.make_bucket_spec_2d(MESH_SHAPE, GRES[0], GRES[2], arrs[0].shape[0]))
    jb = jax.device_get(j_p2d.bucket_particles_2d(_jp(arrs), jm, j_p2d.BucketSpec2D(*spec), BMIN, H))
    return arrs, rng, spec, jb


@pytest.fixture(scope="module")
def jax_transfers(meshes, bucketed):
    """The JAX package's shard-local transfers on the bucketed particles."""
    jm, _ = meshes
    _, _, spec, jb = bucketed
    jspec = j_p2d.BucketSpec2D(*spec)
    rng = np.random.default_rng(6)
    gvs = [rng.normal(size=s).astype(np.float32) for s in FSH]
    disp = [(rng.normal(size=s) * 0.01).astype(np.float32) for s in FSH]
    gms, gv, cls, si = jax.jit(lambda bp: j_p2d.sharded_p2g_all_2d(bp, jm, jspec, GRES, FSH, BIAS, BMIN, H,
                                                                    volume=VOL))(jb)
    lphi = jax.jit(lambda bp: j_p2d.sharded_fluid_levelset_2d(bp.x, bp.m, jm, jspec, GRES, BMIN, H, H[0]))(jb)
    pv, pc = jax.jit(lambda s_: j_p2d.sharded_g2p_all_2d([jnp.asarray(g) for g in gvs], jm, jspec, GRES, BIAS, BMIN,
                                                         H, s_))(si)
    gm, gvol, sid = jax.jit(lambda bp: j_p2d.sharded_scatter_mass_volume_2d(bp.x, bp.m, jm, jspec, GRES, 1e-5, BMIN,
                                                                            H))(jb)
    d = jax.jit(lambda s_: j_p2d.sharded_apply_displacement_2d([jnp.asarray(x) for x in disp], jm, jspec, GRES, BMIN,
                                                               H, s_))(sid)
    out = dict(gms=gms, gvs=gv, cls=cls, lphi=lphi, pv=pv, pc=pc, gm=gm, gvol=gvol, disp_out=d)
    return dict(jax.device_get(out), g2p_in=gvs, disp_in=disp)


@pytest.fixture(scope="module")
def port_transfers(meshes, bucketed):
    _, tm = meshes
    _, _, spec, jb = bucketed
    tb = _tp((jb.x, jb.v, jb.c, jb.m))
    gms, gvs, cls, si = p2d.sharded_p2g_all_2d(tb, tm, spec, GRES, FSH, BIAS, BMIN, H, volume=VOL)
    gm, gvol, sid = p2d.sharded_scatter_mass_volume_2d(tb.x, tb.m, tm, spec, GRES, 1e-5, BMIN, H)
    return dict(tb=tb, gms=gms, gvs=gvs, cls=cls, si=si, gm=gm, gvol=gvol, sid=sid)


def test_bucket_particles_2d_bitwise_jax(meshes, bucketed):
    jm, tm = meshes
    arrs, _, spec, jb = bucketed
    _same(p2d.bucket_particles_2d(_tp(arrs), tm, spec, BMIN, H), jb)
    # a bucket too small for its slot: the rows past cap are dropped the same way
    small = p2d.BucketSpec2D(4, 2, 200, 64, 4, 4)
    got = p2d.bucket_particles_2d(_tp(arrs), tm, small, BMIN, H)
    _same(got, jax.device_get(j_p2d.bucket_particles_2d(_jp(arrs), jm, j_p2d.BucketSpec2D(*small), BMIN, H)))
    assert int((got.m > 0).sum()) == 8 * 200
    # the spec from positions (the fullest slot) and from a bucketed state
    pos_spec = p2d.make_bucket_spec_2d(MESH_SHAPE, GRES[0], GRES[2], 3000, positions=torch.from_numpy(arrs[0]),
                                       bound_min=BMIN, cell_size=H)
    assert pos_spec == tuple(j_p2d.make_bucket_spec_2d(MESH_SHAPE, GRES[0], GRES[2], 3000, positions=arrs[0],
                                                       bound_min=BMIN, cell_size=H))
    assert p2d.spec_from_state_2d(8 * spec.cap, tm, GRES[0], GRES[2]) == tuple(
        j_p2d.spec_from_state_2d(8 * spec.cap, jm, GRES[0], GRES[2]))


def test_slot_order_is_the_mesh_slot_order(meshes, bucketed):
    """Rows [s * cap, (s + 1) * cap) hold the particles of slot s, whose
    (x, z) position is ``_slot_coords(mesh, s)``: ix * n_z + iz."""
    _, tm = meshes
    arrs, _, spec, _ = bucketed
    got = p2d.bucket_particles_2d(_tp(arrs), tm, spec, BMIN, H)
    x, live = got.x.numpy(), got.m.numpy() > 0
    for s in range(tm.size):
        c = _slot_coords(tm, s)
        assert s == c["x"] * spec.n_z + c["z"]
        rows = slice(s * spec.cap, (s + 1) * spec.cap)
        ix = np.clip(np.floor((x[rows, 0] - BMIN[0]) / H[0]).astype(int), 0, GRES[0] - 1) // spec.slab_wx
        iz = np.clip(np.floor((x[rows, 2] - BMIN[2]) / H[2]).astype(int), 0, GRES[2] - 1) // spec.slab_wz
        assert live[rows].any() and np.all(~live[rows] | ((ix == c["x"]) & (iz == c["z"])))


def test_spec_from_state_2d_refuses_a_slab_width_of_one():
    mesh = make_mesh2d((4, 2), "cpu")
    with pytest.raises(ValueError, match="slab widths >= 2"):
        p2d.spec_from_state_2d(8 * 64, mesh, 4, 8)  # x slabs one cell wide
    with pytest.raises(ValueError, match="slab widths >= 2"):
        p2d.spec_from_state_2d(8 * 64, mesh, 16, 2)
    assert p2d.spec_from_state_2d(8 * 64, mesh, 8, 4).slab_wx == 2


@pytest.mark.parametrize("exchange_cap", [None, 16])
def test_rebucket_2d_bitwise_jax(meshes, bucketed, exchange_cap):
    """Every particle moved by up to 0.9 cells in x and z
    (tests/test_bucketed2d.py's move: diagonal crossers reach their corner
    slot through the two phases); with an exchange buffer of 16 rows the
    crossers overflow it and ``lost`` > 0."""
    jm, tm = meshes
    _, _, spec, jb = bucketed
    if exchange_cap is not None:
        spec = spec._replace(exchange_cap=exchange_cap)
    bx, bm = np.asarray(jb.x), np.asarray(jb.m)
    dx = (np.random.default_rng(11).uniform(-0.9, 0.9, bx.shape) * H[0]).astype(np.float32)
    dx[:, 1] = 0.0
    lo = np.asarray(BMIN, np.float32) + np.float32(1e-4)
    hi = np.asarray(BMIN, np.float32) + np.asarray(GRES) * np.asarray(H, np.float32) - np.float32(1e-4)
    x = np.clip(bx + np.where(bm[:, None] > 0, dx, np.float32(0.0)), lo, hi).astype(np.float32)
    moved = (x, np.asarray(jb.v), np.asarray(jb.c), bm)
    j_out, j_lost = jax.jit(lambda pp: j_p2d.rebucket_2d(pp, jm, j_p2d.BucketSpec2D(*spec), BMIN, H))(_jp(moved))
    t_out, t_lost = p2d.rebucket_2d(_tp(moved), tm, spec, BMIN, H)
    _same(t_out, jax.device_get(j_out))
    assert int(t_lost) == int(j_lost) and t_lost.dtype == torch.int32
    assert (int(t_lost) > 0) == (exchange_cap is not None)
    if exchange_cap is None:
        assert int((t_out.m > 0).sum()) == int((bm > 0).sum())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sharded_p2g_2d_grids_match_jax(jax_transfers, port_transfers, axis):
    for name in ("gms", "gvs"):
        got, want = port_transfers[name][axis], jax_transfers[name][axis]
        assert tuple(got.shape) == FSH[axis]
        _close(got, want, 5e-4, f"{name} {axis}")


@pytest.mark.parametrize("key", CLASSES, ids=["".join(map(str, k)) for k in CLASSES])
def test_sharded_p2g_2d_volume_class_matches_jax(jax_transfers, port_transfers, key):
    """One parity class: its owned (nx, ., nz) block, and where its
    parity along x / z is 0 the x tail (plane nx), the z tail (plane nz)
    and the corner line (nx, ., nz), each at tests/test_bucketed2d.py's
    1e-8."""
    got, want = port_transfers["cls"][key].numpy(), np.asarray(jax_transfers["cls"][key])
    assert got.shape == want.shape
    nx, nz = GRES[0], GRES[2]
    assert got.shape[0] == nx + (1 - key[0]) and got.shape[2] == nz + (1 - key[2])
    _close(got[:nx, :, :nz], want[:nx, :, :nz], 1e-8, f"class {key} owned")
    if key[0] == 0:
        _close(got[nx, :, :nz], want[nx, :, :nz], 1e-8, f"class {key} x tail")
        assert np.abs(want[nx]).max() > 0  # the tail carries volume
    if key[2] == 0:
        _close(got[:nx, :, nz], want[:nx, :, nz], 1e-8, f"class {key} z tail")
    if key[0] == 0 and key[2] == 0:
        _close(got[nx, :, nz], want[nx, :, nz], 1e-8, f"class {key} corner line")


def test_sharded_levelset_2d_matches_jax(meshes, bucketed, jax_transfers, port_transfers):
    _, tm = meshes
    _, _, spec, _ = bucketed
    tb = port_transfers["tb"]
    lphi = p2d.sharded_fluid_levelset_2d(tb.x, tb.m, tm, spec, GRES, BMIN, H, H[0])
    _close(lphi, jax_transfers["lphi"], 1e-6, "level set")


def test_sharded_g2p_2d_matches_jax(meshes, bucketed, jax_transfers, port_transfers):
    _, tm = meshes
    _, _, spec, _ = bucketed
    live = port_transfers["tb"].m.numpy() > 0
    pv, pc = p2d.sharded_g2p_all_2d([torch.from_numpy(g) for g in jax_transfers["g2p_in"]], tm, spec, GRES, BIAS,
                                    BMIN, H, port_transfers["si"])
    _close(pv.numpy()[live], np.asarray(jax_transfers["pv"])[live], 1e-4, "pv")
    _close(pc.numpy()[live], np.asarray(jax_transfers["pc"])[live], 1e-3, "pc")


def test_sharded_density_scatter_2d_matches_jax(jax_transfers, port_transfers):
    _close(port_transfers["gm"], jax_transfers["gm"], 5e-4, "density gm")
    _close(port_transfers["gvol"], jax_transfers["gvol"], 1e-8, "density gvol")


def test_sharded_displacement_2d_matches_jax(meshes, bucketed, jax_transfers, port_transfers):
    _, tm = meshes
    _, _, spec, _ = bucketed
    live = port_transfers["tb"].m.numpy() > 0
    d = p2d.sharded_apply_displacement_2d([torch.from_numpy(x) for x in jax_transfers["disp_in"]], tm, spec, GRES,
                                          BMIN, H, port_transfers["sid"])
    _close(d.numpy()[live], np.asarray(jax_transfers["disp_out"])[live], 1e-5, "displacement")
