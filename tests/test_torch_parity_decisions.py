"""The decisions where the port and the JAX package part at full size, on
the inputs recorded from the steps where they part (CPU, exact sums).

Three flagship steps from the scene (``buckling_config()``, JAX with
``jax.ops.segment_sum`` patched in as ``test_torch_flagship.py`` does)
keep every particle within the step bounds but one: at the third step
particle 22649's APIC rows differ by 0.0715 1/s.  At 128^3
(``scaled_buckling_config(128)``) the rows of a few particles a step
differ by up to 0.035.  Every field the step hands to G2P agrees to
rounding at the flagship (max 1.5e-5 m/s), and no ``gm > 0`` mask
differs.  What differs is a decision taken in fp32 on a value that sits
within about one ulp of its threshold:

* the G2P home cell ``floor((x - bound_min) / h - bias)``.  The particles
  are seeded on a lattice of spacing h / 2, so on a biased axis half of
  them start on a face plane, and some stay there.  The JAX package
  writes a division; its jitted program (XLA's algebraic simplifier)
  multiplies by the constant's rounded reciprocal (``1 / 0.0125f`` =
  80, ``1 / 0.0077922f`` = 128.33333), so t can round onto the other
  side of the integer.  The port divides, as the formula is written and
  as JAX's own eager ops do.  The affine rows are the gradient of the
  trilinear weights, which jumps across a face plane: the particle's
  rows then differ by (second difference of the face velocities) / h.
  The float64 value of t from the same fp32 inputs lies within one fp32
  ulp of the integer in every recorded case, and it sides with the port
  in three of the four (with JAX in the fourth): fp32 cannot decide, and
  neither package is wrong;
* the P2G mass floor (1e-7 of a particle's mass, ``engine/step.py``).
  At 128^3 one face's only mass comes from a particle 7 ulps from the
  face's cell plane: 1.02 times the floor from the port's position,
  0.88 times from JAX's, one ulp away (the density solve's rounding).
  Given the same position both packages take the same side, the side of
  the float64 value;
* the rest of the 128^3 rows over the bound come from the pressure
  solve (MG-PCG, relative tolerance 1e-3): its two fp32 outputs differ
  by up to 3.1e-5 m/s, less than either differs from the same solve run
  to a 1000x tighter tolerance (up to 4.5e-5), and the rows scale face
  velocities by 1 / h = 128.  That needs a 128^3 step and is not
  repeated here.

And one difference that was the port's: PyTorch's CPU fp32 square root
is one ulp off the correctly rounded root on ~0.7% of inputs, so the
port's CPU level sets parted from JAX's eager ones at a few cells.  The
port now takes every root through ``ops/indexing.py::rounded_sqrt``; the
root and the level sets (the coarse scene's, the bucketed slots', the 2D
one) are held to numpy's and JAX's eager ones bit for bit.

Tolerances: the rows bound of the step tests, 1e-3 1/s; the home cell,
the floor's side, the roots and the level sets exactly.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.ops import transfers as jt
from python_fluid_simulation_tpu_torch.ops import transfers as pt

FACE_BIAS = ((0.0, 0.5, 0.5), (0.5, 0.0, 0.5), (0.5, 0.5, 0.0))
FLAGSHIP = dict(res=(48, 80, 48), bound_min=(-0.3, 0.0, -0.3), cell_size=(0.0125, 0.0125, 0.0125))
RES_128 = dict(res=(77, 128, 77), bound_min=(-0.3, 0.0, -0.3),
               cell_size=(0.007792207792207792, 0.0078125, 0.007792207792207792))
ROWS_TOL = 1e-3


def _f32(*vals):
    return np.array([np.float32(v) for v in vals], dtype=np.float32)


# (grid, particle's position into G2P on the port's side, axis, dim, the
# port's home cell, the jitted JAX one, the side float64 takes)
HOME_CELLS = {
    "flagship_step3_p22649": (FLAGSHIP, _f32("-0.07146793", "0.6649314", "0.13124995"), 0, 2, 33, 34, "port"),
    "flagship_step3_p22649_v": (FLAGSHIP, _f32("-0.07146793", "0.6649314", "0.13124995"), 1, 2, 33, 34, "port"),
    "128_step2_p973": (RES_128, _f32("-0.14587218", "0.6365455", "-0.074025996"), 2, 2, 29, 28, "jax"),
    "128_step2_p138847": (RES_128, _f32("-0.032532204", "0.7714343", "-0.07402598"), 2, 2, 29, 28, "port"),
    "128_step3_p6107": (RES_128, _f32("-0.14123593", "0.682774", "0.011688303"), 2, 2, 40, 39, "port"),
}


@pytest.mark.parametrize("case", sorted(HOME_CELLS))
def test_home_cell_within_an_ulp_of_a_face_plane(case):
    grid, x, axis, dim, port_cell, jax_cell, f64_side = HOME_CELLS[case]
    bias = FACE_BIAS[axis]
    args = (grid["bound_min"], grid["cell_size"], bias)
    got_port = pt._corner_setup(torch.from_numpy(x[None]), *args)[0].numpy()[0]
    got_eager = np.asarray(jt._corner_setup(jnp.asarray(x[None]), *args)[0])[0]
    got_jit = np.asarray(jax.jit(lambda p: jt._corner_setup(p, *args)[0])(jnp.asarray(x[None])))[0]
    assert got_port[dim] == port_cell
    assert got_jit[dim] == jax_cell
    # JAX's formula op by op is the port's; the jitted program multiplies
    # by the rounded reciprocal of the constant cell size
    np.testing.assert_array_equal(got_eager, got_port)
    bmin, h, b = (np.asarray(v, np.float32) for v in args)
    np.testing.assert_array_equal(got_jit, np.floor((x - bmin) * (np.float32(1) / h) - b).astype(np.int32))
    # the same formula in float64 from the same fp32 inputs: within one
    # fp32 ulp of the integer, so fp32 cannot decide
    t64 = (x.astype(np.float64) - bmin.astype(np.float64)) / h.astype(np.float64) - b.astype(np.float64)
    assert abs(t64[dim] - round(t64[dim])) <= np.spacing(np.float32(t64[dim]))
    assert int(np.floor(t64[dim])) == (port_cell if f64_side == "port" else jax_cell)


def _g2p_f64(gvs, x, res, bound_min, cell_size, home_shift=(0, 0, 0)):
    """One particle's G2P (reference cell 3: trilinear weights, affine rows
    from the weights' gradient, corners clamped to res - 1) in float64;
    `home_shift` moves each axis' home cell by that many cells."""
    bm, h, x = (np.asarray(v, np.float64) for v in (bound_min, cell_size, x))
    pv, pc = np.zeros(3), np.zeros((3, 3))
    for a in range(3):
        b = np.asarray(FACE_BIAS[a])
        gi = np.floor((x - bm) / h - b).astype(int) + np.asarray(home_shift[a])
        w = np.abs((gi + b) * h + bm - x) / h
        for offs in itertools.product((0, 1), repeat=3):
            idx = tuple(min(int(g + o), r - 1) for g, o, r in zip(gi, offs, res))
            wd = [w[d] if o else 1.0 - w[d] for d, o in enumerate(offs)]
            val = float(gvs[a][idx])
            pv[a] += wd[0] * wd[1] * wd[2] * val
            for k in range(3):
                g = 1.0 if offs[k] else -1.0
                for j in range(3):
                    if j != k:
                        g *= wd[j]
                pc[a, k] += g * val / h[k]
    return pv, pc


def test_g2p_rows_jump_across_the_face_plane():
    """Particle 22649 of the flagship's third step through both packages'
    G2P on seeded face velocities: the port's rows are the float64 rows,
    JAX's jitted rows are the float64 rows with the z home cell one up,
    and the two differ by far more than the rows bound."""
    grid, x = FLAGSHIP, HOME_CELLS["flagship_step3_p22649"][1]
    res, bmin, h = grid["res"], grid["bound_min"], grid["cell_size"]
    rng = np.random.default_rng(0)
    shapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(res)) for a in range(3)]
    gvs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    m = np.ones(1, np.float32)

    pv_p, pc_p = pt.g2p_all([torch.from_numpy(g) for g in gvs], res, FACE_BIAS, bmin, h,
                            pt.make_sort_info(torch.from_numpy(x[None]), torch.from_numpy(m), res, bmin, h))

    @jax.jit
    def j_g2p(gv, p, pm):
        return jt.g2p_all(gv, res, FACE_BIAS, bmin, h, jt.make_sort_info(p, pm, res, bmin, h))

    pv_j, pc_j = j_g2p([jnp.asarray(g) for g in gvs], jnp.asarray(x[None]), jnp.asarray(m))
    pv_64, pc_64 = _g2p_f64(gvs, x, res, bmin, h)
    pv_up, pc_up = _g2p_f64(gvs, x, res, bmin, h, home_shift=((0, 0, 1), (0, 0, 1), (0, 0, 0)))
    np.testing.assert_allclose(pc_p.numpy()[0], pc_64, atol=ROWS_TOL)
    np.testing.assert_allclose(np.asarray(pc_j)[0], pc_up, atol=ROWS_TOL)
    assert np.abs(np.asarray(pc_j)[0] - pc_p.numpy()[0]).max() > 100 * ROWS_TOL
    # the velocity is continuous across the plane: both within the v bound
    np.testing.assert_allclose(np.asarray(pv_j)[0], pv_p.numpy()[0], atol=1e-4)
    np.testing.assert_allclose(pv_p.numpy()[0], pv_64, atol=1e-4)


# particle 130801 of the 128^3 third step, into P2G: the port's position and
# JAX's, one ulp apart in y; its mass is the face's only one
FLOOR_FACE = (0, (33, 76, 56))
FLOOR_POSITIONS = {
    "port_position": (_f32("-0.03695983067154884", "0.6054683327674866", "0.13252881169319153"), True),
    "jax_position": (_f32("-0.03695983067154884", "0.6054683923721313", "0.13252881169319153"), False),
}
PARTICLE_MASS = 1000.0 * 0.00390625**3  # rho * particle_dx^3 at 128^3
MASS_FLOOR = 1e-7 * PARTICLE_MASS  # as engine/step.py passes it


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


@pytest.mark.parametrize("which", sorted(FLOOR_POSITIONS))
def test_mass_floor_face_decided_by_one_ulp(which, monkeypatch):
    """The face's mass from either position lies within 15% of the floor;
    given the same position both packages take the float64 value's side
    of it (gv = momentum / max(gm, floor), so a unit velocity comes back
    1 above the floor and gm / floor below it).  Tolerances: the mass
    rtol 1e-3 against float64 (fp32 holds the weight's factor 1 - w ~
    5e-5 to that), the velocity rtol 1e-6."""
    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    x, above = FLOOR_POSITIONS[which]
    other = FLOOR_POSITIONS["jax_position" if which == "port_position" else "port_position"][0]
    assert np.abs(x.view(np.int32) - other.view(np.int32)).sum() == 1
    g = RES_128
    res, bmin, h = g["res"], g["bound_min"], g["cell_size"]
    shapes = [tuple(n + (1 if i == a else 0) for i, n in enumerate(res)) for a in range(3)]
    m = np.full(1, PARTICLE_MASS, np.float32)
    v = np.array([[1.0, 1.0, 1.0]], np.float32)
    c = np.zeros((1, 3, 3), np.float32)
    gm_p, gv_p = pt.p2g_all(*(torch.from_numpy(t) for t in (x[None], m, v, c)), res, shapes, FACE_BIAS, bmin, h,
                            mass_floor=MASS_FLOOR)
    j_p2g = jax.jit(lambda *t: jt.p2g_all(*t, res, shapes, FACE_BIAS, bmin, h, mass_floor=MASS_FLOOR))
    gm_j, gv_j = j_p2g(*(jnp.asarray(t) for t in (x[None], m, v, c)))
    a, face = FLOOR_FACE
    # float64: the particle's weight to the face from the same fp32 inputs
    bm64, h64, x64 = (np.asarray(t, np.float32).astype(np.float64) for t in (bmin, h, x))
    b = np.asarray(FACE_BIAS[a])
    gi = np.floor((x64 - bm64) / h64 - b).astype(int)
    w = np.abs((gi + b) * h64 + bm64 - x64) / h64
    offs = np.asarray(face) - gi
    assert set(offs.tolist()) <= {0, 1}
    gm64 = float(m[0]) * np.prod([w[d] if o else 1.0 - w[d] for d, o in enumerate(offs)])
    assert 0.85 * MASS_FLOOR < gm64 < 1.15 * MASS_FLOOR
    assert (gm64 >= MASS_FLOOR) == above
    for gm, gv in ((gm_p[a].numpy(), gv_p[a].numpy()), (np.asarray(gm_j[a]), np.asarray(gv_j[a]))):
        assert (gm[face] >= MASS_FLOOR) == above
        # fp32 carries 1 - w ~ 5e-5 to a relative 1e-3
        np.testing.assert_allclose(gm[face], gm64, rtol=1e-3)
        np.testing.assert_allclose(gv[face], 1.0 if above else gm[face] / np.float32(MASS_FLOOR), rtol=1e-6)


# --- the 504 free surface, card vs CPU (the first lean 504 step) ---------
#
# From the card's state, the step on the card (every kernel swapped for
# its plain version) and on the CPU part first in the density solve's
# positions, by one ulp at 201,844 of 465,868 particles (its dots summed
# in another order on each device, which neither package's formula
# fixes).  The level set then moves by up to 1.2e-7, and at the bottom of
# the falling column, where a cell centre lies 2.1e-5 m inside the
# surface, the ghost-fluid fraction phi / (phi - nphi) of its air faces
# turns that into 7.9e-4 of the pressure diagonal, 3.5e-5 m/s of the face
# velocities and 3.8e-3 1/s of the APIC rows.
#
# On the way: PyTorch's CPU fp32 sqrt (its AVX512 build) is one ulp off
# the correctly rounded root on ~0.7% of inputs, which the card's sqrt,
# JAX's and numpy's are not.  The port's roots go through
# `ops/indexing.py::rounded_sqrt` (on the CPU the root in float64, rounded
# once), so its CPU level sets are JAX's eager ones bit for bit, and the
# card's.


def test_rounded_sqrt_is_correctly_rounded():
    """`rounded_sqrt` on the CPU against numpy's root (correctly rounded)
    and the float64 root rounded once, on 4M seeded fp32 inputs: half in
    [0, 1e-2) (squared distances of the level set at the flagship), half
    log-uniform over 2^-60 to 2^60, and the edge values; bitwise."""
    from python_fluid_simulation_tpu_torch.ops.indexing import rounded_sqrt

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(2_000_000) * 1e-2,
        np.exp2(rng.uniform(-60.0, 60.0, 2_000_000)),
        [0.0, 1.0, 4.0, np.finfo(np.float32).tiny, np.finfo(np.float32).max, np.inf],
    ]).astype(np.float32)
    got = rounded_sqrt(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.sqrt(x))
    np.testing.assert_array_equal(got.numpy(), torch.sqrt(torch.from_numpy(x).double()).float().numpy())
    assert rounded_sqrt(torch.from_numpy(x[:10]).double()).dtype == torch.float64


def test_levelset_parts_from_jax_only_where_the_cpu_sqrt_is_off():
    """The coarse scene's level set: the port on the CPU against JAX's eager
    ops (the same formula, op by op).  They parted at a few cells, each by
    one ulp of the root, exactly where PyTorch's CPU fp32 root is not the
    correctly rounded one; with the port's roots correctly rounded
    (`rounded_sqrt`) they are equal bit for bit."""
    from python_fluid_simulation_tpu.ops.levelset import compute_fluid_levelset as j_levelset
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
    from python_fluid_simulation_tpu_torch.ops import levelset as p_levelset

    cfg = buckling_config(dx=0.05)
    g = cfg.grid
    p = buckling_scene(cfg, device="cpu").particles
    args = (g.res, g.bound_min, g.cell_size, g.dx)
    want = np.asarray(j_levelset(jnp.asarray(p.x.numpy()), *args, pm=jnp.asarray(p.m.numpy())))
    got = p_levelset.compute_fluid_levelset(p.x, *args, pm=p.m).numpy()
    assert (got < 3.0 * g.dx).sum() > 100  # cells near the liquid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["bucketed_slots", "2d"])
def test_levelsets_bitwise_jax_eager(case):
    """The bucketed slot level set (`parallel/particles.py::
    sharded_fluid_levelset`: each of 8 slots' scatter-min over its slab,
    the spill planes min-folded into the neighbours) at
    tests/test_torch_bucketed.py's inputs, and the 2D level set of the dam
    break at tests/test_torch_2d.py's size (24x24 cells), on the CPU:
    bitwise JAX's eager level set of the same particles (a min is exact,
    so the slabs change nothing).  JAX's compiled programs are not the
    reference here: they contract ``cd * cd + dist2`` into fused
    multiply-adds."""
    from python_fluid_simulation_tpu.ops.levelset import compute_fluid_levelset as j_levelset
    from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset

    if case == "bucketed_slots":
        from python_fluid_simulation_tpu_torch.parallel import particles as part
        from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh
        from tests.test_torch_bucketed import BMIN, GRES, H, _inputs, _tp

        mesh = make_mesh(8, "cpu")
        arrs, _ = _inputs()
        spec = part.make_bucket_spec(8, GRES[0], arrs[0].shape[0])
        p = part.bucket_particles(_tp(arrs), mesh, spec, BMIN, H)
        assert int((p.m == 0).sum()) > 0  # the slots' padding rows
        args = (GRES, BMIN, H, H[0])
        got = part.sharded_fluid_levelset(p.x, p.m, mesh, spec, *args).numpy()
    else:
        from python_fluid_simulation_tpu_torch.config import GridConfig2D, PhysicsConfig, SolverConfig
        from python_fluid_simulation_tpu_torch.engine.step2d import SimConfig2D, dam_break_scene_2d

        cfg, state = dam_break_scene_2d(SimConfig2D(
            grid=GridConfig2D(bound_min=(0.0, 0.0), bound_size=(1.0, 1.0), dx=1.0 / 24),
            physics=PhysicsConfig(mu=0.5, dt=1.0 / 120.0), solver=SolverConfig(max_iter=600),
            particle_dx=1.0 / 48), device="cpu")
        g, p = cfg.grid, state.particles
        args = (g.res, g.bound_min, g.cell_size, g.dx)
        got = compute_fluid_levelset(p.x, *args, pm=p.m).numpy()
    want = np.asarray(j_levelset(jnp.asarray(p.x.numpy()), *args, pm=jnp.asarray(p.m.numpy())))
    assert (got < 3.0 * args[3]).sum() > 100  # cells near the liquid
    np.testing.assert_array_equal(got, want)


# lphi of cell (61, 276, 59) and of its six face neighbours (+x, -x, +y,
# -y, +z, -z) from each device's level set of that step, and each
# device's pressure diagonal there
GHOST_CELL = {
    "card": (-2.1434156224131584e-05, (0.00026136660017073154, 0.00011387630365788937, -0.0013110729632899165,
                                        0.0022988489363342524, 0.00029936153441667557, 0.00029783789068460464),
             150.3688201904297),
    "cpu": (-2.1377811208367348e-05, (0.00026136660017073154, 0.00011387630365788937, -0.0013111039297655225,
                                       0.0022989080753177404, 0.00029936153441667557, 0.00029783789068460464),
            150.48838806152344),
}


def _ghost_patch(phi, nphi):
    lphi = np.ones((3, 3, 3), np.float32)
    lphi[1, 1, 1] = phi
    for (a, side), v in zip(((0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)), nphi):
        idx = [1, 1, 1]
        idx[a] += side
        lphi[tuple(idx)] = v
    return lphi


@pytest.mark.parametrize("device", sorted(GHOST_CELL))
def test_ghost_fluid_diagonal_at_the_column_bottom(device):
    """Each device's level set at the cell through both packages'
    `pressure_coefficients` (unit face weights): the device's own
    diagonal, bitwise in both packages, within 1e-6 (relative) of the
    float64 formula on the same fp32 values; the two devices' lphi part by
    2.6e-3 of the cell's value (5.6e-8, one ulp of a position at y = 0.66)
    and their diagonals by 7.9e-4."""
    from python_fluid_simulation_tpu.solvers import pressure as j_pressure
    from python_fluid_simulation_tpu_torch.solvers import pressure as p_pressure

    phi, nphi, diag = GHOST_CELL[device]
    lphi = _ghost_patch(phi, nphi)
    w = [np.ones(tuple(4 if i == a else 3 for i in range(3)), np.float32) for a in range(3)]
    got_p = p_pressure.pressure_coefficients([torch.from_numpy(t) for t in w], torch.from_numpy(lphi))[0].numpy()
    got_j = np.asarray(jax.jit(lambda ww, ll: j_pressure.pressure_coefficients(ww, ll)[0])(
        [jnp.asarray(t) for t in w], jnp.asarray(lphi)))
    assert got_p[1, 1, 1] == np.float32(diag)
    assert got_j[1, 1, 1] == got_p[1, 1, 1]
    p64 = np.float64(np.float32(phi))
    d64 = 0.0
    for n in nphi:
        n64 = np.float64(np.float32(n))
        d64 += 1.0 if n64 < 0 else 1.0 / min(max(p64 / (p64 - n64), 0.01), 1.0)
    np.testing.assert_allclose(got_p[1, 1, 1], d64, rtol=1e-6)
    other = GHOST_CELL["cpu" if device == "card" else "card"]
    assert abs(phi - other[0]) / abs(other[0]) < 3e-3 and abs(phi - other[0]) < 6e-8
    assert 7e-4 < abs(diag - other[2]) / other[2] < 8e-4


def test_cfl_dt_is_a_true_division():
    """The CFL step size dx / max(vmax, 1e-10) as the JAX package writes
    it: one division, where PyTorch's `float / tensor` multiplies by the
    reciprocal (two roundings)."""
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import step_3d

    cfg = buckling_config(dx=0.05)
    dx = np.float32(cfg.grid.dx)
    speeds = np.float32(20.0) + np.arange(200, dtype=np.float32) * np.float32(0.0137)
    s = next(float(v) for v in speeds if dx * (np.float32(1) / v) != dx / v)
    state = buckling_scene(cfg, device="cpu")
    v = torch.zeros_like(state.particles.v)
    v[0, 0] = s
    state = state.__class__(**{**state.__dict__, "particles": state.particles.__class__(
        **{**state.particles.__dict__, "v": v})})
    _, metrics = step_3d(state, cfg)
    want = np.asarray(jax.jit(lambda vv: cfg.grid.dx / jnp.maximum(1e-10, jnp.max(jnp.sqrt(jnp.sum(vv**2, axis=-1)))))(
        jnp.asarray(v.numpy())))
    assert want < cfg.physics.dt
    assert metrics["dt"].numpy() == want
