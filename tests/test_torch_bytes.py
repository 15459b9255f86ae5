"""The port's byte count of a step (``utils/step_bytes.py``), on CPU.

* ``op_bytes``' rule, exactly, on hand-built op sequences: elementwise,
  in-place, a view, an ``expand``, ``copy_``, ``sort``, ``index_select``,
  a convolution, an ``out=`` slice, a tensor twice in one op, an
  allocation, and indexed writes (``index_put_``, ``index_add_``,
  ``scatter_``) that write only what their index addresses.
* Every routed kernel wrapper on small CPU inputs: the counter holds one
  entry, the kernel's, whose bytes are its formula (written out here),
  and none of the plain version's aten ops.
* ``step_bytes``: two identical small steps count the same, the step it
  returns is bitwise the uncounted step, the kernels' share is theirs; a
  CPU ``make_mesh(2)`` step counts every slot (a halo exchange over two
  slots is exactly both slots' bytes).
* ``roofline(measured_bytes_per_step=count)`` still equals JAX's
  ``roofline`` given the same number.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from python_fluid_simulation_tpu.utils import roofline as j_roofline
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import step_3d
from python_fluid_simulation_tpu_torch.ops import cuda_binned, cuda_cg, cuda_fold, cuda_mg, cuda_scan, cuda_stencils
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.parallel import halo, halo_rdma
from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, shard_state
from python_fluid_simulation_tpu_torch.solvers import multigrid, pressure, viscosity
from python_fluid_simulation_tpu_torch.utils import roofline
from python_fluid_simulation_tpu_torch.utils.step_bytes import ByteCounter, step_bytes

torch.set_num_threads(1)

F4, I8 = 4, 8


def _counted(fn):
    """(fn's result, the counter's table, its total) of one call."""
    counter = ByteCounter()
    with counter:
        out = fn()
    return out, counter.table, counter.total


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# -- the aten rule --------------------------------------------------------

def _op_cases():
    a, b = _rand(64, 32, seed=1), _rand(64, 32, seed=2)
    n = a.numel()
    x, w, bias = _rand(1, 2, 6, 7, 8, seed=3), _rand(4, 2, 3, 3, 3, seed=4), _rand(4, seed=5)
    ids = torch.tensor([3, 0, 7, 7, 1], dtype=torch.int64)
    src = _rand(10, 6, seed=6)
    same = torch.zeros(64, dtype=torch.bool)
    vals = torch.arange(64)
    conv_out = 1 * 4 * 4 * 5 * 6  # (1, 4, 6-2, 7-2, 8-2)
    return {
        # (the ops, the bytes the rule gives)
        "elementwise": (lambda: a + b, 3 * n * F4),
        "in_place": (lambda: a.clone().mul_(b), 2 * n * F4 + 3 * n * F4),  # clone, then read a', b; write a'
        "same_tensor_twice": (lambda: a * a, 2 * n * F4),
        "view": (lambda: (a.view(32, 64), a[1:], a.t(), a.unsqueeze(0), a.detach()), 0),
        "expand": (lambda: a[:1].expand(64, 32) + b, 32 * F4 + 2 * n * F4),
        "copy_": (lambda: torch.empty_like(a).copy_(b), 2 * n * F4),
        "copy_from_expanded": (lambda: torch.empty_like(a).copy_(b[:1].expand(64, 32)), 32 * F4 + n * F4),
        "empty": (lambda: (torch.empty(1000), torch.empty_like(a)), 0),
        "zeros_like": (lambda: torch.zeros_like(a), n * F4),
        "sort": (lambda: torch.sort(a[:, 0]), 64 * F4 + 64 * F4 + 64 * I8),
        "index_select": (lambda: torch.index_select(src, 0, ids), 5 * I8 + 5 * 6 * F4 + 5 * 6 * F4),
        "convolution": (lambda: F.conv3d(x, w, bias), (x.numel() + w.numel() + 4 + conv_out) * F4),
        "out_slice": (lambda: torch.eq(vals[1:], vals[:-1], out=same[1:]), 2 * 63 * I8 + 63),
        "index_put_": (lambda: src.clone().index_put_((ids[:2],), torch.tensor(1.0)),
                       2 * 60 * F4 + 2 * I8 + F4 + 2 * 6 * F4),
        "index_put_accumulate": (lambda: src.clone().index_put_((ids,), src[:5], accumulate=True),
                                 2 * 60 * F4 + 5 * I8 + 30 * F4 + 2 * 30 * F4),
        "index_add_": (lambda: src.clone().index_add_(0, ids, src[:5]), 2 * 60 * F4 + 5 * I8 + 30 * F4 + 2 * 30 * F4),
        "scatter_": (lambda: src.clone().view(-1).scatter_(0, ids, src.view(-1)), 2 * 60 * F4 + 5 * I8 + 5 * F4 + 5 * F4),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_op_rule_counts_exactly(case):
    fn, want = _op_cases()[case]
    _, table, total = _counted(fn)
    assert total == want, table


def test_op_table_names_each_op():
    a = _rand(8, 8)
    _, table, total = _counted(lambda: (a + a) * 2.0)
    assert table == {"aten.add.Tensor": [1, 2 * 64 * F4], "aten.mul.Tensor": [1, 2 * 64 * F4]}
    assert total == 4 * 64 * F4


# -- the kernel wrappers ----------------------------------------------------

def _cell_system(n=(9, 10, 11), seed=3):
    rng = np.random.default_rng(seed)
    lphi = torch.from_numpy(rng.standard_normal(n).astype(np.float32) - 0.3)
    w = [torch.from_numpy(rng.uniform(0.2, 1.0, tuple(k + (i == a) for i, k in enumerate(n))).astype(np.float32))
         for a in range(3)]
    diag, coefs, pd = pressure.pressure_coefficients(w, lphi)
    b = torch.where(diag > 0, _rand(*n, seed=seed + 1), 0.0)
    return b, diag, coefs, pd


def _live(b, x0, diag, coefs):
    r0 = b if x0 is None else b - cuda_stencils.stencil_matvec_plain(diag, coefs, x0)
    live = (r0 != 0) | (diag != 0)
    for _, c in coefs:
        live |= c != 0
    return int(live.sum())


def _geometry(n=(7, 8, 9), seed=11):
    dual = tuple(2 * k + 1 for k in n)
    rng = np.random.default_rng(seed)
    sphi = split_parity(torch.from_numpy(rng.standard_normal(dual).astype(np.float32)), 3)
    vol = split_parity(torch.from_numpy(rng.uniform(0.1, 1.0, dual).astype(np.float32)), 3)
    shapes = [tuple(k + (i == a) for i, k in enumerate(n)) for a in range(3)]
    vs = tuple(_rand(*s, seed=seed + a) for a, s in enumerate(shapes))
    return sphi, vol, torch.tensor(0.6), shapes, vs


def _geom_elements(sphi, vol):
    return sum(vol[c].numel() for c in cuda_cg.VOL_CLASSES) + sum(sphi[c].numel() for c in cuda_cg.SPHI_CLASSES)


def _rows(k=300, c=5, m=40, seed=7):
    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(np.sort(rng.integers(-3, m + 3, k)).astype(np.int64))
    return _rand(k, c, seed=seed), ids, m


def _wrapper_cases():
    kw = dict(tol=1e-6, rel_tol=1e-6, max_iter=200)
    b, diag, coefs, pd = _cell_system()
    n = b.numel()
    x0 = _rand(*b.shape, seed=9) * (diag > 0)
    sphi, vol, s_mu, shapes, vs = _geometry()
    faces = sum(v.numel() for v in vs)
    n_geom = _geom_elements(sphi, vol)
    vb = viscosity.viscosity_rhs_3d(vs, s_mu, sphi, vol)
    vpd = viscosity.viscosity_diag_3d(s_mu, sphi, vol, shapes)
    vdiags, per_axis, _ = viscosity.viscosity_term_fields(s_mu, sphi, vol, shapes)
    tail = cuda_mg.make_vcycle_tail(multigrid.build_hierarchy(diag, coefs), omega=0.8, n_smooth=2, coarse_iters=24)
    tail_n = 4 * (3 * n + 7 * sum(lv.diag.numel() for lv in tail.levels))
    vals, ids, m = _rows()
    k, c = vals.shape
    live = int(((ids >= 0) & (ids < m)).sum())
    s = int(torch.unique(ids[(ids >= 0) & (ids < m)]).numel())
    same = cuda_binned.segment_same(ids)
    scanned = cuda_scan.seg_scan_sorted_plain(vals, same)
    table = _rand(m, c, seed=12)
    grid = (4, 5, 2)  # m = 40 segments
    live_table = dataclasses.replace(cuda_binned.place_live_plain(scanned, ids, m), grid_shape=grid)
    shifts = [(0, 1), (0, 1), (0,)]
    fold_table = dataclasses.replace(cuda_binned.place_live_plain(_rand(k, 4, seed=13), ids, m), grid_shape=grid)
    dense = live_table.dense()[:4]
    mesh = make_mesh(2, "cpu")
    blocks = [_rand(3, 4, 5, seed=20 + i) for i in range(2)]
    parts = [tuple(_rand(seed=30 + 3 * i + j)[()] * 1 for j in range(3)) for i in range(2)]
    parts = [tuple(torch.tensor(float(p)) for p in pp) for pp in parts]

    def pcg_bytes(x0_, iters):
        return (10 + (x0_ is not None)) * n * F4 + int(iters) * 84 * _live(b, x0_, diag, coefs)

    return {
        # name: (the call, the wrapper, the formula of its result)
        "stencil_matvec": (lambda: cuda_stencils.stencil_matvec(diag, coefs, b), lambda out: 9 * F4 * n),
        "cell_poisson_pcg": (lambda: cuda_stencils.cell_poisson_pcg(b, diag, coefs, pd, **kw),
                             lambda out: pcg_bytes(None, out[1])),
        "fused_poisson_pcg": (lambda: cuda_stencils.fused_poisson_pcg(b, x0, diag, coefs, pd, **kw),
                              lambda out: pcg_bytes(x0, out[1])),
        "coupled_stencil_matvec": (lambda: cuda_stencils.coupled_stencil_matvec(vdiags, per_axis, vs),
                                   lambda out: 17 * F4 * faces),
        "coupled_matvec_geom": (lambda: cuda_cg.coupled_matvec_geom(sphi, vol, s_mu, vs),
                                lambda out: (n_geom + 2 * faces) * F4),
        "coupled_matvec_geom_same_axis": (
            lambda: cuda_cg.coupled_matvec_geom(sphi, vol, s_mu, vs, same_axis_only=True),
            lambda out: (n_geom + 2 * faces) * F4),
        "coupled_visc_pcg": (lambda: cuda_cg.coupled_visc_pcg(vb, vs, vpd, sphi, vol, s_mu, **kw),
                             lambda out: (4 * faces + n_geom) * F4 + int(out[1]) * (n_geom + 12 * faces) * F4),
        "vcycle_tail": (lambda: cuda_mg.vcycle_tail(tail, b, x0), lambda out: tail_n),
        "serial_reduce": (lambda: cuda_binned.serial_reduce(vals, ids, m), lambda out: live * c * F4 + k * I8 + m * c * F4),
        "seg_scan_sorted": (lambda: cuda_scan.seg_scan_sorted(vals, same), lambda out: 2 * k * c * F4 + k),
        "place_live": (lambda: cuda_binned.place_live(scanned, ids, m), lambda out: k * I8 + 2 * s * c * F4 + m * 4),
        "segment_broadcast": (lambda: cuda_binned.segment_broadcast(table, ids),
                              lambda out: k * I8 + s * c * F4 + k * c * F4),
        "fold_live": (lambda: cuda_fold.fold(fold_table, shifts, (3, 4, 2)),
                      lambda out: m * 4 + s * 4 * F4 + 24 * F4),
        "fold_dense": (lambda: cuda_fold.fold(dense, shifts, (3, 4, 2)),
                       lambda out: (4 * m + 24) * F4),
        "fold_2d": (lambda: cuda_fold.fold(dataclasses.replace(fold_table, grid_shape=(8, 5)), [(0, 1), (0, 1)], (7, 4)),
                    lambda out: m * 4 + s * 4 * F4 + 28 * F4),
        "halo_exchange_rdma": (lambda: halo_rdma.halo_exchange_rdma(mesh, blocks),
                               lambda out: 2 * (2 * 3 + 2) * 20 * F4),
        "halo_exchange_push": (lambda: halo_rdma.halo_exchange_push(mesh, blocks),
                               lambda out: 2 * (2 * 3 + 2) * 20 * F4),
        "mesh_psum": (lambda: halo_rdma.mesh_psum(mesh, parts),
                      lambda out: 2 * (2 * 2 * 3 * 4 + 2 * 4 + 2 * 3 * 4)),
    }


WRAPPER_CASES = sorted(_wrapper_cases())


@pytest.mark.parametrize("case", WRAPPER_CASES)
def test_wrapper_counts_its_kernel_formula_and_no_aten_op(case):
    call, formula = _wrapper_cases()[case]
    name = {"coupled_matvec_geom_same_axis": "coupled_matvec_geom", "fold_live": "fold", "fold_dense": "fold",
            "fold_2d": "fold"}.get(case, case)
    out, table, total = _counted(call)
    want = formula(out)
    assert table == {f"kernel:{name}": [1, want]}
    assert total == want > 0


def test_wrapper_outside_a_counter_is_untouched():
    b, diag, coefs, _ = _cell_system()
    got = cuda_stencils.stencil_matvec(diag, coefs, b)
    assert torch.equal(got, cuda_stencils.stencil_matvec_plain(diag, coefs, b))
    assert cuda_stencils.stencil_matvec.__wrapped__.__name__ == "stencil_matvec"


def test_nested_wrapper_counts_once():
    """`segment_reduce`'s scan route runs two wrappers; a wrapper inside a
    wrapper (the 2D fold's lifted call on the card, the push inside the
    pull's wrapper) is counted by the outer one only."""
    vals, ids, m = _rows()
    _, table, _ = _counted(lambda: cuda_binned.segment_reduce(vals, ids, m))
    assert {"kernel:seg_scan_sorted", "kernel:place_live"} <= set(table)
    assert all(v[0] == 1 for k, v in table.items() if k.startswith("kernel:"))


def test_rounded_sqrt_counts_as_the_cards_one_sqrt():
    """`rounded_sqrt` takes the root in float64 on the CPU; it counts as
    the one fp32 aten sqrt the card runs (read once, written once), so the
    card and the CPU count a step the same."""
    from python_fluid_simulation_tpu_torch.ops.indexing import rounded_sqrt

    x = torch.rand(1000, dtype=torch.float32)
    _, table, total = _counted(lambda: rounded_sqrt(x))
    _, want_table, want = _counted(lambda: torch.sqrt(x))
    assert table == want_table == {"aten.sqrt.default": [1, 2 * 1000 * F4]}
    assert total == want


# -- a step ---------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_state():
    cfg = buckling_config(dx=0.05)
    s = buckling_scene(cfg, device="cpu")
    for _ in range(2):  # the third step solves the viscosity too
        s, _ = step_3d(s, cfg)
    return cfg, s


def test_identical_steps_count_the_same_and_step_is_unchanged(flagship_state):
    cfg, s = flagship_state
    want, _ = step_3d(s, cfg)
    first, second = step_bytes(s, cfg), step_bytes(s, cfg)
    assert first.steps == second.steps and first.table == second.table
    assert first.bytes_per_step == first.steps[0] > 0
    for k in ("x", "v", "c"):
        assert torch.equal(getattr(first.state.particles, k), getattr(want.particles, k))
    kernels = {k for k in first.table if k.startswith("kernel:")}
    assert {"kernel:cell_poisson_pcg", "kernel:coupled_visc_pcg", "kernel:seg_scan_sorted", "kernel:place_live",
            "kernel:segment_broadcast", "kernel:fold"} <= kernels
    assert first.kernel_bytes == sum(first.table[k][1] for k in kernels)
    assert 0 < first.kernel_share < 1
    assert int(first.metrics[0]["viscosity_iters"]) > 0
    assert first.top(3)[0][2] == max(b for _, b in first.table.values())


def test_two_steps_sum_and_replay_copies_counted(flagship_state):
    cfg, s = flagship_state
    two = step_bytes(s, cfg, 2)
    one = step_bytes(s, cfg)
    assert two.steps[0] == one.steps[0] and len(two.steps) == 2
    assert two.bytes_per_step == sum(two.steps) / 2
    # simulate's copy into the replay's inputs: every state tensor once
    state_bytes = sum(t.numel() * t.element_size() for t in (
        s.particles.x, s.particles.v, s.particles.c, s.particles.m, s.solid.phi, s.solid.v, s.solid.rb))
    assert one.table["aten.copy_.default"][1] >= 2 * state_bytes


def test_halo_exchange_counts_both_slots():
    """The CPU halo route over two slots: each slot reads its block and
    its neighbour's plane and writes its framed block; the ring's two
    outer planes are zeros written."""
    mesh = make_mesh(2, "cpu")
    blocks = [_rand(5, 4, 3, seed=40 + i) for i in range(2)]
    plane = 12
    _, table, total = _counted(lambda: halo.halo_exchange(mesh, blocks, "x"))
    assert total == 2 * (2 * 5 + 4) * plane * F4 + 2 * plane * F4
    assert table["aten.cat.default"][0] == 2


def test_mesh_step_counts_every_slot(flagship_state):
    cfg, s = flagship_state
    mesh = make_mesh(2, "cpu")
    sharded = shard_state(s, mesh)
    got = step_bytes(sharded, cfg, mesh=mesh)
    again = step_bytes(sharded, cfg, mesh=mesh)
    assert got.steps == again.steps and got.steps[0] > 0
    want, _ = step_3d(sharded, cfg, mesh=mesh)
    assert torch.equal(got.state.particles.x, want.particles.x)
    # the distributed solves frame every slot's block each iteration
    iters = sum(int(got.metrics[0][f"{k}_iters"]) for k in ("density", "viscosity", "pressure"))
    assert got.table["aten.cat.default"][0] >= 2 * iters


def test_roofline_with_the_count_equals_jax():
    cfg = buckling_config(dx=0.1)
    s = buckling_scene(cfg, device="cpu")
    got = step_bytes(s, cfg)
    iters = {k: float(got.metrics[0][k]) for k in ("density_iters", "viscosity_iters", "pressure_iters")}
    k = int(s.particles.x.shape[0])
    res = cfg.grid.res
    count = got.bytes_per_step
    assert roofline.roofline(res, k, iters, 12.5, measured_bytes_per_step=count) == \
        j_roofline.roofline(res, k, iters, 12.5, measured_bytes_per_step=count)
    assert roofline.step_bytes is step_bytes
