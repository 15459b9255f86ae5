"""The live-cell form of the port's Poisson PCG kernel
(``csrc/poisson_pcg.cu``, launched by ``ops/cuda_stencils.py::
fused_poisson_pcg`` and ``::cell_poisson_pcg``), checked on the CPU
(no nvcc here).

* ``poisson_live_cells_plain`` on tests/test_torch_big_grid.py's
  pressure and density systems, from x0 = 0 and from a random x0, and on
  a system with b != 0 on zero rows: the list is ascending; every nonzero
  coupling of a live row points inside the grid, to a live cell or to a
  cell whose row and r0 are 0; on the cells off the list both plain
  solves leave x = x0 bitwise (the kernel's argument for walking the list
  only).
* `list_pcg` (``tests/poisson_list_model.py``), a model of the kernel
  over torch tensors (its init, its two phases over the list and its
  order of dot partials) for the block count the card launches at this
  grid (`coop_grid`'s cap, ceil(cells / kBlock)).  Held against the JAX
  package's ``make_fused_poisson_cg(interpret=True)`` (from zero and
  from a random x0) and ``make_stencil_cg`` (interpret, from zero):
  iterations equal, x within test_torch_big_grid.py's PCG_REL of max|x|,
  res0 within its rtol (measured: iterations equal, x 1.3e-7 of max|x|
  at most); and against the plain versions: iterations equal, x within
  the same bound.  ``chip_smoke.py`` holds the kernel on the card to the
  same model, bitwise.
* the edge cases `chip_smoke.py` holds the kernel to on the card: b != 0
  on zero rows (those cells join the list), an all-zero b (0 iterations,
  x = x0) and an all-zero system (an empty list).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from poisson_list_model import K_BLOCK, list_pcg
from test_torch_big_grid import N, PCG_REL, _cell_system

from python_fluid_simulation_tpu.ops import pallas_cg
from python_fluid_simulation_tpu.ops.pallas_stencils import make_stencil_cg
from python_fluid_simulation_tpu_torch.ops import cuda_cg, cuda_stencils

torch.set_num_threads(1)

KW = dict(tol=1e-5, rel_tol=1e-5, max_iter=500)
N_BLOCKS = -(-int(np.prod(N)) // K_BLOCK)  # coop_grid's grid at N: ceil(cells / kBlock) (above 132 SMs' worth it is capped)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_system(kind, from_zero):
    b, diag, coefs, pd, x0 = _cell_system(kind)
    tcoefs = [(tuple(off), _t(c)) for off, c in coefs]
    return _t(b), (None if from_zero else torch.from_numpy(x0)), _t(diag), tcoefs, _t(pd), (b, diag, coefs, pd, x0)


def _couplings_ok(b, x0, diag, coefs, live):
    """Every nonzero coupling of a live row points inside the grid, to a
    live cell or to a cell whose row and r0 are 0."""
    r0 = (b if x0 is None else b - cuda_stencils.stencil_matvec_plain(diag, coefs, x0)).numpy()
    row = (diag != 0).numpy()
    for _, c in coefs:
        row = row | (c != 0).numpy()
    inert = ~row & (r0 == 0)
    live_mask = np.zeros(b.numel(), bool)
    live_mask[live.numpy()] = True
    live_mask = live_mask.reshape(b.shape)
    shape = np.array(b.shape)
    for off, c in coefs:
        for i in zip(*np.nonzero(c.numpy() != 0)):
            if not live_mask[i]:
                continue
            j = np.array(i) + np.array(off)
            if (j < 0).any() or (j >= shape).any():
                return False
            if not (live_mask[tuple(j)] or inert[tuple(j)]):
                return False
    return True


# -- the plain live list ---------------------------------------------------

@pytest.mark.parametrize("kind", ["pressure", "density"])
@pytest.mark.parametrize("from_zero", [True, False])
def test_live_cells_plain_cover_the_system(kind, from_zero):
    b, x0, diag, coefs, pd, _ = _torch_system(kind, from_zero)
    live = cuda_stencils.poisson_live_cells_plain(b, x0, diag, coefs)
    assert live.dtype == torch.int64 and 0 < live.numel() < b.numel()
    assert bool((live[1:] > live[:-1]).all())
    assert _couplings_ok(b, x0, diag, coefs, live)
    dead = np.setdiff1d(np.arange(b.numel()), live.numpy())
    start = torch.zeros_like(b) if x0 is None else x0
    x, *_ = cuda_stencils.fused_poisson_pcg_plain(b, start, diag, coefs, pd, **KW)
    np.testing.assert_array_equal(x.reshape(-1)[dead].numpy(), start.reshape(-1)[dead].numpy())
    if from_zero:
        xc, *_ = cuda_stencils.cell_poisson_pcg_plain(b, diag, coefs, pd, **KW)
        assert not xc.reshape(-1)[dead].any()


@pytest.mark.parametrize("from_zero", [True, False])
def test_live_cells_plain_take_a_rhs_on_zero_rows(from_zero):
    b, x0, diag, coefs, pd, _ = _torch_system("pressure", from_zero)
    row = diag != 0
    for _, c in coefs:
        row = row | (c != 0)
    picked = torch.nonzero(~row.reshape(-1)).reshape(-1)[::17][:4]
    assert picked.numel() == 4
    b = b.clone()
    b.view(-1)[picked] = 1e-7  # below tol: the solve still converges
    live = cuda_stencils.poisson_live_cells_plain(b, x0, diag, coefs)
    assert set(picked.tolist()) <= set(live.tolist())
    assert bool((live[1:] > live[:-1]).all())
    assert _couplings_ok(b, x0, diag, coefs, live)
    start = torch.zeros_like(b) if x0 is None else x0
    x, it, *_ = cuda_stencils.fused_poisson_pcg_plain(b, start, diag, coefs, pd, **KW)
    tol2, rel2 = cuda_cg.squared_tols(KW["tol"], KW["rel_tol"])
    xe, ite, *_ = list_pcg(b, x0, diag, coefs, pd, tol2=tol2, rel2=rel2, max_iter=KW["max_iter"], nb=N_BLOCKS)
    assert ite == int(it) > 3
    if x0 is None:  # live: x moves there (from a random x0 the step is below x0's ulp)
        assert bool((x.reshape(-1)[picked] != 0).all())
    np.testing.assert_allclose(xe.numpy(), x.numpy(), rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * float(x.abs().max()))


# -- the kernel's loop against the JAX package ------------------------------

@pytest.mark.parametrize("kind", ["pressure", "density"])
@pytest.mark.parametrize("from_zero", [True, False])
def test_list_pcg_matches_fused_poisson_cg_interpret(kind, from_zero):
    b, x0, diag, coefs, pd, (bj, diagj, coefsj, pdj, x0j) = _torch_system(kind, from_zero)
    start = np.zeros(N, np.float32) if from_zero else x0j
    xj, itj, resj, res0j, _ = pallas_cg.make_fused_poisson_cg(diagj, coefsj, pdj, interpret=True, **KW)(
        bj, jnp.asarray(start))
    tol2, rel2 = cuda_cg.squared_tols(KW["tol"], KW["rel_tol"])
    # from zero the fused route passes no x0 (solve_cell_poisson's null x0)
    x, it, res, res0, act = list_pcg(b, x0, diag, coefs, pd, tol2=tol2, rel2=rel2,
                                     max_iter=KW["max_iter"], nb=N_BLOCKS)
    assert it == int(itj) > 3, (it, int(itj))
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * np.abs(xj).max())
    np.testing.assert_allclose(float(res0), float(res0j), rtol=PCG_REL["rtol"])
    np.testing.assert_allclose(float(res), float(resj), rtol=1e-2)  # a residual near the threshold
    np.testing.assert_array_equal(act.numpy(), cuda_stencils.poisson_live_cells_plain(
        b, torch.from_numpy(start), diag, coefs).numpy())
    xp, itp, *_ = cuda_stencils.fused_poisson_pcg_plain(b, x0, diag, coefs, pd, **KW)
    assert it == int(itp)
    np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * np.abs(xj).max())


@pytest.mark.parametrize("kind", ["pressure", "density"])
def test_list_pcg_from_zero_matches_stencil_cg_interpret(kind):
    b, _, diag, coefs, pd, (bj, diagj, coefsj, pdj, _) = _torch_system(kind, True)
    xj, itj, _, res0j = make_stencil_cg(diagj, coefsj, pdj, **KW)(bj)
    tol2, rel2 = cuda_stencils.squared_tols(KW["tol"], KW["rel_tol"])
    # the cell route passes no x0 (a null pointer: x0 = 0, r0 = b)
    x, it, _, res0, _ = list_pcg(b, None, diag, coefs, pd, tol2=tol2, rel2=rel2, max_iter=KW["max_iter"], nb=N_BLOCKS)
    assert it == int(itj) > 3, (it, int(itj))
    xj = np.asarray(xj)
    np.testing.assert_allclose(x.numpy(), xj, rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * np.abs(xj).max())
    np.testing.assert_allclose(float(res0), float(res0j), rtol=PCG_REL["rtol"])
    xp, itp, *_ = cuda_stencils.cell_poisson_pcg_plain(b, diag, coefs, pd, **KW)
    assert it == int(itp)
    np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=PCG_REL["rtol"], atol=PCG_REL["atol"] * np.abs(xj).max())


@pytest.mark.parametrize("case", ["zero_b", "zero_b_from_x0", "empty_system"])
def test_list_pcg_edge_cases(case):
    b, x0, diag, coefs, pd, _ = _torch_system("density", case != "zero_b_from_x0")
    b = torch.zeros_like(b)
    if case == "empty_system":
        diag, pd = torch.zeros_like(diag), torch.ones_like(pd)
        coefs = [(off, torch.zeros_like(c)) for off, c in coefs]
    tol2, rel2 = cuda_cg.squared_tols(KW["tol"], KW["rel_tol"])
    x, it, res, res0, act = list_pcg(b, x0, diag, coefs, pd, tol2=tol2, rel2=rel2, max_iter=KW["max_iter"], nb=N_BLOCKS)
    start = torch.zeros_like(b) if x0 is None else x0
    xp, itp, resp, res0p, _ = cuda_stencils.fused_poisson_pcg_plain(b, start, diag, coefs, pd, **KW)
    assert it == int(itp)
    if case == "zero_b_from_x0":  # r0 = -A x0: a real solve
        assert it > 3
        np.testing.assert_allclose(x.numpy(), xp.numpy(), rtol=PCG_REL["rtol"],
                                   atol=PCG_REL["atol"] * float(xp.abs().max()))
    else:  # r0 = 0: no iteration, x = x0
        assert it == 0 and float(res0) == 0.0 == float(res0p)
        np.testing.assert_array_equal(x.numpy(), start.numpy())
    np.testing.assert_array_equal(act.numpy(), cuda_stencils.poisson_live_cells_plain(b, x0, diag, coefs).numpy())
    assert (act.numel() == 0) == (case == "empty_system")


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    b, x0, diag, coefs, pd, _ = _torch_system("pressure", False)
    before = (cuda_stencils.fused_poisson_pcg.launches, cuda_stencils.cell_poisson_pcg.launches)
    got = cuda_stencils.fused_poisson_pcg(b, x0, diag, coefs, pd, **KW)
    want = cuda_stencils.fused_poisson_pcg_plain(b, x0, diag, coefs, pd, **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    got = cuda_stencils.cell_poisson_pcg(b, diag, coefs, pd, **KW)
    want = cuda_stencils.cell_poisson_pcg_plain(b, diag, coefs, pd, **KW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert (cuda_stencils.fused_poisson_pcg.launches, cuda_stencils.cell_poisson_pcg.launches) == before
    with pytest.raises(ValueError):
        cuda_stencils.cell_poisson_pcg(b.to("meta"), diag, coefs, pd, **KW)


def test_fused_route_takes_a_null_x0():
    """x0 None (what solve_cell_poisson passes) is the solve from a zeros
    field, bitwise, on the fused route's CPU path."""
    b, _, diag, coefs, pd, _ = _torch_system("density", True)
    got = cuda_stencils.fused_poisson_pcg(b, None, diag, coefs, pd, **KW)
    want = cuda_stencils.fused_poisson_pcg_plain(b, torch.zeros_like(b), diag, coefs, pd, **KW)
    assert int(got[1]) > 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
