"""The multigrid V-cycle's tail (``ops/cuda_mg.py``: levels >= 1 and their
transfers, one launch of ``csrc/mg_vcycle.cu`` on the card) on the CPU:

* tests/vcycle_tail_model.py's model of the kernel's index logic (the
  packed level descriptors, the fused restriction's child order with odd
  dimensions, the fused prolong-add, the grid-to-block split) bitwise
  ``vcycle_tail_plain`` at every split, on a 3D hierarchy with odd
  dimensions, a batched B = 3 padded stack and a lean-route inner
  hierarchy; its barrier counts those of ``tail_barriers``;
* the cell and batched preconditioners, one tail call an application,
  against the JAX package's (interpreted Pallas chains and XLA V-cycle)
  at tests/test_torch_multigrid.py's tolerance (rtol 1e-5 / atol 1e-6);
* the wrapper: no launch counted on the CPU, a meta tensor refused.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.ops import pallas_mg
from python_fluid_simulation_tpu.solvers import multigrid as jmg
from python_fluid_simulation_tpu.solvers import pressure as jpr
from python_fluid_simulation_tpu_torch.ops import cuda_cg, cuda_mg
from python_fluid_simulation_tpu_torch.ops.cuda_stencils import OFFSETS
from python_fluid_simulation_tpu_torch.ops.indexing import split_parity
from python_fluid_simulation_tpu_torch.solvers import multigrid as tmg
from python_fluid_simulation_tpu_torch.solvers import pressure, viscosity

sys.path.insert(0, str(Path(__file__).resolve().parent))
import vcycle_tail_model as model  # noqa: E402

torch.set_num_threads(1)

VCYCLE_TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(omega=0.8, n_smooth=2, coarse_iters=24)


def _weights(rng, n):
    return [rng.uniform(0.2, 1.0, tuple(k + (1 if i == a else 0) for i, k in enumerate(n))).astype(np.float32)
            for a in range(3)]


def _cell_system(n, seed):
    """test_pallas.py's V-cycle system: random fluid cells, face weights in
    [0.2, 1]; as (JAX, torch) (diag, coefs) pairs."""
    rng = np.random.default_rng(seed)
    lphi = rng.standard_normal(n).astype(np.float32) - 0.5
    w = _weights(rng, n)
    dj, cj, _ = jpr.pressure_coefficients([jnp.asarray(x) for x in w], jnp.asarray(lphi))
    dt, ct, _ = pressure.pressure_coefficients([torch.from_numpy(x) for x in w], torch.from_numpy(lphi))
    return (dj, cj), (dt, ct)


def _face_systems(n, seed):
    """Three systems on the face shapes of an n grid (each one plane longer
    along its axis), as the viscosity blocks are."""
    shapes = [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]
    return [_cell_system(s, seed + a) for a, s in enumerate(shapes)]


def _tail_3d():
    (_, _), (dt, ct) = _cell_system((27, 21, 19), 3)
    levels = tmg.build_hierarchy(dt, ct)
    assert [tuple(lv.diag.shape) for lv in levels] == [(27, 21, 19), (14, 11, 10), (7, 6, 5), (4, 3, 3)]
    return cuda_mg.make_vcycle_tail(levels, **KW)


def _tail_batched():
    pre = tmg.make_batched_mg_preconditioner([t for _, t in _face_systems((13, 17, 11), 5)])
    assert [tuple(lv.diag.shape) for lv in pre.levels] == [(3, 14, 18, 12), (3, 7, 9, 6), (3, 4, 5, 3)]
    return pre.tail


def _tail_lean():
    """The lean route's inner hierarchy (its level 0 the fine stencils
    coarsened once), on a geometry drawn as tests/test_pallas.py's lean
    one is, on a larger grid (two inner levels)."""
    n = (12, 14, 16)
    dual = tuple(2 * k + 1 for k in n)
    shapes = [tuple(k + (1 if i == a else 0) for i, k in enumerate(n)) for a in range(3)]
    rng = np.random.default_rng(29)
    sphi = split_parity(torch.from_numpy(rng.standard_normal(dual).astype(np.float32)), 3)
    vol = split_parity(torch.from_numpy(rng.uniform(0.1, 1.0, dual).astype(np.float32)), 3)
    s_mu = torch.tensor(0.7)
    pre = viscosity.make_viscosity_mg_preconditioner_lean(
        s_mu, sphi, vol, shapes, lambda vs: cuda_cg.coupled_matvec_geom(sphi, vol, s_mu, vs, same_axis_only=True))
    assert [tuple(lv.diag.shape) for lv in pre.inner.levels] == [(3, 7, 8, 9), (3, 4, 4, 5)]
    return pre.inner.tail


TAILS = {"3d_odd": _tail_3d, "batched": _tail_batched, "lean_inner": _tail_lean}


def _inputs(tail, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(tail.fine_shape).astype(np.float32)) for _ in range(2))


@pytest.mark.parametrize("which", sorted(TAILS))
def test_model_matches_plain_at_every_split(which):
    tail = TAILS[which]()
    x, r = _inputs(tail, len(which))
    want = cuda_mg.vcycle_tail_plain(tail, x, r)
    big_l = len(tail.levels)
    for s in range(1, big_l + 2):
        got = model.vcycle_tail_model(tail, x, r, s)
        assert torch.equal(got, want), (which, s, float((got - want).abs().max()))
        assert model.barriers(model.schedule(tail, s)) == cuda_mg.tail_barriers(tail._replace(block_level=s))
    # the default split: the first level of at most BLOCK_CELLS cells
    sizes = [lv.diag.numel() for lv in tail.levels]
    assert tail.block_level == next((k + 1 for k, n in enumerate(sizes) if n <= cuda_mg.BLOCK_CELLS), big_l + 1)
    assert torch.equal(cuda_mg.vcycle_tail(tail, x, r), want)


@pytest.mark.parametrize("which", sorted(TAILS))
def test_packed_descriptors(which):
    """A row a level: its fields' and workspace's pointers, then its
    (B, X, Y, Z); the workspace is the tail's own, one buffer a role."""
    tail = TAILS[which]()
    assert tail.desc.dtype == np.int64 and tail.desc.shape == (len(tail.levels), cuda_mg.TAIL_WORDS)
    assert cuda_mg.TAIL_WORDS == model.WORDS and cuda_mg.MAX_LEVELS == model.MAX_LEVELS
    ptrs = set()
    for row, lv, work in zip(tail.desc.tolist(), tail.levels, tail.work):
        assert row[:7] == [lv.diag.data_ptr(), *[c.data_ptr() for _, c in lv.coefs]]
        assert row[7:10] == [t.data_ptr() for t in work]
        shape = tuple(lv.diag.shape)
        assert tuple(row[10:]) == (shape if len(shape) == 4 else (1, *shape))
        assert all(t.shape == lv.diag.shape and t.is_contiguous() for t in work)
        ptrs.update(row[7:10])
    assert len(ptrs) == 3 * len(tail.levels)
    for lv in model.decode(tail):
        assert lv.dims[0] == (tail.fine_shape[0] if len(tail.fine_shape) == 4 else 1)


def test_restrict_child_order_with_odd_dims():
    """The model's fused restriction (x pairs, then z, then y; zero past an
    odd edge) is bitwise `restrict` on values whose sums round differently
    in another order: with one coarse level, diag 1, no couplings and
    omega 1, the tail is x + P R r."""
    fine, coarse = (5, 7, 3), (3, 4, 2)
    rng = np.random.default_rng(1)
    r = torch.from_numpy((rng.standard_normal(fine) * 10.0 ** rng.integers(-4, 5, fine)).astype(np.float32))

    def level(shape):
        return tmg._Level(torch.ones(shape), tuple((o, torch.zeros(shape)) for o in OFFSETS), torch.ones(shape))

    tail = cuda_mg.make_vcycle_tail([level(fine), level(coarse)], omega=1.0, n_smooth=1, coarse_iters=1)
    got = model.vcycle_tail_model(tail, torch.zeros(fine), r)
    want = cuda_mg.prolong(cuda_mg.restrict(r, coarse), fine)
    assert torch.equal(got, want)
    assert torch.equal(cuda_mg.vcycle_tail_plain(tail, torch.zeros(fine), r), want)
    xyz = r
    for axis in range(3):  # x, then y, then z: another rounding
        xyz = cuda_mg.halve(xyz, axis, None)
    assert not torch.equal(cuda_mg.prolong(xyz, fine), want)


def test_preconditioners_call_the_tail_once_and_match_jax(monkeypatch):
    calls = []
    orig = tmg.vcycle_tail

    def counted(tail, x, r):
        calls.append(tuple(x.shape))
        return orig(tail, x, r)

    monkeypatch.setattr(tmg, "vcycle_tail", counted)
    (dj, cj), (dt, ct) = _cell_system((14, 12, 10), 0)
    rng = np.random.default_rng(2)
    r = rng.standard_normal((14, 12, 10)).astype(np.float32)
    z_t = tmg.make_mg_preconditioner(dt, ct)(torch.from_numpy(r)).numpy()
    assert calls == [(14, 12, 10)]
    faces = _face_systems((8, 10, 6), 7)
    rs = [rng.standard_normal(tuple(d.shape)).astype(np.float32) for _, (d, _) in faces]
    zb_t = [z.numpy() for z in tmg.make_batched_mg_preconditioner([t for _, t in faces])(
        tuple(torch.from_numpy(x) for x in rs))]
    assert calls[1:] == [(3, 9, 11, 7)]
    z_xla = np.asarray(jmg.make_mg_preconditioner(dj, cj)(jnp.asarray(r)))
    zb_xla = jmg.make_batched_mg_preconditioner([j for j, _ in faces])(tuple(jnp.asarray(x) for x in rs))
    make = pallas_mg.make_level_kernels
    monkeypatch.setattr(pallas_mg, "level_kernels_available", lambda s: True)
    monkeypatch.setattr(pallas_mg, "make_level_kernels", lambda d, c, **kw: make(d, c, **{**kw, "interpret": True}))
    z_fused = np.asarray(jmg.make_mg_preconditioner(dj, cj)(jnp.asarray(r)))
    zb_fused = jmg.make_batched_mg_preconditioner([j for j, _ in faces])(tuple(jnp.asarray(x) for x in rs))
    for got, want in ((z_t, z_xla), (z_t, z_fused)):
        np.testing.assert_allclose(got, want, **VCYCLE_TOL)
    for a in range(3):
        np.testing.assert_allclose(zb_t[a], np.asarray(zb_xla[a]), **VCYCLE_TOL)
        np.testing.assert_allclose(zb_t[a], np.asarray(zb_fused[a]), **VCYCLE_TOL)


def test_wrapper_counts_no_cpu_launch_and_refuses_meta():
    tail = _tail_batched()
    x, r = _inputs(tail, 4)
    before = (cuda_mg.vcycle_tail.launches, cuda_mg.vcycle_tail.batched_launches)
    cuda_mg.vcycle_tail(tail, x, r)
    assert (cuda_mg.vcycle_tail.launches, cuda_mg.vcycle_tail.batched_launches) == before
    with pytest.raises(ValueError):
        cuda_mg.vcycle_tail(tail, x.to("meta"), r.to("meta"))
    with pytest.raises(ValueError):  # no level below level 0
        cuda_mg.make_vcycle_tail(tail.levels[:1], **KW)
