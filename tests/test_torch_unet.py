"""The learned viscosity operator of the PyTorch port ('unet' and
'unet_warm') against the JAX package, on CPU.

* ``models/unet3d.py``: `UNet3D` at width 8 against the Flax `UNet3D` on
  the same seeded weights carried through `unet_state_dict_from_flax`
  (a 32^3 box, atol 2e-5: test_unet.py's); the banked width-64
  checkpoint read by the port's msgpack reader (no flax) against Flax
  ``apply`` on the ``flax.serialization``-loaded params (max |diff| /
  max |out| <= 1e-4); bf16 compute against fp32 (atol 0.05, test_unet.py's).
* ``convert.py``: the converter's round trip through the JAX package's
  ``torch_state_dict_to_flax``, bitwise both ways; the reference's
  ``{'net': state_dict}`` files.
* ``models/features.py`` and ``models/train.py``: the feature box, the
  Δv extraction, the padded box and the training pair on the flagship's
  real fields (the port's second step, 48x80x48), bitwise.
* ``solvers/viscosity.py`` with ``warm_start``: the flagship's viscosity
  system of that step started from a width-8 network's guess, against
  JAX ``viscosity_solve_3d(warm_start=..., use_pallas="off")`` for
  'jacobi', 'mg', 'auto' on both flags and ``jacobi_precond=False``: the
  line search's α within 1e-6 (relative) of the exact α of the port's
  fp32 vectors and within 1e-5 of JAX's (whose fp32 ``vdot`` on the CPU
  misses the exact one by more than 1e-6 here), iterations equal
  (within 3 unpreconditioned, as tests/test_torch_solver_options.py
  found), solutions within 1e-5.
* ``engine/step.py``: one flagship step (89,648 particles) in each mode
  with a width-8 network against the JAX step from the same scene state,
  with tests/test_torch_flagship.py's exact-sum patch of the JAX
  package's CPU segment sums applied in the test: iterations equal, x /
  v / APIC rows within 1e-5 / 1e-4 / 1e-3; ``capture_ml`` "raw" and
  ``True`` against the JAX step; the mode's refusals.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu.models import convert as j_convert
from python_fluid_simulation_tpu.models import features as j_features
from python_fluid_simulation_tpu.models import train as j_train
from python_fluid_simulation_tpu.models.unet3d import UNet3D as JUNet3D
from python_fluid_simulation_tpu.ops import scatter as j_scatter
from python_fluid_simulation_tpu.solvers import viscosity as j_visc
from python_fluid_simulation_tpu_torch.convert import (
    load_flax_msgpack,
    load_reference_checkpoint,
    random_flax_unet_params,
    state_from_numpy,
    unet_state_dict_from_flax,
)
from python_fluid_simulation_tpu_torch.engine import step as step_mod
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene
from python_fluid_simulation_tpu_torch.engine.step import simulate, step_3d
from python_fluid_simulation_tpu_torch.models import features, train
from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D
from python_fluid_simulation_tpu_torch.solvers import viscosity

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "unet_prod", "unet_width64.msgpack")
STEP_TOL = dict(x=1e-5, v=1e-4, c=1e-3)
FLAGSHIP_DUAL = (97, 161, 97)


def _net(width, seed=0, dtype=torch.float32):
    params = random_flax_unet_params(width, seed=seed)
    net = UNet3D(width=width, dtype=dtype)
    net.load_state_dict(unet_state_dict_from_flax(params))
    return net.eval(), params


def _jparams(params):
    return jax.tree.map(jnp.asarray, params)


def _box(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _to_jax_layout(x):
    """(N, C, D, H, W) -> (N, D, H, W, C)."""
    return np.transpose(x, (0, 2, 3, 4, 1))


def _with(cfg, **solver):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, **solver))


def _close(got, want, rel=1e-5):
    """Within rel of the largest |want| (test_torch_transfers.py's volume
    bound: P2G's sums in another rounding)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def _exact_segment_sum(vals, sorted_ids, num_segments, widen=False):
    return jax.ops.segment_sum(vals, sorted_ids, num_segments=num_segments, indices_are_sorted=True)


# -- the network


def test_unet_matches_flax_unet():
    net, params = _net(8)
    x = _box((1, 11, 32, 32, 32), 0)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(JUNet3D(width=8).apply(_jparams(params), jnp.asarray(_to_jax_layout(x))))
    assert got.shape == (1, 3, 32, 32, 32) and got.dtype == np.float32
    np.testing.assert_allclose(_to_jax_layout(got), want, atol=2e-5)


def test_banked_checkpoint_matches_flax_apply():
    if not os.path.exists(CKPT):
        pytest.skip("banked ckpt not present (run train_unet_prod.py)")
    import flax.serialization

    params = load_flax_msgpack(CKPT)
    sd = unet_state_dict_from_flax(params)
    assert sum(v.numel() for v in sd.values()) == 68_723_203
    net = UNet3D(width=64).eval()
    net.load_state_dict(sd)
    x = _box((1, 11, 32, 48, 32), 1)
    with torch.no_grad():
        got = _to_jax_layout(net(torch.from_numpy(x)).numpy())

    model = JUNet3D(width=64)
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 16, 11))))
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), template)
    with open(CKPT, "rb") as f:
        j_params = flax.serialization.from_bytes(template, f.read())
    want = np.asarray(model.apply(j_params, jnp.asarray(_to_jax_layout(x))))
    assert np.abs(got - want).max() / np.abs(want).max() <= 1e-4


def test_bf16_compute_close_to_fp32():
    net32, params = _net(4, seed=3)
    net16 = UNet3D(width=4, dtype=torch.bfloat16)
    net16.load_state_dict(unet_state_dict_from_flax(params))
    x = torch.from_numpy(_box((1, 11, 16, 16, 16), 3))
    with torch.no_grad():
        y32, y16 = net32(x), net16(x)
    assert y16.dtype == torch.float32 and all(p.dtype == torch.float32 for p in net16.parameters())
    assert torch.isfinite(y16).all()
    np.testing.assert_allclose(y16.numpy(), y32.numpy(), atol=0.05)


# -- the converter


def test_converter_round_trips_through_the_jax_converter():
    params = random_flax_unet_params(4, seed=5)
    sd = unet_state_dict_from_flax(params)
    back = j_convert.torch_state_dict_to_flax({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back) == 23 * 2
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf, err_msg=str(path))
    # and from a torch state_dict through the JAX converter and back
    net = UNet3D(width=4)
    again = unet_state_dict_from_flax(j_convert.torch_state_dict_to_flax(net.state_dict()))
    assert again.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(again[k], v), k


def test_reference_checkpoint_format(tmp_path):
    net, _ = _net(4, seed=6)
    x = torch.from_numpy(_box((1, 11, 16, 16, 16), 6))
    for name, payload in (("ref.pth", {"net": net.state_dict()}), ("bare.pth", net.state_dict())):
        torch.save(payload, tmp_path / name)
        loaded = UNet3D(width=4).eval()
        loaded.load_state_dict(load_reference_checkpoint(tmp_path / name))
        with torch.no_grad():
            assert torch.equal(loaded(x), net(x)), name


# -- the features on the flagship's real fields


@pytest.fixture(scope="module")
def flagship_fields():
    """The inputs of the second flagship step's viscosity solve, from the
    port on the CPU: gm, gv (after gravity), the raw sphi, the lvol
    classes, dt and the solve's keyword arguments."""
    cfg = buckling_config()
    state = buckling_scene(cfg, device="cpu")
    state, _ = step_3d(state, cfg)
    got = {}
    orig_p2g, orig_solve = step_mod.p2g_all, step_mod.viscosity_solve_3d

    def rec_p2g(*a, **kw):
        out = orig_p2g(*a, **kw)
        got["gm"] = out[0]
        return out

    def rec_solve(dt, mu, rho, v_faces, sphi_c, lvol, cell_vol, **kw):
        got.update(dt=dt, v_faces=v_faces, sphi_c=sphi_c, lvol=lvol, kw=kw)
        return orig_solve(dt, mu, rho, v_faces, sphi_c, lvol, cell_vol, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "p2g_all", rec_p2g)
        mp.setattr(step_mod, "viscosity_solve_3d", rec_solve)
        step_3d(state, cfg)
    got["sphi"] = state.solid.phi
    got["cfg"] = cfg
    assert tuple(got["sphi"].shape) == FLAGSHIP_DUAL
    return got


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_features_match_jax_bitwise(flagship_fields):
    f = flagship_fields
    cfg = f["cfg"]
    assert features.padded_box(FLAGSHIP_DUAL) == j_features.padded_box(FLAGSHIP_DUAL) == ((112, 176, 112), (7, 7, 7))
    gv, sphi, lvol = f["v_faces"], f["sphi"], f["lvol"]
    j_gv = [jnp.asarray(_np(g)) for g in gv]
    j_lvol = {k: jnp.asarray(_np(v)) for k, v in lvol.items()}
    want = _np(j_features.build_unet_input(j_gv, jnp.asarray(_np(sphi)), j_lvol, cfg.grid.dx**3))
    for lv in (lvol, step_mod.merge_parity(lvol, FLAGSHIP_DUAL)):  # the classes and the merged lattice
        got = features.build_unet_input(gv, sphi, lv, cfg.grid.dx**3)
        assert got.shape == (1, 11, 112, 176, 112)
        np.testing.assert_array_equal(_to_jax_layout(got.numpy()), want)

    out = _box((1, 3, 112, 176, 112), 7)
    shapes = [tuple(g.shape) for g in gv]
    got = features.extract_delta_v(torch.from_numpy(out), FLAGSHIP_DUAL, shapes)
    want = j_features.extract_delta_v(jnp.asarray(_to_jax_layout(out)), FLAGSHIP_DUAL, shapes)
    for a in range(3):
        np.testing.assert_array_equal(got[a].numpy(), _np(want[a]))

    after = [g + torch.from_numpy(_box(tuple(g.shape), 8 + a)) * 1e-3 for a, g in enumerate(gv)]
    got = train.capture_viscosity_pair(gv, after, sphi, lvol, cfg)
    want = j_train.capture_viscosity_pair(j_gv, [jnp.asarray(_np(g)) for g in after], jnp.asarray(_np(sphi)),
                                          j_lvol, cfg)
    for name in ("x", "y", "mask"):
        np.testing.assert_array_equal(_to_jax_layout(getattr(got, name).numpy()), _np(getattr(want, name)), err_msg=name)


# -- the warm-started viscosity solve


def test_rescaled_warm_start_line_search():
    """x0 minimises the residual along the line (never above the start's)
    and α = 0 when the direction is 0 (a 0/0 line search)."""
    f_shapes = [(5, 4, 4), (4, 5, 4), (4, 4, 5)]
    rng = np.random.default_rng(11)
    mats = [torch.from_numpy(rng.standard_normal((int(np.prod(s)),) * 2).astype(np.float32)) for s in f_shapes]

    def matvec(vs):
        return tuple((m @ v.reshape(-1)).reshape(v.shape) for m, v in zip(mats, vs))

    b, ext, warm = ([torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in f_shapes] for _ in range(3))

    def resid(x):
        return sum(float(((bb - q) ** 2).sum()) for bb, q in zip(b, matvec(x)))

    x0, alpha = viscosity.rescaled_warm_start(matvec, b, ext, warm)
    assert resid(x0) <= resid(ext) * (1 + 1e-6)
    for eps in (-1e-2, 1e-2):
        assert resid(x0) <= resid(tuple(x + eps * (w - e) for x, w, e in zip(x0, warm, ext))) * (1 + 1e-6)
    x0, alpha = viscosity.rescaled_warm_start(matvec, b, ext, ext)
    assert float(alpha) == 0.0 and all(torch.equal(x, e) for x, e in zip(x0, ext))


@pytest.fixture(scope="module")
def flagship_warm(flagship_fields):
    """The network's guess for that solve: where(gm > 0, gv + Δv, gv) with
    Δv from a seeded width-8 network."""
    f = flagship_fields
    net, _ = _net(8, seed=2)
    dv = features.unet_delta_v(net, f["v_faces"], f["sphi"], f["lvol"], f["cfg"])
    return tuple(torch.where(m > 0, g + d, g) for m, g, d in zip(f["gm"], f["v_faces"], dv))


WARM_CASES = {
    "jacobi": dict(precond_kind="jacobi"),
    "mg": dict(precond_kind="mg"),
    "auto_jacobi": dict(precond_kind="auto", auto_use_mg=False),
    "auto_mg": dict(precond_kind="auto", auto_use_mg=True),
    "no_jacobi_precond": dict(precond_kind="jacobi", jacobi_precond=False),
}


@pytest.mark.parametrize("case", list(WARM_CASES))
def test_warm_started_viscosity_solve_matches_jax(case, flagship_fields, flagship_warm, monkeypatch):
    f = flagship_fields
    cfg = f["cfg"]
    kw = dict(tol=cfg.solver.tol, rel_tol=cfg.solver.rel_tol, max_iter=cfg.solver.max_iter, **WARM_CASES[case])
    ph = cfg.physics
    args = (f["dt"], ph.mu, ph.rho, f["v_faces"], f["sphi_c"], f["lvol"], cfg.grid.cell_vol)

    alphas, j_x0 = [], []
    calls = {"coupled_matvec_geom": 0, "coupled_stencil_matvec": 0}
    for name in ("rescaled_warm_start", "coupled_matvec_geom", "coupled_stencil_matvec"):
        fn = getattr(viscosity, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            if _name == "rescaled_warm_start":
                alphas.append((a, out))
            else:
                calls[_name] += 1
            return out

        monkeypatch.setattr(viscosity, name, wrapped)
    res = viscosity.viscosity_solve_3d(*args, warm_start=flagship_warm, **kw)
    assert len(alphas) == 1
    if case == "jacobi":  # the two line-search matvecs are the geometry matvec (row 4)
        assert calls == {"coupled_matvec_geom": 2, "coupled_stencil_matvec": 0}
    if case == "no_jacobi_precond":  # the prepared materialised matvec (rows 7-8)
        assert calls["coupled_matvec_geom"] == 0 and calls["coupled_stencil_matvec"] > 2

    def rec_cg(*a, **k):
        if not isinstance(a[2][0], jax.core.Tracer):
            j_x0.append(a[2])
        return j_cg(*a, **k)

    j_cg = j_visc.cg
    monkeypatch.setattr(j_visc, "cg", rec_cg)
    j_kw = dict(kw)
    if "auto_use_mg" in j_kw:
        j_kw["auto_use_mg"] = jnp.bool_(j_kw["auto_use_mg"])
    j_args = (jnp.asarray(_np(f["dt"])),) + args[1:3] + (
        tuple(jnp.asarray(_np(v)) for v in f["v_faces"]),
        {k: jnp.asarray(_np(v)) for k, v in f["sphi_c"].items()},
        {k: jnp.asarray(_np(v)) for k, v in f["lvol"].items()}, cfg.grid.cell_vol)
    want = j_visc.viscosity_solve_3d(*j_args, warm_start=tuple(jnp.asarray(_np(w)) for w in flagship_warm),
                                     use_pallas="off", **j_kw)

    # α: the port's against the exact α of its fp32 vectors (b - A ext and
    # A p, dots in float64), and against JAX's, projected from the x0 its
    # CG started from.  JAX's fp32 vdot on the CPU lands further than 1e-6
    # from the exact α on this system; the port's fp32 dots do not
    (matvec, b, ext, warm), (x0, alpha) = alphas[0]
    p = tuple(w - e for w, e in zip(warm, ext))
    ap, r = matvec(p), tuple(bb - q for bb, q in zip(b, matvec(ext)))

    def f64(ts):
        return np.concatenate([_np(t).reshape(-1).astype(np.float64) for t in ts])

    exact = float(f64(r) @ f64(ap) / (f64(ap) @ f64(ap)))
    assert float(alpha) != 0.0 and abs(float(alpha) - exact) <= 1e-6 * abs(exact), (float(alpha), exact)
    if j_x0:
        j_alpha = float((f64(j_x0[0]) - f64(ext)) @ f64(p) / (f64(p) @ f64(p)))
        assert abs(float(alpha) - j_alpha) <= 1e-5 * abs(j_alpha), (float(alpha), j_alpha)
    else:  # 'auto' solves inside lax.cond: its x0 is the 'jacobi' case's (the same line search)
        assert case.startswith("auto")
    it, j_it = int(res.stats.iters), int(want.stats.iters)
    assert it > 0 and bool(res.stats.converged) and bool(want.stats.converged)
    if case == "no_jacobi_precond":
        assert abs(it - j_it) <= 3, (it, j_it)
    else:
        assert it == j_it, (it, j_it)
    for a in range(3):
        np.testing.assert_allclose(res.v_faces[a].numpy(), np.asarray(want.v_faces[a]), atol=1e-5, rtol=0)


# -- the step


@pytest.fixture(scope="module")
def jax_scene():
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene

    return j_scene(j_cfg())


def _start(j_state):
    p, s = j_state.particles, j_state.solid
    return state_from_numpy({"x": p.x, "v": p.v, "c": p.c, "m": p.m, "phi": s.phi, "sv": s.v, "rb": s.rb,
                             "t": j_state.t, "step_idx": j_state.step_idx}, device="cpu")


@pytest.mark.parametrize("mode", ["unet", "unet_warm"])
def test_flagship_step_matches_exact_sum_jax(mode, jax_scene, monkeypatch):
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.step import simulate as j_simulate

    net, params = _net(8)
    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()  # no step traced before the patch may be reused
    try:
        j_final, j_metrics = j_simulate(jax_scene, _with(j_cfg(), viscosity_mode=mode), 1,
                                        unet_apply=JUNet3D(width=8).apply, unet_params=_jparams(params))
        j_final = jax.device_get(j_final)
    finally:
        jax.clear_caches()
    final, metrics = simulate(_start(jax_scene), _with(buckling_config(), viscosity_mode=mode), 1, unet=net)
    assert final.particles.x.shape == (89648, 3)
    for solver in ("density", "viscosity", "pressure"):
        np.testing.assert_array_equal(metrics[f"{solver}_iters"].numpy(), np.asarray(j_metrics[f"{solver}_iters"]))
        assert metrics[f"{solver}_converged"].all()
    for k, tol in STEP_TOL.items():
        np.testing.assert_allclose(getattr(final.particles, k).numpy(), np.asarray(getattr(j_final.particles, k)),
                                   atol=tol, err_msg=k)


@pytest.mark.parametrize("capture", ["raw", True])
def test_capture_ml_matches_jax(capture, monkeypatch):
    """The pair captured around a coarse 'unet_warm' step's viscosity solve
    (12x20x12 cells, width-4 network, after one step from the scene):
    velocities at STEP_TOL's v bound, the target Δv·(1/dt) at that bound
    times 1/dt, the fluid volumes at test_torch_transfers.py's bound, the
    solid mask and the sampling mask bitwise."""
    from python_fluid_simulation_tpu.engine.scenes import buckling_config as j_cfg
    from python_fluid_simulation_tpu.engine.scenes import buckling_scene as j_scene
    from python_fluid_simulation_tpu.engine.step import step_3d as j_step

    monkeypatch.setattr(j_scatter, "segment_sum_sorted", _exact_segment_sum)
    jax.clear_caches()
    net, params = _net(4, seed=4)
    cfg, j_c = _with(buckling_config(dx=0.05), viscosity_mode="unet_warm"), _with(j_cfg(dx=0.05), viscosity_mode="unet_warm")
    try:
        j_state = j_scene(j_c)

        @functools.partial(jax.jit, static_argnums=(1, 3, 4))
        def run(s, c, p, apply_fn, cap):
            return j_step(s, c, apply_fn, p, capture_ml=cap)

        j_state, _ = run(j_state, j_c, _jparams(params), JUNet3D(width=4).apply, False)
        _, j_m = run(j_state, j_c, _jparams(params), JUNet3D(width=4).apply, capture)
        j_pair = jax.device_get(j_m["ml_pair"])
    finally:
        jax.clear_caches()
    _, m = step_3d(_start(jax.device_get(j_state)), cfg, unet=net, capture_ml=capture)
    assert int(m["viscosity_iters"]) > 0
    pair = m["ml_pair"]
    v_tol = STEP_TOL["v"]
    if capture == "raw":
        assert set(pair) == set(j_pair) == {"gv_before", "gv_after", "lvol"}
        for key in ("gv_before", "gv_after"):
            for a in range(3):
                np.testing.assert_allclose(pair[key][a].numpy(), np.asarray(j_pair[key][a]), atol=v_tol, rtol=0)
        _close(pair["lvol"].numpy(), j_pair["lvol"])
        return
    inv_dt = int(round(1.0 / cfg.physics.dt))
    np.testing.assert_array_equal(_to_jax_layout(pair.mask.numpy()), np.asarray(j_pair.mask))
    x, j_x = _to_jax_layout(pair.x.numpy()), np.asarray(j_pair.x)
    np.testing.assert_allclose(x[..., :9], j_x[..., :9], atol=2 * v_tol, rtol=0)  # differences of two velocities
    np.testing.assert_array_equal(x[..., 9], j_x[..., 9])
    _close(x[..., 10], j_x[..., 10])
    np.testing.assert_allclose(_to_jax_layout(pair.y.numpy()), np.asarray(j_pair.y), atol=2 * v_tol * inv_dt, rtol=0)


def test_unet_mode_refusals():
    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    net, _ = _net(4)
    with pytest.raises(ValueError, match="needs a model"):
        step_3d(state, _with(cfg, viscosity_mode="unet"))
    with pytest.raises(ValueError, match="capture_ml"):
        step_3d(state, _with(cfg, viscosity_mode="unet"), unet=net, capture_ml=True)
    with torch.device("meta"):
        meta_net = UNet3D(width=4)
    with pytest.raises(ValueError, match="parameters are on meta"):
        step_3d(state, _with(cfg, viscosity_mode="unet_warm"), unet=meta_net)
    with pytest.raises(ValueError, match="unknown viscosity_mode"):
        step_3d(state, _with(cfg, viscosity_mode="learned"))


def test_unet_warm_without_a_model_is_the_cold_step():
    """'unet_warm' with no model is the 'apic' step, bitwise (JAX
    step.py:373); 'unet' leaves the viscosity stats at 0 iterations,
    converged, whatever the weights."""
    cfg = buckling_config(dx=0.05)
    state, _ = simulate(buckling_scene(cfg, device="cpu"), cfg, 1)
    cold, m_cold = step_3d(state, cfg)
    warm, m_warm = step_3d(state, _with(cfg, viscosity_mode="unet_warm"))
    for k in ("x", "v", "c"):
        assert torch.equal(getattr(cold.particles, k), getattr(warm.particles, k)), k
    assert int(m_cold["viscosity_iters"]) == int(m_warm["viscosity_iters"]) > 0
    net, _ = _net(4)
    _, m = step_3d(state, _with(cfg, viscosity_mode="unet"), unet=net)
    assert int(m["viscosity_iters"]) == 0 and bool(m["viscosity_converged"])
