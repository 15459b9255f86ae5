"""The port's utilities (``utils/``, ``native/``) on the CPU: its copy of
``tests/test_utils.py:38-174``, and cross checks against the JAX
package:

* a port checkpoint restored by JAX ``restore_checkpoint`` gives the same
  arrays and config, and the port restores JAX's npz checkpoints;
* ``ParticleSeries`` pickles load equal to JAX's for the same positions;
* the port's native marching cubes (built here with ``g++``) gives the
  same triangles as JAX ``native.marching_cubes.run`` on the same
  sphere field, and vertices within 1e-6 (JAX may load its committed
  library, built with other flags);
* ``step_bytes_model`` and ``roofline`` equal JAX's on the same inputs.
"""

import base64
import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu import config as j_config
from python_fluid_simulation_tpu.utils import checkpoint as j_checkpoint
from python_fluid_simulation_tpu.utils import io as j_io
from python_fluid_simulation_tpu.utils import roofline as j_roofline
from python_fluid_simulation_tpu_torch import native
from python_fluid_simulation_tpu_torch.config import SimConfig
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, moving_box_config
from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState
from python_fluid_simulation_tpu_torch.utils import roofline
from python_fluid_simulation_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from python_fluid_simulation_tpu_torch.utils.io import (
    ParticleSeries,
    export_levelset_obj,
    marching_cubes_plain,
    snapshot_interval,
    triangulate_levelset,
)
from python_fluid_simulation_tpu_torch.utils.metrics import MetricsLogger, summarize
from python_fluid_simulation_tpu_torch.utils.timers import CLOCKS, SPANS, profiler_trace
from python_fluid_simulation_tpu_torch.utils.viewer import export_html_replay

torch.set_num_threads(1)

LEAVES = ("x", "v", "c", "m", "phi", "sv", "rb", "t", "step_idx", "visc_mg")


def _dummy_state(n=10, seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return SimState(
        particles=Particles(x=r(n, 3), v=r(n, 3), c=r(n, 3, 3), m=r(n)),
        solid=SolidState(phi=r(5, 5, 5), v=r(5, 5, 5, 3), rb=r(1, 10, 4)),
        t=torch.tensor(1.5),
        step_idx=torch.tensor(7, dtype=torch.int32),
        visc_mg=torch.tensor(2, dtype=torch.int32),
    )


def _leaves(state):
    p, s = state.particles, state.solid
    return [np.asarray(a) for a in (p.x, p.v, p.c, p.m, s.phi, s.v, s.rb, state.t, state.step_idx, state.visc_mg)]


def _sphere_phi(n=24, r=0.3):
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - r


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)
    log.log(0, {"dt": torch.tensor(0.01), "iters": torch.tensor(5, dtype=torch.int32)})
    log.log(1, {"dt": np.float32(0.02), "iters": torch.tensor(7, dtype=torch.int32), "ok": torch.tensor(True)})
    log.close()
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["dt"] == pytest.approx(0.01)
    assert recs[1]["iters"] == 7 and recs[1]["ok"] is True
    assert summarize(log.history)["iters"] == 6.0


def test_metrics_log_scan_unstacks(tmp_path):
    log = MetricsLogger(None)
    log.log_scan({"dt": torch.tensor([0.1, 0.2, 0.3]), "iters": torch.tensor([3, 4, 5])}, start_step=15)
    assert [r["step"] for r in log.history] == [15, 16, 17]
    assert [r["iters"] for r in log.history] == [3, 4, 5]
    assert summarize([]) == {}


def test_checkpoint_roundtrip(tmp_path):
    state = _dummy_state()
    cfg = buckling_config(dx=0.05)
    save_checkpoint(str(tmp_path / "ck"), state, cfg, 7)
    restored, cfg2, step = restore_checkpoint(str(tmp_path / "ck"), device="cpu")
    assert step == 7 and cfg2 == cfg
    for got, want in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(got, want)
    assert restored.t.dtype == torch.float32 and restored.t.ndim == 0
    assert restored.step_idx.dtype == restored.visc_mg.dtype == torch.int32
    assert restored.step_idx.ndim == restored.visc_mg.ndim == 0


def test_checkpoint_latest_step_and_config_fields(tmp_path):
    ck = str(tmp_path / "ck")
    assert latest_step(ck) is None
    cfg = moving_box_config(dx=0.25)  # moving_solid survives the round trip
    for step in (2, 10, 4):
        save_checkpoint(ck, _dummy_state(seed=step), cfg, step)
    assert latest_step(ck) == 10
    restored, cfg2, step = restore_checkpoint(ck, step=4, device="cpu")
    assert step == 4 and cfg2 == cfg and cfg2.moving_solid
    np.testing.assert_array_equal(restored.particles.x.numpy(), _dummy_state(seed=4).particles.x.numpy())
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), device="cpu")


def test_checkpoint_2d_round_trips_with_jax(tmp_path, monkeypatch):
    """A 2D checkpoint (``SimConfig2D``, (K, 2, 2) APIC rows, the sdf2d
    table): JAX ``restore_checkpoint`` reads the port's to the same arrays
    and an equal config, and the port reads JAX's (written without
    Orbax) back to the state it came from."""
    from python_fluid_simulation_tpu.engine import step2d as j_step2d
    from python_fluid_simulation_tpu_torch.engine.step2d import SimConfig2D, dam_break_scene_2d

    cfg = SimConfig2D()
    _, state = dam_break_scene_2d(cfg, device="cpu")
    state = dataclasses.replace(state, t=torch.tensor(0.25), step_idx=torch.tensor(9, dtype=torch.int32),
                                visc_mg=torch.tensor(0, dtype=torch.int32))
    save_checkpoint(str(tmp_path / "ck"), state, cfg, 9)
    j_state, j_cfg, step = j_checkpoint.restore_checkpoint(str(tmp_path / "ck"))
    assert step == 9 and isinstance(j_cfg, j_step2d.SimConfig2D)
    assert j_checkpoint._config_to_json(j_cfg) == (tmp_path / "ck" / "config.json").read_text()
    j_leaves = [np.asarray(a) for a in (j_state.particles.x, j_state.particles.v, j_state.particles.c,
                                        j_state.particles.m, j_state.solid.phi, j_state.solid.v, j_state.solid.rb,
                                        j_state.t, j_state.step_idx, j_state.visc_mg)]
    for name, got, want in zip(LEAVES, j_leaves, _leaves(state)):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert j_leaves[2].shape[1:] == (2, 2) and j_leaves[6].shape[1:] == (8, 3)

    monkeypatch.setattr(j_checkpoint, "_HAS_ORBAX", False)
    j_checkpoint.save_checkpoint(str(tmp_path / "jk"), j_state, j_cfg, 11)
    restored, cfg2, step = restore_checkpoint(str(tmp_path / "jk"), device="cpu")
    assert step == 11 and cfg2 == cfg
    for name, got, want in zip(LEAVES, _leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_port_checkpoint_restored_by_jax(tmp_path):
    """JAX ``restore_checkpoint`` reads a port checkpoint through its npz
    branch to the same arrays and an equal config."""
    state = _dummy_state(seed=3)
    cfg = buckling_config(dx=0.05)
    save_checkpoint(str(tmp_path / "ck"), state, cfg, 15)
    j_state, j_cfg, step = j_checkpoint.restore_checkpoint(str(tmp_path / "ck"))
    assert step == 15
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(cfg)
    j_leaves = [np.asarray(a) for a in (j_state.particles.x, j_state.particles.v, j_state.particles.c,
                                        j_state.particles.m, j_state.solid.phi, j_state.solid.v, j_state.solid.rb,
                                        j_state.t, j_state.step_idx, j_state.visc_mg)]
    for name, got, want in zip(LEAVES, j_leaves, _leaves(state)):
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the config file is byte for byte what the JAX package writes
    j_cfg_same = j_config.SimConfig.from_json(cfg.to_json())
    assert (tmp_path / "ck" / "config.json").read_text() == j_checkpoint._config_to_json(j_cfg_same)


def test_jax_npz_checkpoint_restored_by_port(tmp_path, monkeypatch):
    """The port reads what the JAX package writes without Orbax."""
    monkeypatch.setattr(j_checkpoint, "_HAS_ORBAX", False)
    state = _dummy_state(seed=5)
    j_state = j_checkpoint.SimState(
        particles=j_checkpoint.Particles(*(jnp.asarray(a.numpy()) for a in (state.particles.x, state.particles.v,
                                                                            state.particles.c, state.particles.m))),
        solid=j_checkpoint.SolidState(*(jnp.asarray(a.numpy()) for a in (state.solid.phi, state.solid.v,
                                                                         state.solid.rb))),
        t=jnp.float32(1.5), step_idx=jnp.int32(7), visc_mg=jnp.int32(2),
    )
    j_cfg = j_config.SimConfig()
    j_checkpoint.save_checkpoint(str(tmp_path / "jk"), j_state, j_cfg, 30)
    restored, cfg, step = restore_checkpoint(str(tmp_path / "jk"), device="cpu")
    assert step == 30 and dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    for got, want in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(got, want)


def test_particle_series_matches_reference_layout(tmp_path):
    s = ParticleSeries()
    pos = np.arange(12, dtype=np.float32).reshape(4, 3)
    s.snapshot(0.5, torch.from_numpy(pos))
    p = str(tmp_path / "ps.pickle")
    s.save(p)
    got = ParticleSeries.load(p).series[0.5]
    # reference stores [x, z, y] (cell 13 :4666)
    np.testing.assert_array_equal(got, pos[:, [0, 2, 1]])
    assert snapshot_interval(1 / 300.0) == 15  # int(1/DT/20), cell 13


def test_particle_series_pickle_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    snaps = [(0.0, rng.random((20, 3)).astype(np.float32)), (0.05, rng.random((20, 3)).astype(np.float32))]
    ours, theirs = ParticleSeries(), j_io.ParticleSeries()
    for t, pos in snaps:
        ours.snapshot(t, torch.from_numpy(pos))
        theirs.snapshot(t, jnp.asarray(pos))
    ours.save(str(tmp_path / "a.pickle"))
    theirs.save(str(tmp_path / "b.pickle"))
    a = j_io.ParticleSeries.load(str(tmp_path / "a.pickle")).series
    b = ParticleSeries.load(str(tmp_path / "b.pickle")).series
    assert list(a) == list(b)
    for t in a:
        assert a[t].dtype == b[t].dtype == np.float32
        np.testing.assert_array_equal(a[t], b[t])


def test_export_obj_native(tmp_path):
    phi = _sphere_phi()
    path = str(tmp_path / "s.obj")
    ntris = export_levelset_obj(torch.from_numpy(phi), path, spacing=(1 / 23,) * 3)
    assert ntris > 100
    txt = open(path).read()
    assert txt.count("\nf ") == ntris
    assert native.library_path().exists()


def test_native_marching_cubes_matches_sphere_area():
    n = 32
    phi = _sphere_phi(n, 0.3)
    verts, tris = native.marching_cubes.run(phi, 0.0)
    assert len(tris) > 100
    # triangle area sum approximates the sphere area (in voxel units)
    v = verts[tris]
    a = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    area = 0.5 * np.linalg.norm(a, axis=1).sum()
    h = 1.0 / (n - 1)
    expected = 4 * np.pi * (0.3 / h) ** 2
    assert abs(area - expected) / expected < 0.12
    # vertices lie near the zero set
    center = (n - 1) / 2
    rad = np.linalg.norm(verts - center, axis=1) * h
    assert np.abs(rad - 0.3).max() < 0.05


def test_native_marching_cubes_matches_jax_and_plain():
    from python_fluid_simulation_tpu.native import marching_cubes as j_mc

    phi = _sphere_phi(20, 0.27)
    verts, tris = native.marching_cubes.run(phi, 0.0)
    j_verts, j_tris = j_mc.run(phi, 0.0)
    np.testing.assert_array_equal(tris, j_tris)
    np.testing.assert_allclose(verts, j_verts, rtol=0, atol=1e-6 * float(np.abs(j_verts).max()))
    # the NumPy version of the same scheme: same triangles, vertices to fp32
    p_verts, p_tris = marching_cubes_plain(phi, 0.0)
    np.testing.assert_array_equal(tris, p_tris)
    np.testing.assert_allclose(verts, p_verts, rtol=0, atol=1e-5)
    w_verts, w_tris = triangulate_levelset(torch.from_numpy(phi), origin=(1.0, 2.0, 3.0), spacing=(0.5, 0.25, 0.125))
    np.testing.assert_array_equal(w_tris, tris)
    np.testing.assert_array_equal(w_verts, verts * np.float32([0.5, 0.25, 0.125]) + np.float32([1.0, 2.0, 3.0]))


def test_native_build_failure_raises(monkeypatch):
    """No fallback: a library that does not build raises."""
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag-for-this-test"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._Native().get()


def test_html_replay_export(tmp_path):
    rng = np.random.default_rng(0)
    series = {0.0: rng.random((50, 3)).astype(np.float32), 0.1: rng.random((50, 3)).astype(np.float32)}
    path = str(tmp_path / "replay.html")
    assert export_html_replay(series, path) == 2
    html = open(path).read()
    assert "num_points" in html and html.startswith("<!DOCTYPE html>")
    # embedded payload decodes back to the particle data
    b64 = re.search(r'atob\("([^"]+)"\)', html).group(1)
    buf = np.frombuffer(base64.b64decode(b64), np.float32).reshape(2, 50, 3)
    np.testing.assert_array_equal(buf[0], series[0.0])


def test_html_replay_export_2d(tmp_path):
    series = {0.0: np.random.default_rng(1).random((30, 2)).astype(np.float32)}
    assert export_html_replay(series, str(tmp_path / "r2.html")) == 1


def test_config_yaml_roundtrip(tmp_path):
    cfg = SimConfig()
    p = str(tmp_path / "cfg.yaml")
    open(p, "w").write(cfg.to_yaml())
    assert SimConfig.load(p) == cfg


def test_step_bytes_model_and_roofline_equal_jax():
    iters = {"pressure_iters": 53.4, "density_iters": 41, "viscosity_iters": 22.5}
    for res, k in (((48, 80, 48), 89648), ((77, 128, 77), 356256)):
        assert roofline.step_bytes_model(res, k, iters) == j_roofline.step_bytes_model(res, k, iters)
        for measured in (None, 3.1e9):
            assert roofline.roofline(res, k, iters, 19.5, measured_bytes_per_step=measured) == \
                j_roofline.roofline(res, k, iters, 19.5, measured_bytes_per_step=measured)


def test_roofline_h100_peak():
    assert roofline.chip_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert roofline.chip_peak_gbps("TPU v5 lite") is None and roofline.chip_peak_gbps(None) is None
    out = roofline.roofline((48, 80, 48), 89648, {"pressure_iters": 50}, 20.0, device_kind="NVIDIA H100 80GB HBM3")
    nbytes = roofline.step_bytes_model((48, 80, 48), 89648, {"pressure_iters": 50})["bytes_per_step"]
    assert out["peak_gbps"] == 3350.0
    assert out["floor_ms_per_step"] == round(nbytes / 3350e9 * 1e3, 2)
    assert out["hbm_util"] == round(nbytes / 20e-3 / 1e9 / 3350.0, 3)


def test_phase_timer_and_profiler_trace(tmp_path):
    """``profiler_trace`` (the CLI's ``--profile-dir``) writes the Chrome
    trace, which holds the replay loop's ``pfs_simulate`` span, and
    ``phases.json``: the step's phase clocks over the calls inside it (on
    the CPU the host's clock), per step, and the spans' names."""
    from python_fluid_simulation_tpu_torch.engine.scenes import buckling_scene
    from python_fluid_simulation_tpu_torch.engine.step import simulate

    with profiler_trace(None):
        pass
    cfg = buckling_config(dx=0.05)
    state = buckling_scene(cfg, device="cpu")
    simulate(state, cfg, 1)  # outside the scope: not in phases.json
    with profiler_trace(str(tmp_path / "prof")):
        simulate(state, cfg, 2)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert "pfs_simulate" in {e.get("name") for e in trace["traceEvents"]}
    phases = json.loads((tmp_path / "prof" / "phases.json").read_text())
    card = phases["cards"]["cpu"]
    assert card["steps"] == 2 and card["calls"] == 1 and card["clock"] == "host perf_counter_ns"
    assert list(card["phase_ms_per_step"]) == list(CLOCKS)
    assert all(v >= 0 for v in card["phase_ms_per_step"].values())
    assert card["grid_ms_per_step"] + card["solve_ms_per_step"] == pytest.approx(
        sum(v for k, v in card["phase_ms_per_step"].items() if k != "between"))
    assert card["nodes_per_step"] == 0 and card["loops"] == [] and phases["spans"] == SPANS
