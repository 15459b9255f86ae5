"""The port's CLI (``python -m python_fluid_simulation_tpu_torch.run``) on
the CPU, on ``--device cpu --scene dam_break --dx 0.125`` (8^3 cells,
125 particles):

* 4 steps in blocks of 2 with every output write every artifact;
* a run resumed from the step-2 checkpoint ends bitwise equal to the
  uninterrupted run and to one ``simulate(..., 4)`` call;
* the metrics JSONL keys are those of JAX ``step_3d`` (read from its
  traced output, ``jax.eval_shape``: no compile);
* ``--bucketed`` without ``--mesh``, ``--mesh`` with a 2D scene and
  ``--device cuda`` without a CUDA device exit with their messages (the
  JAX CLI's);
* the 2D scenes and ``--mesh 2 --bucketed`` run: ``dam_break_2d`` 3 steps
  with every output (its metrics keys those of JAX ``step_2d``, its
  checkpoint a 2D state), ``droplet_2d`` 2 steps, and the bucketed dam
  break with ``bucket_lost`` 0 at every step;
* ``--mesh 2`` runs the sharded step, and the learned modes take seeded
  weights with the JAX CLI's warning line;
* ``simulate``'s held capture is reused or replaced by its key.
"""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from python_fluid_simulation_tpu_torch import run as cli
from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, simulate

torch.set_num_threads(1)

BASE = ["--device", "cpu", "--scene", "dam_break", "--dx", "0.125"]
ALL_OUTPUTS = ["--metrics", "--snapshot-pickle", "--export-obj", "--export-html", "--checkpoint-every", "2"]
LEAVES = 10


def _run(tmp_path, name, *extra):
    out = str(tmp_path / name)
    assert cli.main([*BASE, "--max-steps", "4", "--block", "2", "--out", out, *extra]) == 0
    return out


def _final(out, step=4):
    with np.load(os.path.join(out, "ckpt", f"state_{step}.npz")) as d:
        return [d[f"arr_{i}"] for i in range(LEAVES)]


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    """The uninterrupted 4-step run with every output."""
    tmp = tmp_path_factory.mktemp("cli")
    return _run(tmp, "full", *ALL_OUTPUTS)


def test_cli_writes_every_artifact(full_run):
    names = set(os.listdir(full_run))
    assert {"metrics.jsonl", "ps.pickle", "surface.obj", "replay.html", "ckpt"} <= names
    assert sorted(os.listdir(os.path.join(full_run, "ckpt"))) == ["config.json", "state_2.npz", "state_4.npz"]
    recs = [json.loads(line) for line in open(os.path.join(full_run, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    with open(os.path.join(full_run, "ps.pickle"), "rb") as f:
        series = pickle.load(f)
    assert len(series) == 3 and all(v.shape == (125, 3) and v.dtype == np.float32 for v in series.values())
    assert list(series)[0] == 0.0
    obj = open(os.path.join(full_run, "surface.obj")).read()
    assert obj.count("\nf ") > 10
    html = open(os.path.join(full_run, "replay.html")).read()
    assert html.startswith("<!DOCTYPE html>") and '"solid_edges": 0' not in html  # the wireframe is in
    assert int(_final(full_run)[8]) == 4  # step_idx


def test_cli_resume_is_bitwise(full_run, tmp_path):
    """Resume from the step-2 checkpoint to step 4: the same state, bit
    for bit, as the uninterrupted run and as one simulate call."""
    ck = tmp_path / "from2"
    ck.mkdir()
    for name in ("config.json", "state_2.npz"):
        shutil.copy(os.path.join(full_run, "ckpt", name), ck / name)
    resumed = _run(tmp_path, "resumed", "--checkpoint-every", "2", "--resume", str(ck))
    assert sorted(os.listdir(os.path.join(resumed, "ckpt"))) == ["config.json", "state_4.npz"]
    want = _final(full_run)
    for i, (got, ref) in enumerate(zip(_final(resumed), want)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref), i

    args = cli.build_argparser().parse_args(BASE)
    cfg, make_scene = cli.make_config(args)
    state = make_scene(cfg, device="cpu")
    one, _ = simulate(state, cfg, 4, geom=build_geom_cache(state.solid))
    for i, got in enumerate([one.particles.x, one.particles.v, one.particles.c, one.particles.m, one.t,
                             one.step_idx]):
        assert np.array_equal(got.numpy(), want[[0, 1, 2, 3, 7, 8][i]]), i


def test_cli_metric_keys_are_jax_step_3d_keys(full_run):
    import jax
    import jax.numpy as jnp

    from python_fluid_simulation_tpu import config as j_config
    from python_fluid_simulation_tpu.engine.step import step_3d as j_step_3d
    from python_fluid_simulation_tpu.state import Particles, SimState, SolidState

    x, v, c, m, phi, sv, rb, t, k, visc_mg = (jnp.asarray(a) for a in _final(full_run))
    with open(os.path.join(full_run, "ckpt", "config.json")) as f:
        cfg = j_config.SimConfig.from_json(f.read())
    state = SimState(Particles(x, v, c, m), SolidState(phi, sv, rb), t, k, visc_mg)
    _, metrics = jax.eval_shape(lambda s: j_step_3d(s, cfg), state)
    rec = json.loads(open(os.path.join(full_run, "metrics.jsonl")).readline())
    assert set(rec) == set(metrics) | {"step", "wall_time_s"}


@pytest.mark.parametrize("argv, message", [
    (["--bucketed"], "--bucketed requires --mesh N"),
    (["--scene", "dam_break_2d", "--mesh", "2"], "--mesh applies to 3D scenes only"),
    (["--scene", "droplet_2d", "--mesh", "2", "--bucketed"], "--mesh applies to 3D scenes only"),
])
def test_cli_refuses_unported_paths(argv, message, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli.main([*argv, "--device", "cpu", "--out", str(tmp_path / "x")])
    assert message in str(e.value.code)


@pytest.mark.parametrize("scene", ["droplet_2d", "dam_break_2d"])
def test_cli_runs_the_2d_scenes(scene, tmp_path, capsys):
    """``simulate_2d`` on ``SimConfig2D()``'s defaults (64x64 cells); the
    dam break with every output: the 2D checkpoint restores to the run's
    state, and the metrics keys are JAX ``step_2d``'s."""
    import jax

    from python_fluid_simulation_tpu.engine import step2d as j_step2d
    from python_fluid_simulation_tpu_torch.utils.checkpoint import restore_checkpoint

    out = str(tmp_path / scene)
    steps = 3 if scene == "dam_break_2d" else 2
    extra = ALL_OUTPUTS if scene == "dam_break_2d" else ["--metrics"]
    assert cli.main(["--device", "cpu", "--scene", scene, "--max-steps", str(steps), "--block", "2", "--out", out,
                     *extra]) == 0
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == list(range(steps))
    assert all(0 < r["density_iters"] < 600 for r in recs) and all(r["pressure_iters"] < 600 for r in recs)
    cfg, j_state = j_step2d.droplet_scene_2d() if scene == "droplet_2d" else j_step2d.dam_break_scene_2d()
    _, metrics = jax.eval_shape(lambda s: j_step2d.step_2d(s, cfg), j_state)
    assert set(recs[0]) == set(metrics) | {"step", "wall_time_s"}
    if scene == "dam_break_2d":
        assert {"ps.pickle", "replay.html", "ckpt"} <= set(os.listdir(out)) and "surface.obj" not in os.listdir(out)
        assert "surface.obj skipped" in capsys.readouterr().out
        state, cfg2, step = restore_checkpoint(os.path.join(out, "ckpt"), device="cpu")
        assert step == 3 and cfg2.grid.res == (64, 64) and cfg2.particle_dx == 1.0 / 128
        assert state.particles.x.shape[1] == 2 and state.particles.c.shape[1:] == (2, 2) and int(state.step_idx) == 3
        with open(os.path.join(out, "ps.pickle"), "rb") as f:
            series = pickle.load(f)
        last = series[max(series)]
        assert np.array_equal(last, state.particles.x.numpy())


def test_cli_mesh_bucketed_runs_the_bucketed_step(tmp_path, capsys):
    out = str(tmp_path / "bucketed")
    assert cli.main([*BASE, "--max-steps", "3", "--block", "3", "--out", out, "--mesh", "2", "--bucketed",
                     "--metrics", "--checkpoint-every", "3"]) == 0
    assert "bucket-sharded over 2 slots" in capsys.readouterr().out
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["bucket_lost"] for r in recs] == [0, 0, 0]
    assert all(r[f"{k}_converged"] for r in recs for k in ("density", "viscosity", "pressure"))
    x, m = _final(out, 3)[0], _final(out, 3)[3]
    assert int((m > 0).sum()) == 125 and np.isfinite(x).all()


def test_cli_cuda_without_a_device_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(["--scene", "dam_break", "--dx", "0.125", "--out", str(tmp_path / "x")])
    assert "no CUDA device" in str(e.value.code)
    assert not os.path.exists(tmp_path / "x")


def test_cli_mesh_runs_the_sharded_step(tmp_path, capsys):
    out = str(tmp_path / "mesh")
    assert cli.main([*BASE, "--max-steps", "2", "--block", "2", "--out", out, "--mesh", "2",
                     "--checkpoint-every", "2"]) == 0
    assert "spatially sharded over 2 slots" in capsys.readouterr().out
    x = _final(out, 2)[0]
    assert x.shape[0] % 2 == 0 and np.isfinite(x).all()


def test_cli_learned_mode_takes_seeded_weights(tmp_path, capsys):
    """'unet' without --ckpt: the WARNING line, and seeded weights drawn
    the same way each time (dam break has mu = 0, so no forward runs)."""
    assert cli.main([*BASE, "--max-steps", "1", "--out", str(tmp_path / "u"), "--viscosity-mode", "unet",
                     "--unet-bf16"]) == 0
    assert "WARNING: no --ckpt given; using random UNet weights" in capsys.readouterr().out
    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    a, b = (cli.seeded_unet(UNet3D(width=4)).state_dict() for _ in range(2))
    assert all(torch.equal(a[n], b[n]) for n in a)
    bound = 1.0 / (11 * 27) ** 0.5
    assert float(a["enc1_1.0.weight"].abs().max()) <= bound


def test_simulate_keeps_one_capture_across_blocks():
    """The key `simulate` holds its replayer by (checked on the CPU, where
    a replayer only allocates its input buffers; the captures are
    counted on the card by chip_smoke.py's cli phase): the same config,
    geometry, model and state shapes reuse it, any change replaces it,
    and ``geom=None`` keys on the solid tensors the geometry is built
    from."""
    import dataclasses

    from python_fluid_simulation_tpu_torch.engine.step import SimulateCapture
    from python_fluid_simulation_tpu_torch.state import Particles

    args = cli.build_argparser().parse_args(BASE)
    cfg, make_scene = cli.make_config(args)
    state = make_scene(cfg, device="cpu")
    geom = build_geom_cache(state.solid)
    held = SimulateCapture()
    rep = held.replayer_for(cfg, state, geom, None)
    moved = dataclasses.replace(state, particles=dataclasses.replace(state.particles, x=state.particles.x + 0.01))
    assert held.replayer_for(dataclasses.replace(cfg), moved, geom, None) is rep  # equal config, other values
    assert held.replayers == 1
    geom2 = build_geom_cache(state.solid)
    fewer = dataclasses.replace(state, particles=Particles(*(getattr(state.particles, k)[:100] for k in "xvcm")))
    for other in ((dataclasses.replace(cfg, duration=1.0), state, geom),  # the config
                  (cfg, state, geom2),  # the geometry object
                  (cfg, fewer, geom2)):  # the particle count
        rep2 = held.replayer_for(*other, None)
        assert rep2 is not rep
        rep = rep2
    assert held.replayer_for(cfg, fewer, geom2, None) is rep
    assert held.replayers == 4
    auto = held.replayer_for(cfg, state, None, None)
    assert held.replayer_for(cfg, moved, None, None) is auto  # the same solid tensors
    solid = dataclasses.replace(state.solid, phi=state.solid.phi.clone())
    assert held.replayer_for(cfg, dataclasses.replace(state, solid=solid), None, None) is not auto
    held.clear()
    assert held.replayer is None and held.replayers == 6
