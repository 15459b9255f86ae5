"""CLI simulation runner of the port (JAX ``python_fluid_simulation_tpu.run``).

The reference has no CLI (a notebook is its only entry point, SURVEY §0);
this is the production entry point:

  python -m python_fluid_simulation_tpu_torch.run --scene buckling \\
      --duration 0.1 --out out/ --metrics --snapshot-pickle \\
      --checkpoint-every 90

It runs blocks of ``--block`` steps through ``engine/step.py::simulate``
(on CUDA one captured step, replayed; the capture is kept across blocks),
synchronises the device once a block, logs per-step metrics (JSONL),
snapshots the particle series in the reference's pickle layout, and
checkpoints the full state (``utils/checkpoint.py``, the JAX package's
npz layout) for ``--resume``.  A resumed run continues the step count of
its checkpoint: ``--max-steps`` counts from the start of the clip, so a
run resumed from step 15 with ``--max-steps 30`` takes 15 more steps.

``--device`` is ``cuda`` (the default; an error where there is no CUDA
device) or ``cpu``, where every kernel runs its plain PyTorch version.
The 2D scenes (``dam_break_2d``, ``droplet_2d``) run ``engine/step2d.py::
simulate_2d`` on ``SimConfig2D()``'s defaults, as the JAX CLI does; they
take no ``--mesh`` and have no surface for ``--export-obj``.  ``--mesh N
[--bucketed]`` runs the sharded step on N slots (through ``simulate``, so
on CUDA one capture a run): slot i on ``cuda:i`` where the process sees
at least N cards, as the JAX CLI shards over N devices, else all N on the
one device (`mesh_layout`); with ``--bucketed`` the
particles bucketed by x-slab (``parallel/particles.py``); a resumed
bucketed run keeps its checkpoint's layout where that is already
bucketed over N slots (the JAX CLI re-buckets), so it continues the
uninterrupted run bit for bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

_SCENES_2D = ("dam_break_2d", "droplet_2d")


def build_argparser():
    p = argparse.ArgumentParser(description="fluid engine runner (PyTorch / CUDA)")
    p.add_argument("--scene", default="buckling", choices=["buckling", "dam_break", *_SCENES_2D, "coiling"])
    p.add_argument("--dx", type=float, default=None)
    p.add_argument("--mu", type=float, default=None)
    p.add_argument("--duration", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--block", type=int, default=15, help="steps per simulate call (= snapshot interval)")
    p.add_argument("--viscosity-mode", default=None, choices=["apic", "unet", "unet_warm"])
    p.add_argument("--ckpt", default=None, help="the reference's torch UNet weights ({'net': state_dict})")
    p.add_argument("--unet-bf16", action="store_true", help="run UNet inference in bfloat16 (params fp32)")
    p.add_argument("--out", default="out")
    p.add_argument("--metrics", action="store_true")
    p.add_argument("--snapshot-pickle", action="store_true")
    p.add_argument("--export-obj", action="store_true", help="export the final fluid surface as OBJ")
    p.add_argument("--export-html", action="store_true",
                   help="write a standalone HTML replay of the particle series (the reference's k3d playback, "
                        "cell 14)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None, help="a checkpoint directory; its latest step is restored")
    p.add_argument("--profile-dir", default=None, help="write a torch.profiler Chrome trace of the run here")
    p.add_argument("--bucketed", action="store_true",
                   help="with --mesh: spatially-bucketed particle sharding (per-slot residency + bounded exchange) "
                        "instead of index sharding")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the 3D step over an N-slot mesh (grid slab-decomposed along x, distributed "
                        "solves): one slot a card where there are N cards, else N slots of the device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the state lives and the steps run")
    return p


def make_config(args):
    """The scene's `SimConfig` and scene function from the flags."""
    from python_fluid_simulation_tpu_torch.engine import scenes

    if args.scene == "coiling":
        cfg = scenes.coiling_config(res=int(round(1.2 / args.dx)) if args.dx else 256,
                                    mu=(args.mu if args.mu is not None else 5.0))
        make_scene = scenes.coiling_scene
    elif args.scene == "buckling":
        cfg = scenes.buckling_config(dx=args.dx or 0.0125, mu=(args.mu if args.mu is not None else 1.0))
        make_scene = scenes.buckling_scene
    else:  # dam_break
        from python_fluid_simulation_tpu_torch.config import GridConfig3D, PhysicsConfig, SimConfig

        dx = args.dx or 1.0 / 48
        cfg = SimConfig(
            grid=GridConfig3D(bound_min=(0.0, 0.0, 0.0), bound_size=(1.0, 1.0, 1.0), dx=dx),
            physics=PhysicsConfig(mu=(args.mu if args.mu is not None else 0.0)),
            particle_dx=dx / 2,
            duration=2.0,
        )
        make_scene = scenes.dam_break_scene
    # solver-mode flags apply uniformly to every 3D scene
    if args.viscosity_mode:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, viscosity_mode=args.viscosity_mode))
    return cfg, make_scene


def seeded_unet(model, seed: int = 0):
    """Fill a UNet's parameters from an explicit ``torch.Generator``:
    each weight and its bias uniform in +-1/sqrt(fan_in), PyTorch's
    default bound for convolutions."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("weight"):
                fan_in = torch.nn.init._calculate_fan_in_and_fan_out(p)[0]
            bound = 1.0 / fan_in**0.5
            p.copy_(torch.empty(p.shape, dtype=torch.float32).uniform_(-bound, bound, generator=gen))
    return model


def load_unet(args, device):
    """The UNet of the learned modes: ``--ckpt`` through
    ``convert.load_reference_checkpoint``, else seeded weights."""
    import torch

    from python_fluid_simulation_tpu_torch.models.unet3d import UNet3D

    # bf16 compute (params stay fp32): the Tanh-bounded activations tolerate it
    model = UNet3D(dtype=torch.bfloat16 if args.unet_bf16 else torch.float32)
    if args.ckpt:
        from python_fluid_simulation_tpu_torch.convert import load_reference_checkpoint

        model.load_state_dict(load_reference_checkpoint(args.ckpt))
    else:
        seeded_unet(model)
        print("WARNING: no --ckpt given; using random UNet weights")
    return model.to(device).eval()


def mesh_layout(n: int, device: str, device_count: int):
    """The slots of ``--mesh n``: (``make_mesh`` keyword arguments, the
    layout as the run prints it).  On CUDA with at least n cards, slot i
    on ``cuda:i`` (JAX's ``make_mesh(n)`` over the first n devices); else
    every slot on ``device``."""
    if device == "cuda" and device_count >= n:
        return dict(devices=[f"cuda:{i}" for i in range(n)]), f"{n} cards (cuda:0..cuda:{n - 1})"
    return dict(device=device), f"{n} slots of {device}"


def refuse_flags(args):
    """Exit with the JAX CLI's message for flags that do not go together."""
    if args.bucketed and not (args.mesh and args.mesh > 1):
        raise SystemExit("--bucketed requires --mesh N")
    if args.mesh and args.mesh > 1 and args.scene in _SCENES_2D:
        raise SystemExit("--mesh applies to 3D scenes only")


def main(argv=None):
    args = build_argparser().parse_args(argv)
    refuse_flags(args)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device here (pass --device cpu to run on the CPU)")
    device = args.device
    os.makedirs(args.out, exist_ok=True)

    from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, simulate
    from python_fluid_simulation_tpu_torch.engine.step2d import dam_break_scene_2d, droplet_scene_2d, simulate_2d
    from python_fluid_simulation_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
    from python_fluid_simulation_tpu_torch.utils.io import ParticleSeries, export_levelset_obj
    from python_fluid_simulation_tpu_torch.utils.metrics import MetricsLogger
    from python_fluid_simulation_tpu_torch.utils.timers import profiler_trace

    two_d = args.scene in _SCENES_2D
    step_count = 0
    if two_d:
        maker = droplet_scene_2d if args.scene == "droplet_2d" else dam_break_scene_2d
        cfg, state = maker(device=device)
    else:
        cfg, make_scene = make_config(args)
    if args.resume:
        state, cfg, step_count = restore_checkpoint(args.resume, device=device)
        print(f"resumed from step {step_count}")
    elif not two_d:
        state = make_scene(cfg, device=device)
    if args.duration is not None:
        cfg = dataclasses.replace(cfg, duration=args.duration)

    mesh = None
    if args.mesh and args.mesh > 1:
        from python_fluid_simulation_tpu_torch.parallel.mesh import make_mesh, shard_state

        kw, layout = mesh_layout(args.mesh, device, torch.cuda.device_count() if device == "cuda" else 0)
        mesh = make_mesh(args.mesh, **kw)
        state = shard_state(state, mesh)
        if args.bucketed:
            from python_fluid_simulation_tpu_torch.parallel.particles import (
                bucket_particles,
                make_bucket_spec,
                resident,
                spec_from_state,
            )

            g = cfg.grid
            n = state.particles.x.shape[0]
            if args.resume and resident(state.particles, args.mesh, g.res[0], g.bound_min, g.cell_size):
                # a bucketed run's checkpoint: its layout and caps kept as
                # saved, so the resumed run continues the uninterrupted one
                spec = spec_from_state(n, args.mesh, g.res[0])
            else:
                spec = make_bucket_spec(args.mesh, g.res[0], n, positions=state.particles.x, bound_min=g.bound_min,
                                        cell_size=g.cell_size)
                state = dataclasses.replace(state, particles=bucket_particles(state.particles, mesh, spec, g.bound_min,
                                                                              g.cell_size))
            print(f"bucket-sharded over {layout} (cap {spec.cap}/slot, exchange {spec.exchange_cap})")
        else:
            print(f"spatially sharded over {layout}")

    unet = None
    if not two_d and cfg.solver.viscosity_mode in ("unet", "unet_warm"):
        unet = load_unet(args, device)

    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl") if args.metrics else None)
    series = ParticleSeries()
    series.snapshot(float(state.t), state.particles.x)

    duration = cfg.duration
    max_steps = args.max_steps or int(duration / cfg.physics.dt * 2)

    # static solid geometry: built once for the whole run and passed to
    # every block, which then replays the one captured step
    geom = None if two_d or cfg.moving_solid else build_geom_cache(state.solid, mesh)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    ckpt_dir = os.path.join(args.out, "ckpt")
    first_step = step_count
    t_start = time.perf_counter()
    with profiler_trace(args.profile_dir):
        while step_count < max_steps and float(state.t) < duration:
            n = min(args.block, max_steps - step_count)
            if two_d:
                state, metrics = simulate_2d(state, cfg, n)
            else:
                state, metrics = simulate(state, cfg, n, geom=geom, unet=unet, mesh=mesh, bucketed=args.bucketed)
            sync()
            logger.log_scan(metrics, start_step=step_count)
            step_count += n
            series.snapshot(float(state.t), state.particles.x)
            if args.checkpoint_every and step_count % args.checkpoint_every == 0:
                save_checkpoint(ckpt_dir, state, cfg, step_count)
            rate = (step_count - first_step) / (time.perf_counter() - t_start)
            print(f"t={float(state.t):.4f}s steps={step_count} ({rate:.2f} steps/s)", flush=True)
    logger.close()

    if args.snapshot_pickle:
        series.save(os.path.join(args.out, "ps.pickle"))
    if args.export_html:
        from python_fluid_simulation_tpu_torch.utils.viewer import export_html_replay

        # the solid geometry as a wireframe, like the reference's
        # k3d.marching_cubes view (cell 10 :785-795); the replay is still
        # written without it
        solid_mesh = None
        try:
            from python_fluid_simulation_tpu_torch.utils.io import triangulate_levelset

            g = cfg.grid
            verts, tris = triangulate_levelset(state.solid.phi, origin=g.bound_min, spacing=g.dual_cell_size)
            solid_mesh = (verts[:, [0, 2, 1]], tris)  # the series' k3d order
        except Exception as e:  # noqa: BLE001 - the viewer works without the solid
            print(f"solid mesh skipped: {e!r}")
        export_html_replay(series.series, os.path.join(args.out, "replay.html"), solid_mesh=solid_mesh)
    if args.export_obj and two_d:
        print("surface.obj skipped: a 2D scene has no surface to triangulate")
    elif args.export_obj:
        from python_fluid_simulation_tpu_torch.ops.levelset import compute_fluid_levelset

        g = cfg.grid
        lphi = compute_fluid_levelset(state.particles.x, g.res, g.bound_min, g.cell_size, g.dx)
        export_levelset_obj(
            lphi, os.path.join(args.out, "surface.obj"),
            origin=tuple(m + 0.5 * c for m, c in zip(g.bound_min, g.cell_size)), spacing=g.cell_size,
        )
    if args.checkpoint_every:
        save_checkpoint(ckpt_dir, state, cfg, step_count)
    print(f"done: {step_count} steps, t={float(state.t):.4f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
