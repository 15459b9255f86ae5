"""The system under test: ``python_fluid_simulation_tpu_torch``, driven
through its own entry points.

The window calls ``engine/step.py::simulate`` block after block, as the
CLI (``run.py``) does: on CUDA the step captured once into a CUDA graph
and replayed.  The only thing added is a CUDA event recorded on the
stream before each replay (`TimedReplayer`, the kind of replayer
``SimulateCapture`` takes), so a step's time is read without a sync.
This is the one module of the harness that imports the port.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench.inputs import BodyTable
from python_fluid_simulation_tpu_torch.config import SimConfig
from python_fluid_simulation_tpu_torch.engine import step as step_mod
from python_fluid_simulation_tpu_torch.engine.step import SimulateCapture, StepReplayer, build_geom_cache, simulate
from python_fluid_simulation_tpu_torch.state import SimState, make_particles, make_solid_state


class TimedReplayer(StepReplayer):
    """`StepReplayer` that records a CUDA event before each replay into
    ``marks`` while that list is set (no event, and nothing else, when it
    is None)."""

    marks = None

    def replay(self, branch):
        if TimedReplayer.marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            TimedReplayer.marks.append(ev)
        return super().replay(branch)


class Program:
    """The port on one configuration: its ``SimConfig``, the seeded scene
    on ``device`` and the static geometry, built by the port's own
    functions from the benchmark's inputs."""

    def __init__(self, config: dict, viscosity_mode: str, rb: np.ndarray, positions: np.ndarray, device):
        sim = dict(config["sim"])
        sim["solver"] = dict(sim["solver"], viscosity_mode=viscosity_mode)
        self.cfg = SimConfig.from_json(json.dumps(sim))
        self.device = torch.device(device)
        solid = make_solid_state(self.cfg, BodyTable(rb), device=self.device)
        particles = make_particles(positions, self.cfg.physics.rho, self.cfg.particle_dx, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        self.scene = SimState(particles=particles, solid=solid, t=zero,
                              step_idx=torch.zeros((), dtype=torch.int32, device=self.device))
        self.geom = build_geom_cache(solid)
        if self.device.type == "cuda":
            step_mod.simulate.capture = SimulateCapture(replayer=TimedReplayer)

    def simulate(self, state, steps: int):
        """(state, metrics stacked over the steps): one ``simulate`` call."""
        return simulate(state, self.cfg, steps, geom=self.geom)

    def chained(self, state, steps: int):
        """Each step's state from ``state`` on, one ``simulate`` call a
        step (the same captured graph as a block's), and their metrics."""
        states, metrics = [state], []
        for _ in range(steps):
            s, m = self.simulate(states[-1], 1)
            states.append(s)
            metrics.append({k: v[0] for k, v in m.items()})
        return states, metrics

    def loop_nodes(self) -> int:
        """WHILE nodes in the captured graphs (the generic CG loops, of
        whose iterations the profiler sees one in a replay)."""
        rep = step_mod.simulate.capture.replayer
        if rep is None:
            return 0
        return sum(len(cap.loop_nodes) for cap in rep.captured.values())

    def release(self):
        """Free the captured graphs and their pools."""
        step_mod.simulate.capture.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def particles_of(state) -> dict:
    """The particle state a comparison reads, as plain tensors."""
    p = state.particles
    return {"x": p.x, "v": p.v, "c": p.c, "m": p.m}


def state_parts(state) -> dict:
    """What the reference takes of a state to repeat its step: the
    particles, the time and the 'auto' flag (it builds its own solids)."""
    p = state.particles
    return {"x": p.x, "v": p.v, "c": p.c, "m": p.m, "t": state.t, "step_idx": state.step_idx,
            "visc_mg": torch.as_tensor(state.visc_mg, dtype=torch.int32)}
