"""The comparison that decides ``correct``: the port's steps against the
frozen plain reference (``reference/``), which imports nothing of the
port and is handed only the benchmark's inputs and, to follow the
program step by step, the particle state the program's step starts from.

The simulation is chaotic in float32: two sound programs whose sums run
in another order part beyond any useful tolerance within tens of steps.
So the reference repeats single steps of the window's block from the
program's own input state of that step, and the stages this skips are
checked by themselves: the solid level set the program built from the
bodies (against the reference's own), and the program's first step from
the seeded scene (against the reference's step from the same inputs).
The reference works out the solids and the geometry again; it takes no
field the program derived.

Numbers compared (each the widest over the compared steps):
``x_m``, ``v_m_per_s``, ``c_per_s`` (max |program - reference| over
every particle and component), ``solid_phi_m``, and ``block_repeat``
(the window's last block against the same steps run again, exact: limit
0).  ``dt_rel`` (|dt - dt_ref| / dt_ref) is worked out and printed but
not compared: in these cells the step is at its cap ``physics.dt`` on
both sides, so no fault or control moves it, and a wrong dt moves ``x``.
The solids are static, so their velocity is 0 on both sides and is not
compared either.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from portbench.inputs import BodyTable
from portbench.reference.config import SimConfig as RefConfig
from portbench.reference.engine.step import build_geom_cache, step_3d
from portbench.reference.state import Particles, SimState, make_solid_state


class Reference:
    """The frozen plain step on the configuration, on ``device``, with
    its own solids and geometry from the benchmark's body table."""

    def __init__(self, config: dict, viscosity_mode: str, rb: np.ndarray, device):
        sim = dict(config["sim"])
        sim["solver"] = dict(sim["solver"], viscosity_mode=viscosity_mode)
        self.cfg = RefConfig.from_json(json.dumps(sim))
        self.device = torch.device(device)
        self.solid = make_solid_state(self.cfg, BodyTable(rb), device=self.device)
        self.geom = build_geom_cache(self.solid)

    def step(self, parts: dict, low=None) -> tuple:
        """One reference step from a state's particles, time and 'auto'
        flag (``parts``: tensors of any device): (particles dict, dt,
        metrics, probe).  ``low``: the control's precision."""
        dev = self.device

        def on(t):
            return t.to(dev)

        state = SimState(
            particles=Particles(x=on(parts["x"]), v=on(parts["v"]), c=on(parts["c"]), m=on(parts["m"])),
            solid=self.solid, t=on(parts["t"]), step_idx=on(parts["step_idx"]),
            visc_mg=on(torch.as_tensor(parts["visc_mg"], dtype=torch.int32)),
        )
        probe = {}
        out, metrics = step_3d(state, self.cfg, geom=self.geom, low=low, probe=probe)
        p = out.particles
        return {"x": p.x, "v": p.v, "c": p.c}, metrics["dt"], metrics, probe


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over every entry, on a's device (inf where a NaN)."""
    d = (a.to(torch.float32) - b.to(a.device, torch.float32)).abs()
    if d.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def step_gaps(prog: dict, prog_dt, ref: dict, ref_dt) -> dict:
    """The compared numbers of one step: the program's particles and dt
    against the reference's."""
    rdt = float(ref_dt)
    return {
        "x_m": max_abs(ref["x"], prog["x"]),
        "v_m_per_s": max_abs(ref["v"], prog["v"]),
        "c_per_s": max_abs(ref["c"], prog["c"]),
        "dt_rel": abs(float(prog_dt) - rdt) / rdt if rdt > 0 else float("inf"),
    }


def widest(rows) -> dict:
    """Each number's largest value over the rows."""
    out = {}
    for row in rows:
        for k, v in row.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def sample_steps(seed: int, segment: int, count: int) -> list:
    """``count`` distinct steps of a block drawn from the seed, the last
    step always among them, ascending."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 0x5EED]))
    others = rng.choice(segment - 1, size=count - 1, replace=False).tolist() if count > 1 else []
    return sorted(int(k) for k in others) + [segment - 1]
