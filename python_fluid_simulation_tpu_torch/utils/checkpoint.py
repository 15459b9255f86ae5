"""Checkpoint / resume of the full simulation state.

Counterpart of ``python_fluid_simulation_tpu.utils.checkpoint``, in its
portable ``.npz`` layout (the JAX package writes it where Orbax is
absent, and reads it in any case), so each package reads the other's
checkpoints:

  ``<path>/config.json``       the `SimConfig`, as the JAX package's
                               ``_config_to_json`` writes it
  ``<path>/state_<step>.npz``  the `SimState` leaves in JAX's tree
                               order: particles x, v, c, m; solid phi,
                               v, rb; t (float32), step_idx and visc_mg
                               (int32), as ``arr_0`` .. ``arr_9``

The reference has no mid-run checkpointing (SURVEY §5).  A restore puts
the state on an explicit device, with t, step_idx and visc_mg as 0-d
tensors, so that a resumed run continues bitwise.  A 2D checkpoint (its
config's ``bound_min`` has two entries) carries an
``engine/step2d.py::SimConfig2D`` and a 2D state (``c`` (K, 2, 2), the
``ops/sdf2d.py`` table), as the JAX package writes and reads it.  Orbax directories
(what the JAX package writes where Orbax is installed) are not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np

from python_fluid_simulation_tpu_torch.config import SimConfig
from python_fluid_simulation_tpu_torch.convert import state_from_numpy, state_to_numpy
from python_fluid_simulation_tpu_torch.state import SimState


def _config_to_json(cfg) -> str:
    """The config as the JAX package's ``_config_to_json`` writes it."""

    def conv(o):
        if dataclasses.is_dataclass(o):
            return {k: conv(v) for k, v in dataclasses.asdict(o).items()}
        if hasattr(o, "_asdict"):
            return {k: conv(v) for k, v in o._asdict().items()}
        if isinstance(o, tuple):
            return list(o)
        return o

    return json.dumps(conv(cfg), indent=2)


# the SimState leaves in the JAX package's tree order, by their names in
# convert.state_to_numpy
LEAVES = ("x", "v", "c", "m", "phi", "sv", "rb", "t", "step_idx", "visc_mg")


def save_checkpoint(path: str, state: SimState, cfg, step: int):
    """Write the config and the state; `path` is a directory (a re-save
    of a step overwrites it)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        f.write(_config_to_json(cfg))
    arrays = state_to_numpy(state)
    np.savez(os.path.join(path, f"state_{step}.npz"), *(arrays[k] for k in LEAVES))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("state_"):
            stem = name[len("state_"):].split(".")[0]
            if stem.isdigit():
                steps.append(int(stem))
    return max(steps) if steps else None


def config_2d_from_json(text: str):
    """The `SimConfig2D` of a 2D checkpoint's config.json (JAX
    ``utils/checkpoint.py:87-100``)."""
    from python_fluid_simulation_tpu_torch.config import GridConfig2D, PhysicsConfig, SolverConfig
    from python_fluid_simulation_tpu_torch.engine.step2d import SimConfig2D

    d = json.loads(text)
    g = d["grid"]
    return SimConfig2D(
        grid=GridConfig2D(bound_min=tuple(g["bound_min"]), bound_size=tuple(g["bound_size"]), dx=g["dx"]),
        physics=PhysicsConfig(**d["physics"]), solver=SolverConfig(**d["solver"]),
        particle_dx=d["particle_dx"], dt_mode=d["dt_mode"], duration=d["duration"],
    )


def restore_checkpoint(path: str, step: Optional[int] = None, device="cuda") -> Tuple[SimState, SimConfig, int]:
    """(state on ``device``, config, step) of the checkpoint at ``step``
    (the latest by default); a 2D checkpoint gives a `SimConfig2D`."""
    with open(os.path.join(path, "config.json")) as f:
        text = f.read()
    if len(json.loads(text).get("grid", {}).get("bound_min", [0] * 3)) == 2:
        cfg = config_2d_from_json(text)
    else:
        cfg = SimConfig.from_json(text)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    npz = os.path.join(path, f"state_{step}.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"{npz} not found (an Orbax checkpoint directory is not read by this package)")
    with np.load(npz) as data:
        flat = [data[f"arr_{i}"] for i in range(len(data.files))]
    if len(flat) == len(LEAVES) - 1:
        flat.append(np.int32(0))  # pre-visc_mg checkpoints, as the JAX package restores them
    if len(flat) != len(LEAVES):
        raise ValueError(f"{npz}: {len(flat)} arrays, a state has {len(LEAVES)}")
    return state_from_numpy(dict(zip(LEAVES, flat)), device=device), cfg, step
