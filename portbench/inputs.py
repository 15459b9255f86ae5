"""The inputs of a run, made by the benchmark from the configuration and
``--seed``: the rigid bodies' table and the particles' positions.

Both are handed alike to the port and to the frozen reference.  The
seeding is the reference's (``reference/state.py::seed_particle_box``):
a grid of spacing ``particle_dx`` over the fluid box, filtered to outside
the solids before the jitter, then a Gaussian jitter from the seed.  The
filter does not read the seed, so every seed gives the same particle
count and the same work a step, in another arrangement.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.ops.sdf import make_body
from portbench.reference.state import seed_particle_box


def seed_of(seed: int) -> np.random.SeedSequence:
    """A numpy seed from any whole number (negative or above 2**63)."""
    return np.random.SeedSequence(int(seed) % 2**64)


class BodyTable:
    """A rigid-body table in the form both sides' ``make_solid_state``
    reads (a ``RigidBodySet``'s ``table``)."""

    def __init__(self, rb: np.ndarray):
        self.rb = rb

    def table(self, device="cuda"):
        return torch.as_tensor(self.rb, dtype=torch.float32, device=device)


def body_table(config: dict) -> np.ndarray:
    """(B, 10, 4) float32: the configuration's rigid bodies."""
    blocks = []
    for body in config["bodies"]:
        kw = {k: body[k] for k in ("flip", "center", "axis", "angle", "velocity") if k in body}
        blocks.append(make_body(body["kind"], body["params"], **kw))
    return np.stack(blocks).astype(np.float32)


def particle_positions(config: dict, seed: int) -> np.ndarray:
    """(N, 3) float32 positions of the fluid box, jittered from ``seed``."""
    box = config["fluid_box"]
    sim = config["sim"]
    rb = body_table(config)
    pos = seed_particle_box(center=box["center"], size=box["size"], dx=sim["particle_dx"], rb_table=rb,
                            jitter=box.get("jitter", 0.3), seed=seed_of(seed))
    if pos.shape[0] != config["particles"]:
        raise ValueError(f"the fluid box seeds {pos.shape[0]} particles, the configuration states "
                         f"{config['particles']}")
    return pos.astype(np.float32)
