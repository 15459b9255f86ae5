"""State carry between the two packages, through numpy arrays.

``state_to_numpy`` / ``state_from_numpy`` map a `SimState` to and from a
flat dict of numpy arrays whose keys name the fields of the JAX
package's ``SimState`` (particles x/v/c/m, solid phi/v/rb, t, step_idx,
visc_mg), so the same state can be fed to both packages.  The learned
operator's weights are not carried yet.
"""

from __future__ import annotations

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.state import Particles, SimState, SolidState

def state_to_numpy(s: SimState) -> dict:
    def np_(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    p, sol = s.particles, s.solid
    return {
        "x": np_(p.x), "v": np_(p.v), "c": np_(p.c), "m": np_(p.m),
        "phi": np_(sol.phi), "sv": np_(sol.v), "rb": np_(sol.rb),
        "t": np_(s.t).astype(np.float32),
        "step_idx": np_(s.step_idx).astype(np.int32),
        "visc_mg": np_(s.visc_mg).astype(np.int32),
    }


def state_from_numpy(d: dict, device="cuda") -> SimState:
    def t_(k, dtype=torch.float32):
        return torch.as_tensor(np.array(d[k]), dtype=dtype, device=device)

    return SimState(
        particles=Particles(x=t_("x"), v=t_("v"), c=t_("c"), m=t_("m")),
        solid=SolidState(phi=t_("phi"), v=t_("sv"), rb=t_("rb")),
        t=t_("t"),
        step_idx=t_("step_idx", torch.int32),
        visc_mg=t_("visc_mg", torch.int32) if "visc_mg" in d else torch.zeros((), dtype=torch.int32, device=device),
    )
