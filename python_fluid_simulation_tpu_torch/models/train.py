"""Training pairs for the learned viscosity operator: the capture half of
``python_fluid_simulation_tpu/models/train.py``.

The reference trains its UNet offline on pairs captured from the
classical solver: in 'apic' mode the notebook stores the velocities
before and after the viscosity CG solve (cell 13 :4611-4630).  Here a
pair is the 11-channel feature box of ``features.py`` with the Δv·(1/DT)
target embedded at the face parities, channels-first.  The trainer (the
masked MSE, the optimiser loop) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from python_fluid_simulation_tpu_torch.models.features import _FACE_PARITY, _embed, build_unet_input, padded_box


class ViscosityExample(NamedTuple):
    """One training pair: features, parity-embedded Δv target and mask."""

    x: torch.Tensor  # (1, 11, D, H, W)
    y: torch.Tensor  # (1, 3, D, H, W) Δv·(1/dt) at the face parities
    mask: torch.Tensor  # (1, 3, D, H, W) 1 at the face parities


def capture_viscosity_pair(gv_before, gv_after, sphi, lvol, cfg) -> ViscosityExample:
    """(features, target) from the velocities around the viscosity solve."""
    data_size, pad = padded_box(tuple(sphi.shape))
    x = build_unet_input(gv_before, sphi, lvol, cfg.grid.dx**3)
    inv_dt = float(int(round(1.0 / cfg.physics.dt)))
    chans, masks = [], []
    for a in range(3):
        dv = (gv_after[a] - gv_before[a]) * inv_dt
        chans.append(_embed(dv, data_size, pad, _FACE_PARITY[a]))
        masks.append(_embed(torch.ones_like(dv), data_size, pad, _FACE_PARITY[a]))
    return ViscosityExample(x=x, y=torch.stack(chans)[None], mask=torch.stack(masks)[None])
