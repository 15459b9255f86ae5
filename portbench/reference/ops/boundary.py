"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/boundary.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Near-solid boundary-condition velocity correction.

Counterpart of ``python_fluid_simulation_tpu.ops.boundary`` (the
reference's notebook cell 5, :279-441): within one cell of a solid
(``ndist = sphi/dx < 1``), assemble the full velocity at each face by
mass-weighted averaging of the transverse components, subtract the solid
velocity, and remove the inward normal component of the relative velocity
scaled by ``(1 - ndist)``:  dv_a = -min(0, v_rel . n) n_a / |n|^2 (1-ndist).

Where a transverse mass group sums to zero the reference divides by zero
and its NaN resolves to dv = 0; here that is an explicit mask.
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.ops.indexing import (
    dual_sample,
    face_parity,
    interior_mask,
    sample,
    split_parity,
)


def boundary_dv_axis(axis, gv, gm, sphi, sv, dx: float, mass_floor: float = 0.0) -> torch.Tensor:
    """dv for one face grid. Reference: boundary_condition_{x,y,z}."""
    d = len(gv)
    shape = tuple(gv[axis].shape)
    parity = face_parity(axis, d)

    def sph(off):
        return dual_sample(sphi, parity, off, shape, fill=1e9)

    def svc(comp):
        src = sv[comp] if isinstance(sv, (list, tuple)) else sv[..., comp]
        return dual_sample(src, parity, (0,) * d, shape, fill=0.0)

    ndist = sph((0,) * d) / dx
    v_rel = [None] * d
    mass_ok = torch.ones(shape, dtype=torch.bool, device=gv[axis].device)
    v_rel[axis] = gv[axis] - svc(axis)
    for t in range(d):
        if t == axis:
            continue
        vm_sum = torch.zeros(shape, dtype=gv[axis].dtype, device=gv[axis].device)
        m_sum = torch.zeros_like(vm_sum)
        for ja in (0, 1):
            for jt in (0, 1):
                off = [0] * d
                off[axis] = -ja
                off[t] = jt
                vt = sample(gv[t], tuple(off), shape, 0.0)
                mt = sample(gm[t], tuple(off), shape, 0.0)
                vm_sum = vm_sum + vt * mt
                m_sum = m_sum + mt
        mass_ok = mass_ok & (m_sum > 0)
        # a transverse group below the mass floor is numerically empty
        v_rel[t] = vm_sum / torch.clamp(m_sum, min=max(mass_floor, 1e-30)) - svc(t)

    # solid normal: central difference of sphi in each direction (cell 5)
    sn = []
    for k in range(d):
        op = [0] * d
        om = [0] * d
        op[k] = 1
        om[k] = -1
        sn.append(sph(tuple(op)) - sph(tuple(om)))
    sn_sq = sn[0] * sn[0]
    for k in range(1, d):
        sn_sq = sn_sq + sn[k] * sn[k]
    sn_inv = 1.0 / torch.clamp(sn_sq, min=1e-30)
    dot = sn[0] * v_rel[0]
    for k in range(1, d):
        dot = dot + sn[k] * v_rel[k]
    gv_sn = torch.clamp(dot, max=0.0) * sn[axis] * sn_inv
    dv = -gv_sn * (1.0 - ndist)
    active = interior_mask(shape, device=gv[axis].device) & (ndist < 1.0) & mass_ok
    return torch.where(active, dv, 0.0)


def apply_boundary_condition(gv, gm, sphi, sv, dx: float, mass_floor: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Corrected face velocities (g.v += g.dv, cell 5 :436-441)."""
    d = len(gv)
    sphi_c = split_parity(sphi, d)
    sv_c = list(sv) if isinstance(sv, (list, tuple)) else [split_parity(sv[..., c], d) for c in range(d)]
    return tuple(gv[a] + boundary_dv_axis(a, gv, gm, sphi_c, sv_c, dx, mass_floor) for a in range(d))
