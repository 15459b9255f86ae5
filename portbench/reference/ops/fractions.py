"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/fractions.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Cut-cell solid fractions: edge/tri/face in-fractions + face weights.

Counterpart of ``python_fluid_simulation_tpu.ops.fractions`` (the
reference's ``solver/SolidFractionCommon.py``, ``SolidFraction3D.py`` and
``SolidFraction2D.py``).
Elementwise over SDF samples.  The tri/face formulas reproduce the
reference exactly, including its branch selection
(SolidFractionCommon.py:18-60).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.ops.indexing import P3_NODE, parity_view


def edge_in_fraction(lval, rval):
    """Fraction of the edge on the inside (<0) of the SDF pair.

    Reference: SolidFractionCommon.py:4-16.
    """
    l_in = lval < 0
    r_in = rval < 0
    diff = -torch.abs(lval - rval)
    safe = torch.where(diff == 0, -1.0, diff)
    mixed = torch.where(l_in, lval / safe, rval / safe)
    return torch.where(
        l_in & r_in, 1.0, torch.where(~l_in & ~r_in, 0.0, mixed)
    )


def tri_in_fraction(v0, v1, v2):
    """Reference: SolidFractionCommon.py:18-50."""
    v = [v0, v1, v2]
    in0, in1, in2 = (x < 0 for x in v)
    in_count = in0.to(torch.int32) + in1.to(torch.int32) + in2.to(torch.int32)

    # in_count == 2: one outside vertex; 1 - edge fraction of the other two
    def pick(out_v):
        return 1.0 - edge_in_fraction(v[(out_v + 1) % 3], v[(out_v + 2) % 3])

    two_val = torch.where(~in0, pick(0), torch.where(in0 & ~in1, pick(1), pick(2)))

    # in_count == 1: one inside vertex; edge fraction of the other two
    def pick1(in_v):
        return edge_in_fraction(v[(in_v + 1) % 3], v[(in_v + 2) % 3])

    one_val = torch.where(in0, pick1(0), torch.where(~in0 & in1, pick1(1), pick1(2)))
    return torch.where(
        in_count == 3,
        torch.ones_like(v0),
        torch.where(
            in_count == 2,
            two_val,
            torch.where(in_count == 1, one_val, torch.zeros_like(v0)),
        ),
    )


def face_in_fraction(bl, br, tl, tr):
    """4-triangle fan about the centroid. SolidFractionCommon.py:52-60."""
    ce = 0.25 * (bl + br + tl + tr)
    return 0.25 * (
        tri_in_fraction(bl, br, ce)
        + tri_in_fraction(br, tr, ce)
        + tri_in_fraction(tr, tl, ce)
        + tri_in_fraction(tl, bl, ce)
    )


def compute_solid_frac_3d(sphi):
    """Per-face non-solid area weights (wx, wy, wz) from the dual-lattice
    solid SDF (a raw (2N+1)^3 array or its parity-class dict).

    Reference: SolidFraction3D.compute_solid_frac_kernel (:6-26).  Only the
    low face of each cell is written; the trailing face plane of each
    array keeps its zero initialisation (a solid face).
    Returns wx (nx+1,ny,nz), wy (nx,ny+1,nz), wz (nx,ny,nz+1).
    """
    nodes = sphi[P3_NODE] if isinstance(sphi, dict) else parity_view(sphi, P3_NODE)
    nx, ny, nz = (s - 1 for s in nodes.shape)

    def corner(i, j, k):  # sphi[2x+2i, 2y+2j, 2z+2k] over cells
        return nodes[i : i + nx, j : j + ny, k : k + nz]

    c000, c001 = corner(0, 0, 0), corner(0, 0, 1)
    c010, c011 = corner(0, 1, 0), corner(0, 1, 1)
    c100, c101 = corner(1, 0, 0), corner(1, 0, 1)
    c110 = corner(1, 1, 0)

    wx_in = 1.0 - face_in_fraction(c010, c000, c011, c001)  # :22
    wy_in = 1.0 - face_in_fraction(c100, c000, c101, c001)  # :24
    wz_in = 1.0 - face_in_fraction(c110, c010, c100, c000)  # :26

    # F.pad's pad list runs from the last dim backwards
    wx = F.pad(wx_in, (0, 0, 0, 0, 0, 1))
    wy = F.pad(wy_in, (0, 0, 0, 1, 0, 0))
    wz = F.pad(wz_in, (0, 1, 0, 0, 0, 0))
    return wx, wy, wz


