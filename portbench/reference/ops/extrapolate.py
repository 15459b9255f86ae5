"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/extrapolate.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Jacobi layer-peel velocity extrapolation.

Counterpart of ``python_fluid_simulation_tpu.ops.extrapolate`` (the
reference's notebook cell 7, :501-611, and ViscosityCGSolver3D.py:8-39):
invalid sites take the mean of their valid axis neighbours; validity
grows one layer per iteration; boundary sites are never updated.  Like
the JAX package, every axis is extrapolated over its full interior (the
reference launches the vz pass with the vx block shape, cell 7 :567).
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.ops.indexing import interior_mask, shift


def extrapolate(v: torch.Tensor, valid: torch.Tensor, num_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One field; `valid` is boolean.  Returns (v, valid) after num_iter."""
    interior = interior_mask(v.shape, device=v.device)
    dirs = []
    for axis in range(v.ndim):
        for s in (+1, -1):
            off = [0] * v.ndim
            off[axis] = s
            dirs.append(tuple(off))
    for _ in range(num_iter):
        vf = torch.where(valid, v, 0.0)
        vc = valid.to(v.dtype)
        nb_sum = nb_cnt = None
        for off in dirs:
            sv = shift(vf, off, 0.0)
            sc = shift(vc, off, 0.0)
            nb_sum = sv if nb_sum is None else nb_sum + sv
            nb_cnt = sc if nb_cnt is None else nb_cnt + sc
        upd = (~valid) & (nb_cnt > 0) & interior
        v = torch.where(upd, nb_sum / torch.clamp(nb_cnt, min=1.0), v)
        valid = valid | upd
    return v, valid


