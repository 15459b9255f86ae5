"""Feature box and output extraction for the learned viscosity operator.

Counterpart of ``python_fluid_simulation_tpu/models/features.py`` (the
reference's notebook cell 12, :824-911).  The staggered velocities are
embedded at their parity sites of the dual lattice inside a box padded
to a multiple of 16 per axis (so 4 pool levels divide it), 9 masked
central-difference velocity-gradient channels are formed, sphi becomes a
binary solid mask (the padding counts as solid), lvol is divided by the
cell volume, and the network's 3 output channels are read back at the
face parities as Δv, scaled by the configured dt (``output / int(1/DT)``,
:907).  Layout is channels-first: the box is (1, 11, D, H, W).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from python_fluid_simulation_tpu_torch.ops.indexing import merge_parity

_FACE_PARITY = ((0, 1, 1), (1, 0, 1), (1, 1, 0))


def _pad16(n: int) -> int:
    return ((n + 15) // 16) * 16


def padded_box(dual_res: Sequence[int]) -> Tuple[Tuple[int, int, int], Tuple[int, int, int]]:
    """(data_size, pad_lo) of cell 12's box (:834-838)."""
    data = tuple(_pad16(int(s)) for s in dual_res)
    pad = tuple((d - int(s)) // 2 for d, s in zip(data, dual_res))
    return data, pad


def _parity_slices(pad, parity, n):
    """Index of a face array's sites in the (X, 2, Y, 2, Z, 2) parity view
    of the box."""
    idx = []
    for p, q, k in zip(pad, parity, n):
        s, t = (p + q) // 2, (p + q) % 2
        idx += [slice(s, s + int(k)), t]
    return tuple(idx)


def _embed(field: torch.Tensor, data_size, pad, parity) -> torch.Tensor:
    """Place a face-parity field at its dual-lattice sites inside the box,
    through the (X, 2, Y, 2, Z, 2) parity view (a contiguous slice-assign)."""
    r = field.new_zeros(tuple(s for d in data_size for s in (d // 2, 2)))
    r[_parity_slices(pad, parity, field.shape)] = field
    return r.reshape(data_size)


def _masked_central_diff(g: torch.Tensor, axis: int) -> torch.Tensor:
    """d[i] = g[i-1] - g[i+1], zeroed where either neighbour is exactly 0
    and on the two boundary slices (grad_v, cell 12 :844-883).  On the
    sparse parity embedding the nonzero results land on the derivative's
    parities."""
    lo = torch.roll(g, 1, axis)
    hi = torch.roll(g, -1, axis)
    d = torch.where((lo == 0) | (hi == 0), 0.0, lo - hi)
    n = g.shape[axis]
    idx = torch.arange(n, device=g.device)
    shape = [1] * g.ndim
    shape[axis] = n
    return torch.where(((idx > 0) & (idx < n - 1)).reshape(shape), d, 0.0)


def build_unet_input(gv: Sequence[torch.Tensor], sphi: torch.Tensor, lvol, cell_vol_norm: float) -> torch.Tensor:
    """(1, 11, D, H, W) network input.  Channel order of cell 12 :899:
    [dxdx, dydy, dzdz, dxdy, dxdz, dydx, dydz, dzdx, dzdy, solid_mask,
    lvol / cell_vol_norm].

    ``sphi`` is the (2N+1)^3 dual-lattice solid level set; ``lvol`` the
    dual-lattice fluid volume or its parity-class dict (the step's form,
    merged here: the box needs the interleaved lattice)."""
    dual = tuple(sphi.shape)
    if isinstance(lvol, dict):
        lvol = merge_parity(lvol, dual)
    data_size, pad = padded_box(dual)
    emb = [_embed(gv[a], data_size, pad, _FACE_PARITY[a]) for a in range(3)]
    chans = [_masked_central_diff(emb[a], a) for a in range(3)]  # dxdx, dydy, dzdz
    # off-diagonals in the reference's order: dxdy, dxdz, dydx, dydz, dzdx, dzdy
    for a, ax in ((0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1)):
        chans.append(_masked_central_diff(emb[a], ax))
    # solid mask: 1 where sphi <= 0; the padding counts as solid (cell 12
    # initialises sphi_sympad to -1, :838)
    window = tuple(slice(p, p + s) for p, s in zip(pad, dual))
    mask = torch.ones(data_size, dtype=torch.float32, device=sphi.device)
    mask[window] = (sphi <= 0).to(torch.float32)
    lv = torch.zeros(data_size, dtype=torch.float32, device=sphi.device)
    lv[window] = lvol / cell_vol_norm
    return torch.stack(chans + [mask, lv])[None]


def extract_delta_v(output: torch.Tensor, dual_res: Sequence[int], face_shapes) -> Tuple[torch.Tensor, ...]:
    """The 3 output channels of a (1, 3, D, H, W) box read back at the face
    parities (:909-911), through the box's parity view."""
    _, pad = padded_box(dual_res)
    box = output[0]
    c, bx, by, bz = box.shape
    r = box.reshape(c, bx // 2, 2, by // 2, 2, bz // 2, 2)
    return tuple(r[(a,) + _parity_slices(pad, _FACE_PARITY[a], face_shapes[a])] for a in range(3))


def unet_delta_v(unet, gv, sphi, lvol, cfg) -> Tuple[torch.Tensor, ...]:
    """The learned viscosity step: features -> ``unet`` -> Δv, divided by
    ``int(round(1 / cfg.physics.dt))`` — the configured dt, not the step's
    CFL dt, as the JAX package does (features.py:171).  Inference: no
    autograd graph is kept."""
    x = build_unet_input(gv, sphi, lvol, cfg.grid.dx**3)
    with torch.no_grad():
        out = unet(x) / int(round(1.0 / cfg.physics.dt))
    return extract_delta_v(out, tuple(sphi.shape), [tuple(v.shape) for v in gv])
