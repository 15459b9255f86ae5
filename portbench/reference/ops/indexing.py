"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/indexing.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Grid indexing primitives: static shifts and dual-lattice parity views.

Counterpart of ``python_fluid_simulation_tpu.ops.indexing``.  The
reference addresses its (2N+1)^d dual lattice with explicit strided
indices (e.g. ``sphi[2*x+3, 2*y, 2*z+1]``, ViscosityCGSolver3D.py:133).
Every such sample is a *parity class* of the dual lattice (one of 2^d
interleaved subgrids) read at a static integer shift within that class:
``sample(parity_view(S, p), offsets)``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def const(values, dtype=torch.float32, device=None) -> torch.Tensor:
    """A small constant tensor (a scalar or a tuple), made once per
    (values, dtype, device) and then shared.  Building it anew from
    Python values on a GPU would be a blocking host-to-device copy at
    every call.  Callers must not modify it."""
    return torch.tensor(values, dtype=dtype, device=device)


def rounded_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an fp32 (or fp64) tensor.

    On a CUDA tensor this is ``torch.sqrt``: the card's fp32 root is
    correctly rounded.  PyTorch's CPU fp32 root (its vectorised build) is
    one ulp off on ~0.7% of inputs, where ``jnp.sqrt`` and ``numpy.sqrt``
    are exact, so on a CPU tensor the root is taken in float64 and rounded
    once to the input's dtype.  That double rounding is exact: float64
    carries 53 bits, at least 2 * 24 + 2, and a square root rounded to
    such a format and then to fp32 is the fp32 root rounded once.  The
    tensor's device picks the route."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def sample(a: torch.Tensor, offsets: Sequence[int], target_shape: Sequence[int], fill=0.0):
    """out[i] = a[i + offsets] over a target grid, `fill` out of range.

    Leading ``len(offsets)`` dims are spatial; trailing dims ride along.
    """
    nd = len(offsets)
    target_shape = tuple(int(t) for t in target_shape)
    out = torch.full(
        target_shape + tuple(a.shape[nd:]), fill, dtype=a.dtype, device=a.device
    )
    src, dst = [], []
    for off, t, s in zip(offsets, target_shape, a.shape[:nd]):
        off = int(off)
        lo = max(0, off)
        hi = min(int(s), t + off)
        if hi <= lo:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - off, hi - off))
    out[tuple(dst)] = a[tuple(src)]
    return out


def shift(a: torch.Tensor, offsets: Sequence[int], fill=0.0):
    """out[i] = a[i + offsets] with out-of-range reads replaced by `fill`."""
    return sample(a, offsets, a.shape[: len(offsets)], fill)


def parity_view(dual: torch.Tensor, parity: Sequence[int]) -> torch.Tensor:
    """The subgrid dual[p0::2, p1::2, ...] for parity in {0,1}^d.

    For a MAC grid of resolution N (dual lattice 2N+1):
      3D: centers=(1,1,1) -> N^3;  x-faces=(0,1,1) -> (N+1,N,N);
          y-faces=(1,0,1);  z-faces=(1,1,0);  edges/nodes = the rest.
    """
    return dual[tuple(slice(p, None, 2) for p in parity)]


def split_parity(dual, ndim: int | None = None) -> dict:
    """Split a dual-lattice array into its 2^d contiguous parity classes.

    A dict that is already split is returned as it is.
    """
    if isinstance(dual, dict):
        return dual
    d = ndim or dual.ndim
    return {
        p: parity_view(dual, p).contiguous()
        for p in itertools.product((0, 1), repeat=d)
    }


def dual_sample(
    dual,
    base_parity: Sequence[int],
    offset: Sequence[int],
    target_shape: Sequence[int],
    fill=0.0,
):
    """Sample the dual lattice at ``dual[2*i + base_parity + offset]`` for
    every site ``i`` of a primal grid (cells or faces).

    q = base_parity + offset lives in parity class (q mod 2) at integer
    shift (q - q mod 2)/2 within that class.
    """
    q = [p + o for p, o in zip(base_parity, offset)]
    cls = tuple(c % 2 for c in q)
    k = tuple((c - c % 2) // 2 for c in q)
    src = dual[cls] if isinstance(dual, dict) else parity_view(dual, cls)
    return sample(src, k, target_shape, fill)


P3_NODE = (0, 0, 0)


def face_parity(axis: int, ndim: int) -> Tuple[int, ...]:
    p = [1] * ndim
    p[axis] = 0
    return tuple(p)


def interior_mask(shape: Sequence[int], active_hi: Sequence[int] | None = None, device=None):
    """Boolean mask of "interior" sites following the reference kernels:
    ``1 <= i < hi`` per axis, hi = n - 1 unless `active_hi` overrides it
    (PressureCGSolver3D.py:9, :135)."""
    out = None
    for axis, n in enumerate(shape):
        i = torch.arange(int(n), device=device)
        hi = active_hi[axis] if active_hi is not None else int(n) - 1
        bshape = [1] * len(shape)
        bshape[axis] = int(n)
        m = ((i >= 1) & (i < hi)).reshape(bshape)
        out = m if out is None else out & m
    return out


def grid_positions(res, bound_min, cell_size, bias, device=None, dtype=torch.float32):
    """Positions of grid sites: bound_min + (index + bias) * cell_size,
    shape res + (d,).  Reference: ``get_grid_pos`` (cell 10 :783-788)."""
    axes = [
        (torch.arange(int(res[a]), dtype=dtype, device=device) + bias[a])
        * cell_size[a]
        + bound_min[a]
        for a in range(len(res))
    ]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
