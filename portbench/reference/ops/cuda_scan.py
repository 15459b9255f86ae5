"""[Frozen copy of ``python_fluid_simulation_tpu_torch/ops/cuda_scan.py``, plain PyTorch
only: see ``portbench/reference/FROZEN_FROM.md``.  Where the text below
speaks of kernels and launches it describes the port; here every
route runs its plain version.]

Inclusive segmented scan down sorted rows: CUDA kernel + plain version.

Replaces ``python_fluid_simulation_tpu/ops/pallas_segscan.py::
seg_scan_sorted`` (the roll-doubling ``_kernel`` and the MXU
``_kernel_mxu``).  The contract is the JAX function's:

    out[i] = combine(vals[j] for j in segment(i), j <= i)

for ``vals`` (K, C) float32 and ``same`` (K,) bool, True where row i
continues row i-1's segment; ``op`` is ``add`` or ``min``; segments may
be of any length.  In the port it is the first phase of the scan route
of ``ops/cuda_binned.py::segment_reduce`` (each segment's last row then
holds its reduce).

The kernel (``csrc/seg_scan.cu``) scans tiles of rows in shared memory
and carries a segment across tiles in a second pass, with no atomics.
Association, the same in the kernel and in `seg_scan_sorted_plain`: in
row order, ``out[i] = combine(out[i-1], vals[i])`` inside a segment,
each operation rounded on its own.  That is the serial binned reduce's
order, so the scan route's sums are bitwise the serial route's; the
JAX kernels associate their adds as a doubling tree or a tile matmul
and agree to fp32 rounding.

Routing: a CUDA tensor launches the kernel; a CPU tensor runs
`seg_scan_sorted_plain`.
"""

from __future__ import annotations

import torch


OPS = ("add", "min")
MAX_CHANNELS = 256  # a 32-row tile of C channels fills the kernel's 32 KB of shared memory


def combine(acc: torch.Tensor, v: torch.Tensor, op: str) -> torch.Tensor:
    """The kernels' combine: add, or the min that propagates NaN (the
    serial reduce's and ``torch.segment_reduce``'s)."""
    if op == "add":
        return acc + v
    return torch.where(torch.isnan(v) | (v < acc), v, acc)


def seg_scan_sorted_plain(vals: torch.Tensor, same: torch.Tensor, op: str = "add") -> torch.Tensor:
    """The scan in row order.  Rows are taken by their position in their
    segment: every row at position j combines the finished row above it,
    so one pass a position (the longest segment's length in passes)."""
    k = vals.shape[0]
    out = vals.clone()
    if k < 2:
        return out
    idx = torch.arange(k, device=vals.device)
    starts = ~same.to(torch.bool)
    starts[0] = True
    pos = idx - torch.cummax(torch.where(starts, idx, torch.zeros_like(idx)), 0).values
    order = torch.argsort(pos, stable=True)
    bounds = torch.cumsum(torch.bincount(pos), 0).tolist()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows = order[lo:hi]
        out[rows] = combine(out[rows - 1], vals[rows], op)
    return out


def seg_scan_sorted(vals: torch.Tensor, same: torch.Tensor, op: str = "add") -> torch.Tensor:
    """Inclusive segmented scan of (K, C) rows (the plain version)."""
    if op not in OPS:
        raise ValueError(f"seg_scan_sorted: op must be one of {OPS}, got {op!r}")
    return seg_scan_sorted_plain(vals, same, op)

