"""The halo kernels' launches: the pull (``csrc/halo_pull.cu``, one launch
a device an exchange, for rings whose slots share a device) and the push
(``csrc/halo_rdma.cu``, one launch a slot, for rings that span devices),
with the grid a push exchange may use.

Both replace the Pallas kernel of ``python_fluid_simulation_tpu/parallel/
halo_rdma.py::halo_exchange_rdma``; the wrapper that picks the route,
orders the launches, counts them and holds the plain version is
``parallel/halo_rdma.py``.  Nothing here runs without a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

THREADS = 256  # the push kernel's block size (kThreads)
MAX_RING = 64  # slots along one mesh axis (kMaxRing)
MAX_PULL_SLOTS = 64  # slots of one device a pull launch (kMaxSlots)


@functools.lru_cache(maxsize=None)
def resident_blocks(device_index: int) -> int:
    """Blocks of the kernel the card holds at once (SMs x blocks an SM),
    queried once a process and device."""
    sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        cb.check(cb.LIB.get().pfs_halo_grid_cap(ctypes.byref(sms), ctypes.byref(per_sm)), "halo grid query")
    return sms.value * per_sm.value


def grid_size(elems: int, n_launches: int, device: torch.device) -> int:
    """Blocks a launch: enough for `elems` floats, at most half of what
    the card holds shared by the exchange's `n_launches` launches, which
    spin on each other and must all be resident at once."""
    cap = max(1, resident_blocks(device.index) // (2 * n_launches))
    return max(1, min(cap, -(-elems // THREADS)))


def launch(x: torch.Tensor, table: np.ndarray, sem_ptr: int, err_ptr: int, pos: int, n: int, plane: int,
           epoch: int, recv_target: int, grid: int, stream: torch.cuda.Stream):
    """One slot's launch on `stream`: x is its (n, plane) block, table the
    uint64 output pointers of its ring by position, sem_ptr the ring's
    counters; epoch and recv_target as `parallel.mesh.Mesh.next_exchange`
    gives them."""
    err = cb.LIB.get().pfs_halo_exchange(
        x.data_ptr(), table.ctypes.data, sem_ptr, err_ptr, pos, len(table), n, plane, epoch, recv_target, grid,
        stream.cuda_stream,
    )
    cb.check(err, "halo_exchange_rdma launch")


def pull(table, n: int, plane: int, vec: int, device: torch.device, stream: torch.cuda.Stream):
    """One device's pull launch on `stream` of `device`: table the flat
    addresses, four a slot (block, left neighbour's top plane or 0, right
    neighbour's bottom plane or 0, output), n and plane in floats, vec 4
    or 1 (`parallel.halo_rdma.vector_floats`)."""
    addresses = (ctypes.c_uint64 * len(table))(*table)
    err = cb.LIB.get().pfs_halo_pull(addresses, len(table) // 4, n, plane, vec, device.index, stream.cuda_stream)
    cb.check(err, "halo_exchange_rdma pull launch")
