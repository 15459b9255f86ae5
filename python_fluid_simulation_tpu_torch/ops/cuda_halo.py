"""The mesh kernels' launches: the halo pull (``csrc/halo_pull.cu``, one
launch a device an exchange, for rings whose slots share a device), the
halo push (``csrc/halo_rdma.cu``, one launch a slot, for rings that span
devices), with the grid a push exchange may use, and the cross-card sum of
the distributed dots (``csrc/mesh_psum.cu``, one launch a slot).

The pull and the push replace the Pallas kernel of
``python_fluid_simulation_tpu/parallel/halo_rdma.py::halo_exchange_rdma``;
the wrapper that picks the route, orders the launches, counts them and
holds the plain version is ``parallel/halo_rdma.py``.  The sum replaces no
Pallas kernel (JAX's ``lax.psum``); its wrapper and plain version are
``parallel/halo_rdma.py::mesh_psum``.  Nothing here runs without a CUDA
tensor.
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
MAX_PSUM_SLOTS = 64  # slots of a cross-card sum (mesh_psum.cu's kMaxSlots)
MAX_PSUM_DOTS = 3  # dots a cross-card sum launch (kMaxDots)


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


def launch(x: torch.Tensor, out: torch.Tensor, table: np.ndarray, sem_ptr: int, err_ptr: int,
           counters: torch.Tensor, pos: int, n: int, plane: int, grid: int, stream: torch.cuda.Stream):
    """One slot's launch on `stream`, a stream of its device: x is its
    (n, plane) block, out its output, counters its int32 (epoch, block
    sum, finished blocks) along this axis (all three on that device),
    table the uint64 output pointers of its ring by position (a
    neighbour's on another card is a peer pointer), sem_ptr the ring's
    counters."""
    with cb.launching("halo_exchange_push", x, out, counters, stream=stream) as st:
        err = cb.LIB.get().pfs_halo_exchange(
            x.data_ptr(), table.ctypes.data, sem_ptr, err_ptr, counters.data_ptr(), pos, len(table), n, plane, grid,
            st,
        )
    cb.check(err, "halo_exchange_rdma launch")


def psum(recv: np.ndarray, arrive: np.ndarray, parts, outs, state: torch.Tensor, slot: int,
         stream: torch.cuda.Stream):
    """One slot's cross-card sum on `stream`, a stream of its device:
    recv and arrive the uint64 addresses of every slot's receive buffer
    and arrival counter, parts and outs this slot's 0-dim fp32 partials
    and totals, state its int32 (arrival, epoch, error word) (all of
    them on its device)."""
    addresses = np.array([t.data_ptr() for t in (*parts, *outs)], dtype=np.uint64)
    dots = len(parts)
    with cb.launching("mesh_psum", *parts, *outs, state, stream=stream) as st:
        err = cb.LIB.get().pfs_mesh_psum(
            recv.ctypes.data, arrive.ctypes.data, addresses.ctypes.data, addresses[dots:].ctypes.data,
            state.data_ptr() + 4, state.data_ptr() + 8, slot, len(recv), dots, st,
        )
    cb.check(err, "mesh_psum launch")


def pull(table, n: int, plane: int, vec: int, out: torch.Tensor):
    """One device's pull launch on the current stream of `out`'s device:
    table the flat addresses, four a slot (block, left neighbour's top
    plane or 0, right neighbour's bottom plane or 0, output, in `out`),
    n and plane in floats, vec 4 or 1
    (`parallel.halo_rdma.vector_floats`)."""
    addresses = (ctypes.c_uint64 * len(table))(*table)
    with cb.launching("halo_exchange_rdma", out) as stream:
        err = cb.LIB.get().pfs_halo_pull(addresses, len(table) // 4, n, plane, vec, stream)
    cb.check(err, "halo_exchange_rdma pull launch")


def enable_peer_access(device: torch.device, peer: torch.device):
    """Let kernels on `device` read and write `peer`'s memory (one
    direction; already enabled is fine).  Raises where the pair has no
    peer access: no push route runs without it."""
    if device == peer:
        return
    if not torch.cuda.can_device_access_peer(device, peer):
        raise RuntimeError(f"{device} has no peer access to {peer}: a push ring or its counters span the pair")
    with torch.cuda.device(device):
        cb.check(cb.LIB.get().pfs_enable_peer(peer.index), f"peer access {device} -> {peer}")
