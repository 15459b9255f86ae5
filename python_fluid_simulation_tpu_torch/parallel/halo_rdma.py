"""Width-1 halo exchange along array axis 0 by remote push: the CUDA
kernel's wrapper and its plain version.

Counterpart of ``python_fluid_simulation_tpu.parallel.halo_rdma``.
Semantics are those of ``halo.halo_exchange(mesh, blocks, axis, 1, 0)``:
each slot's output is (n + 2, ...), row 0 the left neighbour's top
plane, the last row the right neighbour's bottom plane, zeros at the
domain's ends.

On CUDA blocks every slot launches ``csrc/halo_rdma.cu`` once, on its
own stream: the streams wait on an event of the caller's stream, every
launch of the exchange is enqueued before any completion event (so no
launch queues behind another slot's), then the caller's stream waits on
every slot's event, so the allocator cannot reuse a buffer while a slot
still writes it.  The kernels push their edge planes through the table of
the ring's output pointers (all allocated before the first launch) and
count on the mesh's semaphore buffer (``parallel/mesh.py::Mesh``).
Exchanges on one mesh are ordered through the caller's stream: call
them from one stream, as every caller here does.  On CPU blocks the
plain version runs (slices, ``.to()``, ``torch.cat``).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from python_fluid_simulation_tpu_torch.ops import cuda_halo


def halo_exchange_rdma_plain(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """Plain PyTorch version: each slot's block framed by its ring
    neighbours' edge planes (zeros at the ends)."""
    out = [None] * len(blocks)
    for ring in mesh.rings(axis_name):
        for pos, s in enumerate(ring):
            b = blocks[s]
            lo = (blocks[ring[pos - 1]][-1:].to(b.device) if pos > 0 else torch.zeros_like(b[:1]))
            hi = (blocks[ring[pos + 1]][:1].to(b.device) if pos < len(ring) - 1 else torch.zeros_like(b[:1]))
            out[s] = torch.cat([lo, b, hi], dim=0)
    return out


def halo_exchange_rdma(mesh, blocks: Sequence[torch.Tensor], axis_name: str = "x") -> List[torch.Tensor]:
    """Exchange one plane along array axis 0 with both ring neighbours of
    every slot along mesh axis ``axis_name``.  ``blocks``: one a slot, in
    slot order, all of one shape (n, ...) with ndim >= 2.  CUDA blocks
    launch the kernel (or raise); CPU blocks run the plain version."""
    if all(b.device.type == "cpu" for b in blocks):
        return halo_exchange_rdma_plain(mesh, blocks, axis_name)
    if len(blocks) != mesh.size:
        raise ValueError(f"halo_exchange_rdma: {len(blocks)} blocks for {mesh.size} slots")
    shape = tuple(blocks[0].shape)
    for s, (b, dev) in enumerate(zip(blocks, mesh.devices)):
        if (b.device != dev or b.dtype != torch.float32 or tuple(b.shape) != shape or not b.is_contiguous()):
            raise ValueError(
                f"halo_exchange_rdma: slot {s} needs a contiguous float32 {shape} block on {dev}, "
                f"got {b.dtype} {tuple(b.shape)} on {b.device}"
            )
    if len(shape) < 2 or shape[0] < 1:
        raise ValueError(f"halo_exchange_rdma: blocks of ndim >= 2 with at least one row, got {shape}")
    rings = mesh.rings(axis_name)
    if len(rings[0]) > cuda_halo.MAX_RING:
        raise ValueError(f"halo_exchange_rdma: at most {cuda_halo.MAX_RING} slots along {axis_name!r}")
    n, plane = shape[0], math.prod(shape[1:])
    # everything the launches touch exists before the first of them: no
    # allocation (which may synchronise the device) between two launches
    # that spin on each other
    outs = [torch.empty((n + 2,) + shape[1:], dtype=torch.float32, device=b.device) for b in blocks]
    streams = mesh.slot_streams()
    ready, done = mesh.halo_events()
    sem = mesh.halo_semaphores()
    grid = cuda_halo.grid_size(n * plane, mesh.size, blocks[0].device)
    epoch, recv_target = mesh.next_exchange(grid)
    tables = [np.array([outs[s].data_ptr() for s in ring], dtype=np.uint64) for ring in rings]
    err_ptr = sem.data_ptr() + 4 * 3 * mesh.size
    for dev, ev in ready.items():
        ev.record(torch.cuda.current_stream(dev))
    for s, st in enumerate(streams):
        st.wait_event(ready[mesh.devices[s]])
    for r, (ring, table) in enumerate(zip(rings, tables)):
        sem_ptr = sem.data_ptr() + 4 * 3 * len(ring) * r
        for pos, s in enumerate(ring):
            cuda_halo.launch(blocks[s], table, sem_ptr, err_ptr, pos, n, plane, epoch, recv_target, grid, streams[s])
            halo_exchange_rdma.launches += 1
    for s, st in enumerate(streams):
        done[s].record(st)
    for s, dev in enumerate(mesh.devices):
        torch.cuda.current_stream(dev).wait_event(done[s])
    return outs


halo_exchange_rdma.launches = 0  # one a slot an exchange
