"""Device meshes for spatial domain decomposition.

Counterpart of ``python_fluid_simulation_tpu.parallel.mesh``.  The JAX
package is single-controller: one process drives a ``jax.sharding.Mesh``
through ``shard_map``.  The port keeps that model: a `Mesh` is one
process's ordered list of device *slots* over named axes (``"x"``, or
``"x"`` and ``"z"``), and each slot owns one block of every sharded
grid field.  A slot may repeat a device, so one card holds several
slots (``make_mesh(4)`` puts four slabs on ``cuda:0``; the CPU tests put
four on ``cpu``).  A halo exchange whose rings each sit on one device
is one launch a device on the caller's stream; where a ring spans
devices each slot pushes on a stream of its own
(``parallel/halo_rdma.py``).

Grid arrays decompose along array axis 0 over mesh axis "x" and, on a 2D
mesh, along array axis 2 over "z"; trailing axes stay whole.  A sharded
field is the list of its blocks in slot order (`split_blocks`,
`gather_blocks`: the counterpart of ``grid_pspec``'s layout).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from python_fluid_simulation_tpu_torch.state import Particles, SimState

GRID_AXIS = "x"  # mesh axis of the 1D decomposition
GRID_AXIS_Z = "z"  # second mesh axis of the 2D (x, z) decomposition


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """Ordered device slots over named axes.

    ``devices`` lists the slots in row-major order of ``extents`` (slot
    (i, k) of an (x, z) mesh is ``devices[i * sz + k]``); ``shape`` maps
    each axis name to its extent, as JAX's ``Mesh.shape`` does.

    The halo kernels' per-mesh state lives here and is made at first
    use: each axis's route and pull launches (``halo_plans``), and for the
    push route one stream a CUDA slot, the events that order those streams
    against the caller's, and the semaphore buffer (3 counters a slot and
    an error word) with the epoch and the block sum the kernels count to
    (both grow with every push exchange, so no counter is ever reset).
    Two meshes share none of it.
    """

    def __init__(self, devices: Sequence, axis_names: Sequence[str], extents: Sequence[int]):
        self.devices: Tuple[torch.device, ...] = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(e) for e in extents)))
        if len(self.axis_names) not in (1, 2) or len(extents) != len(self.axis_names):
            raise ValueError(f"a mesh has 1 or 2 named axes, got {axis_names} {extents}")
        if math.prod(self.shape.values()) != len(self.devices) or not self.devices:
            raise ValueError(f"{len(self.devices)} slots do not fill a {tuple(extents)} mesh")
        self.size = len(self.devices)
        self.halo_plans = {}  # axis name -> (route, pull launches): parallel/halo_rdma.py
        self._streams = None
        self._events = None
        self._sem = None
        self._epoch = 0
        self._blocks = 0

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices]})"

    def rings(self, axis_name: str) -> List[List[int]]:
        """The slots along one mesh axis: a list of rings (lists of slot
        indices in axis order), one for each position on the other axis."""
        if axis_name not in self.shape:
            raise ValueError(f"{axis_name!r} is not an axis of {self}")
        if len(self.axis_names) == 1:
            return [list(range(self.size))]
        sx, sz = self.shape[self.axis_names[0]], self.shape[self.axis_names[1]]
        if axis_name == self.axis_names[0]:
            return [[i * sz + k for i in range(sx)] for k in range(sz)]
        return [[i * sz + k for k in range(sz)] for i in range(sx)]

    # -- the push route's per-mesh state (CUDA slots only)

    def slot_streams(self) -> List[torch.cuda.Stream]:
        """One stream a slot, never shared by two slots of this mesh."""
        if self._streams is None:
            streams = [torch.cuda.Stream(device=d) for d in self.devices]
            if len({s.cuda_stream for s in streams}) != len(streams):
                raise RuntimeError(f"{self}: two slots were handed the same stream")
            self._streams = streams
        return self._streams

    def halo_events(self):
        """({device: event}, [event a slot]): the caller's streams are
        recorded into the first before the slots start, each slot's
        stream into the second when it is done."""
        if self._events is None:
            self._events = ({d: torch.cuda.Event() for d in set(self.devices)},
                            [torch.cuda.Event() for _ in self.devices])
        return self._events

    def halo_semaphores(self) -> torch.Tensor:
        """int32 (3 * size + 1,) on slot 0's device, zero at first use:
        per slot (by ring, then position in the ring) the arrival count
        and the receive counts from the left and from the right; then the
        error word a timed-out wait writes."""
        if self._sem is None:
            self._sem = torch.zeros(3 * self.size + 1, dtype=torch.int32, device=self.devices[0])
        return self._sem

    def next_exchange(self, grid: int):
        """(epoch, recv_target) of a new exchange whose launches have
        `grid` blocks each: the exchanges so far, this one included, and
        the blocks a slot has launched over them (mod 2^32): what each
        slot's arrival and receive counters reach from one neighbour."""
        self._epoch = (self._epoch + 1) & 0xFFFFFFFF
        self._blocks = (self._blocks + grid) & 0xFFFFFFFF
        return self._epoch, self._blocks


def make_mesh(n_devices: Optional[int] = None, device=None, axis: str = GRID_AXIS) -> Mesh:
    """1D mesh of ``n_devices`` slots (x-slab decomposition), every slot
    on ``device`` (by default ``cuda``, the current card).  Without
    ``n_devices``: as many slots as CUDA devices.  A mesh over several
    devices is built with `Mesh` itself."""
    n = n_devices or torch.cuda.device_count()
    return Mesh([device or "cuda"] * n, (axis,), (n,))


def make_mesh2d(shape: Tuple[int, int], device=None) -> Mesh:
    """2D (x, z) mesh, every slot on ``device`` (default ``cuda``): grid
    arrays split along both spatial axes 0 and 2; an (nx, ny, nz) field
    owns (nx/sx, ny, nz/sz) blocks."""
    return Mesh([device or "cuda"] * (shape[0] * shape[1]), (GRID_AXIS, GRID_AXIS_Z), tuple(shape))


def spatial_axes(mesh: Mesh) -> Sequence[Tuple[str, int]]:
    """(mesh_axis_name, grid_array_axis) pairs of the decomposition:
    [("x", 0)] for 1D meshes, [("x", 0), ("z", 2)] for 2D."""
    names = mesh.axis_names
    if len(names) == 1:
        return [(names[0], 0)]
    return [(names[0], 0), (names[1], 2)]


def grid_pspec(mesh: Mesh, ndim: int) -> Tuple[Optional[str], ...]:
    """The mesh axis each array axis of a grid field is split over (None:
    whole), as JAX's ``PartitionSpec``."""
    spec = [None] * ndim
    for name, arr_axis in spatial_axes(mesh):
        if arr_axis < ndim:
            spec[arr_axis] = name
    return tuple(spec)


def _slot_coords(mesh: Mesh, slot: int) -> dict:
    names = mesh.axis_names
    if len(names) == 1:
        return {names[0]: slot}
    sz = mesh.shape[names[1]]
    return {names[0]: slot // sz, names[1]: slot % sz}


def split_blocks(mesh: Mesh, a: torch.Tensor, spec=None) -> List[torch.Tensor]:
    """A global field cut into its slot blocks, each contiguous and on
    its slot's device.  ``spec`` (default `grid_pspec`) names the mesh
    axis of each array axis; every split extent must divide its mesh
    extent (pad first: ``halo._pad_to_mesh``)."""
    spec = grid_pspec(mesh, a.ndim) if spec is None else spec
    for arr_axis, name in enumerate(spec):
        if name is not None and a.shape[arr_axis] % mesh.shape[name]:
            raise ValueError(f"axis {arr_axis} of {tuple(a.shape)} does not divide mesh axis {name!r}")
    out = []
    for s, dev in enumerate(mesh.devices):
        coords = _slot_coords(mesh, s)
        blk = a
        for arr_axis, name in enumerate(spec):
            if name is not None:
                n = a.shape[arr_axis] // mesh.shape[name]
                blk = blk.narrow(arr_axis, coords[name] * n, n)
        out.append(blk.to(dev).contiguous())
    return out


def gather_blocks(mesh: Mesh, blocks: Sequence[torch.Tensor], spec=None) -> torch.Tensor:
    """The global field from its slot blocks, on slot 0's device."""
    spec = grid_pspec(mesh, blocks[0].ndim) if spec is None else spec
    dev = mesh.devices[0]
    names = mesh.axis_names
    if len(names) == 1:
        rows = [[b.to(dev) for b in blocks]]
    else:
        sz = mesh.shape[names[1]]
        rows = [[b.to(dev) for b in blocks[i * sz:(i + 1) * sz]] for i in range(mesh.shape[names[0]])]
    axis_of = {name: arr_axis for arr_axis, name in enumerate(spec) if name is not None}
    if len(names) == 2:
        inner = [torch.cat(r, dim=axis_of[names[1]]) if names[1] in axis_of else r[0] for r in rows]
    else:
        inner = rows[0]
    return torch.cat(inner, dim=axis_of[names[0]]) if names[0] in axis_of else inner[0]


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    """The state for the sharded step: on slot 0's device, where
    everything outside the three solves runs, with the particles padded
    to a multiple of the slot count as the JAX package pads them:
    zero-mass particles (inert: every scatter gates on m > 0) placed on
    particle 0, with zero velocity and APIC rows."""
    dev = mesh.devices[0]
    p = state.particles
    n = p.x.shape[0]
    pad = (-n) % mesh.size
    x, v, c, m = (t.to(dev) for t in (p.x, p.v, p.c, p.m))
    if pad:
        x = torch.cat([x, x[:1].expand((pad,) + tuple(x.shape[1:]))])
        v = torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
        c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
        m = torch.cat([m, m.new_zeros((pad,))])
    sol = state.solid
    return SimState(
        particles=Particles(x=x, v=v, c=c, m=m),
        solid=type(sol)(phi=sol.phi.to(dev), v=sol.v.to(dev), rb=sol.rb.to(dev)),
        t=torch.as_tensor(state.t).to(dev),
        step_idx=torch.as_tensor(state.step_idx).to(dev),
        visc_mg=state.visc_mg,
    )
