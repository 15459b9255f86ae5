"""A step's device-memory bytes, counted op by op without a compiler.

Counterpart of ``python_fluid_simulation_tpu.utils.roofline::
hlo_bytes_per_step``.  That function asks XLA's cost analysis of the
compiled scan program, which counts a while-loop body once (so it
under-counts the CG solves that dominate the big steps) and exists only
where a compiler does.  The port runs eagerly, so it counts what runs:
`step_bytes` runs eager `step_3d` calls under a `ByteCounter` and sums,
by one stated rule, the bytes every aten op and every hand kernel must
move.  The count feeds ``roofline(measured_bytes_per_step=)``.

The rule for an aten op (`op_bytes`):

* every tensor argument is read once, every tensor result and every
  argument the op mutates written once; a tensor that appears twice in
  one op counts once;
* a tensor's bytes are its element size times its distinct addressed
  elements: a stride-0 (expanded) dimension counts once, a slice its own
  elements, not its storage's;
* ops whose results alias an input (views, ``slice``, ``expand``,
  ``as_strided``, ``alias``, ``detach``, ``_unsafe_view``, ...) and ops
  that allocate without writing (``empty``, ``empty_strided``, ...) count
  nothing, nor do the metadata ops;
* an op that overwrites its argument (``copy_``, ``fill_``, ``zero_``,
  the random fills) and an ``out=`` argument are written, not read; a
  factory that takes a tensor's shape (``zeros_like``, ``full_like``, ...)
  does not read it;
* an indexed write (``index_put_``, ``index_add_``, ``index_copy_``,
  ``index_fill_``, ``scatter_*``, ``put_``, ``index_reduce_``) writes only
  the elements its index addresses, and reads them too where it
  accumulates; a gather (``index``, ``index_select``, ``gather``,
  ``take``, ``embedding``) reads of its source at most the elements it
  returns;
* a copy between the host and a card counts its device side only.

A hand kernel's launch (``ctypes``) bypasses the dispatcher, so each
routed wrapper carries `counted_bytes`: under an active counter it
suspends the aten count inside itself and adds its kernel's own bytes,
the traffic its function must move, by the rules of the kernel bounds
(``PERF.md`` §6 "Counting"; each formula is defined once, beside its
wrapper, and the bounds read the same functions).  A CPU run (the plain
version's aten ops) and a card run (one launch) so count the same.

Counting reads the device on the host (a solve's iterations, a live
count, a mask's nonzeros): only while counting, never on a timed or
captured path.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

KERNEL_PREFIX = "kernel:"  # the per-op table's name of a hand kernel's entry

# allocate without writing, or touch no element
_NO_DATA = frozenset({
    "empty", "empty_like", "empty_strided", "empty_permuted", "new_empty", "new_empty_strided", "resize_",
    "set_", "is_same_size", "record_stream", "_has_compatible_shallow_copy_type", "_unsafe_view",
})
# overwrite their first argument without reading it
_OVERWRITES = frozenset({
    "copy_", "fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_", "exponential_", "geometric_",
    "cauchy_", "log_normal_",
})
# write the elements an index addresses: (the index argument, whether the
# op reads them too)
_SCATTERS = {
    "index_put_": ("indices", None), "_index_put_impl_": ("indices", None),
    "index_add_": ("index", True), "index_copy_": ("index", False), "index_fill_": ("index", False),
    "index_reduce_": ("index", True), "scatter_": ("index", False), "scatter_add_": ("index", True),
    "scatter_reduce_": ("index", True), "put_": ("index", None),
}
_GATHERS = frozenset({"index", "index_select", "gather", "take", "embedding"})
# take only the shape of their tensor argument
_SHAPE_ONLY = frozenset({"zeros_like", "ones_like", "full_like", "rand_like", "randn_like", "randint_like"})


def addressed_elements(t: torch.Tensor) -> int:
    """Distinct elements a tensor addresses: the product of its extents
    over the dimensions with a nonzero stride, at most its span in the
    storage (overlapping windows)."""
    if t.numel() == 0:
        return 0
    n, span = 1, 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
            span += (size - 1) * abs(stride)
    return min(n, span)


def tensor_bytes(t: torch.Tensor) -> int:
    return addressed_elements(t) * t.element_size()


def _key(t: torch.Tensor):
    return (t.device, t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), tuple(t.stride()), t.dtype)


@functools.cache
def _schema(func):
    """(op name, argument names, mutated argument names, out argument
    names, whether every result aliases an input) of an aten overload."""
    s = func._schema
    name = func.overloadpacket.__name__
    args = [a.name for a in s.arguments]
    mutated = frozenset(a.name for a in s.arguments if a.alias_info is not None and a.alias_info.is_write)
    outs = frozenset(a.name for a in s.arguments if getattr(a, "is_out", False))
    views = bool(s.returns) and all(r.alias_info is not None and not r.alias_info.is_write for r in s.returns)
    return name, args, mutated, outs, views


def _named(func, args, kwargs) -> Dict[str, object]:
    names = _schema(func)[1]
    out = dict(zip(names, args))
    out.update(kwargs or {})
    return out


def _tensors(x) -> List[torch.Tensor]:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _index_count(self_t: torch.Tensor, indices) -> int:
    """Elements of ``self_t`` that an advanced index (a list of index
    tensors or None, as ``index_put_`` takes it) addresses."""
    shapes, dim, free = [], 0, 1
    for i in indices:
        if i is None:
            free *= self_t.shape[dim]
            dim += 1
        elif i.dtype in (torch.bool, torch.uint8):
            shapes.append((int(torch.count_nonzero(i)),))
            dim += i.ndim
        else:
            shapes.append(tuple(i.shape))
            dim += 1
    n = math.prod(torch.broadcast_shapes(*shapes)) if shapes else 1
    return n * free * math.prod(self_t.shape[dim:])


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves, by the module's rule."""
    name, _, mutated, outs, views = _schema(func)
    if views or name in _NO_DATA:
        return 0
    named = _named(func, args, kwargs)
    moved: Dict[tuple, tuple] = {}  # ("r" | "w", tensor key) -> (device type, bytes); the first entry counts

    def count(kind, t, nbytes=None):
        moved.setdefault((kind, _key(t)), (t.device.type, tensor_bytes(t) if nbytes is None else nbytes))

    self_t = named.get("self")
    scatter = _SCATTERS.get(name)
    for arg, value in named.items():
        for t in _tensors(value):
            if arg in outs:
                count("w", t)
            elif arg in mutated:
                if scatter is not None and t is self_t:
                    continue  # below: only the addressed elements
                count("w", t)
                if name not in _OVERWRITES:
                    count("r", t)
            elif name in _SHAPE_ONLY:
                continue
            elif name in _GATHERS and arg in ("self", "weight"):
                count("r", t, min(tensor_bytes(t), sum(r.numel() for r in _tensors(out)) * t.element_size()))
            elif name.startswith("scatter") and arg == "src":
                count("r", t, min(tensor_bytes(t), named["index"].numel() * t.element_size()))
            else:
                count("r", t)
    if scatter is not None and isinstance(self_t, torch.Tensor):
        index_arg, accumulates = scatter
        if accumulates is None:
            accumulates = bool(named.get("accumulate", False))
        idx = named[index_arg]
        if index_arg == "indices":
            n = _index_count(self_t, idx)
        elif name.startswith("index_"):  # a slice of self a index entry along dim
            dim = int(named["dim"]) % max(self_t.dim(), 1)
            n = idx.numel() * (self_t.numel() // max(self_t.shape[dim], 1) if self_t.dim() else 1)
        else:  # scatter_*, put_: one element an index entry
            n = idx.numel()
        touched = min(n, addressed_elements(self_t)) * self_t.element_size()
        count("w", self_t, touched)
        if accumulates:
            count("r", self_t, touched)
    for t in _tensors(out):
        count("w", t)  # an in-place result is its mutated argument, counted once
    kinds = {dev for dev, _ in moved.values()}
    host_copy = len(kinds) > 1 and "cpu" in kinds  # a host <-> card copy: its device side
    return sum(n for dev, n in moved.values() if not (host_copy and dev == "cpu"))


class ByteCounter(TorchDispatchMode):
    """Counts the bytes of every aten op (`op_bytes`) and of every routed
    kernel wrapper (`counted_bytes`) run inside ``with counter:``.

    ``table`` maps an op's name (``aten.add.Tensor``) or a kernel's
    (``kernel:stencil_matvec``) to ``[calls, bytes]``; ``total`` is their
    sum.  Nesting counters is not supported: the innermost counts."""

    def __init__(self):
        super().__init__()
        self.table: Dict[str, List[int]] = {}
        self.total = 0
        self.inside = 0  # > 0 inside a counted kernel wrapper: aten ops not counted

    def add(self, name: str, nbytes: int):
        entry = self.table.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += int(nbytes)
        self.total += int(nbytes)

    @property
    def kernel_bytes(self) -> int:
        return sum(b for name, (_, b) in self.table.items() if name.startswith(KERNEL_PREFIX))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside:
            self.add(str(func), op_bytes(func, args, kwargs, out))
        return out


def active_counter() -> ByteCounter | None:
    """The innermost active `ByteCounter`, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, ByteCounter):
            return mode
    return None


def counted_bytes(formula, name: str | None = None):
    """Decorator of a routed kernel wrapper.  Outside a counter the call
    is the wrapper's, untouched.  Under one (outermost wrapper only) the
    aten ops inside are not counted and ``formula(result, **arguments)``
    (the wrapper's arguments by name, defaults applied) is added as the
    kernel's bytes, on either route, under the table entry `name` (by
    default the kernel's, ``KERNEL_PREFIX`` + the wrapper's name)."""

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def routed(*args, **kwargs):
            counter = active_counter()
            if counter is None or counter.inside:
                return fn(*args, **kwargs)
            counter.inside += 1
            try:
                out = fn(*args, **kwargs)
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                nbytes = int(formula(out, **bound.arguments))
            finally:
                counter.inside -= 1
            counter.add(name or KERNEL_PREFIX + fn.__name__, nbytes)
            return out

        return routed

    return wrap


@dataclasses.dataclass
class StepBytes:
    """What `step_bytes` counted: the bytes a step (the mean over the
    counted steps), each step's bytes, the per-op table over all of them
    (name -> [calls, bytes]), the kernels' bytes, each step's metrics and
    the state after the steps."""

    bytes_per_step: float
    steps: List[int]
    table: Dict[str, List[int]]
    kernel_bytes: int
    metrics: list
    state: object

    @property
    def kernel_share(self) -> float:
        return self.kernel_bytes / max(sum(self.steps), 1)

    def top(self, n: int = 10) -> List[tuple]:
        """The n largest entries of the table: (name, calls, bytes)."""
        rows = sorted(self.table.items(), key=lambda kv: -kv[1][1])[:n]
        return [(name, calls, nbytes) for name, (calls, nbytes) in rows]


def _replay_io(counter: ByteCounter, before, after, metrics):
    """Under ``counter``: what `simulate` moves around one replay of the
    captured step (``engine/step.py``'s ``StepReplayer.load`` and
    ``.result``): every tensor of the state copied into an input buffer
    (a Python scalar filled), then each output the step did not pass
    through cloned, and the metrics cloned."""
    from python_fluid_simulation_tpu_torch.engine.step import _state_tensors

    with counter:
        ins = _state_tensors(before)
        for src in ins:
            if isinstance(src, torch.Tensor):
                torch.empty_like(src).copy_(src)
            else:
                torch.empty((), dtype=torch.int32, device=ins[0].device).fill_(src)
        passed = {id(t) for t in ins}
        for t in _state_tensors(after):
            if isinstance(t, torch.Tensor) and id(t) not in passed:
                t.clone()
        for v in metrics.values():
            v.clone()


def step_bytes(state, cfg, num_steps: int = 1, *, geom=None, unet=None, mesh=None, bucketed: bool = False
               ) -> StepBytes:
    """Count ``num_steps`` eager ``step_3d`` calls from ``state`` (with
    ``geom``, ``unet``, ``mesh`` and ``bucketed`` as `step_3d` takes them;
    geom None builds the geometry inside each step, as the captured step
    does), each with `_replay_io` around it, so a step's figure is
    what one replayed step moves (a replay is bitwise the eager step).
    With a mesh the count is every slot's bytes on every device."""
    from python_fluid_simulation_tpu_torch.engine.step import step_3d

    counter = ByteCounter()
    steps, metrics = [], []
    for _ in range(num_steps):
        start = counter.total
        with counter:
            after, m = step_3d(state, cfg, geom=geom, unet=unet, mesh=mesh, bucketed=bucketed)
        _replay_io(counter, state, after, m)
        steps.append(counter.total - start)
        metrics.append(m)
        state = after
    return StepBytes(sum(steps) / max(num_steps, 1), steps, counter.table, counter.kernel_bytes, metrics, state)
