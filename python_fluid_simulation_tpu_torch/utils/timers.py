"""Phase clocks inside the step, the replay loop's host spans, and the
profiler hook.

Counterpart of ``python_fluid_simulation_tpu.utils.timers``, whose host
phase timer cannot see inside a CUDA graph replay (one
``cudaGraphLaunch`` a step): here the step times itself on the device.

**Phase stamps** (device).  ``engine/step.py::step_3d`` stamps, on the
state's card, the start of the step and the end of each of its phases
(`PHASES`, in this order):

  dt           the CFL step
  advect       advection and the solid projection (with a moving solid:
               the bodies advanced, the solid level set and geometry
               re-evaluated; the geometry built where none was given)
  levelset     the first cell sort and fluid level set
  density      the density solve and its displacement
  p2g          the second sort and level set, merged P2G, gravity
  viscosity    the viscosity solve (in 'unet', the network's Δv)
  pressure     the pressure solve
  extrapolate  the two-layer velocity extrapolation
  boundary     the boundary condition
  g2p          G2P
  finish       the hysteresis flag, the new state, the metrics

and the start stamp ends `BETWEEN`: the time from the call's start, or
from the previous step's end, to this step's start (the loads, the
advances and metric clones between replays, and the wait for the next
graph launch).  A stamp is `pfs_stamp` of ``csrc/cuda_graph.cu``: one
thread that reads ``%globaltimer`` and adds the nanoseconds since the
previous stamp to the phase it ends.  Under capture each stamp is a kernel node, so every replay accumulates
per-phase device nanoseconds with no host involvement; eagerly it is an
ordinary launch; on the CPU the same arithmetic (`stamp_plain`) runs on
``time.perf_counter_ns``.  A stamp measures device wall time between two
points of the stream (kernels and the gaps between them), so the phases
add up to the step.  ``density``, ``viscosity`` and ``pressure`` are the
solvers layer (`SOLVE_PHASES`), the others the particles and grids
layer (`GRID_PHASES`).

**Loop counters** (device).  ``ops/cuda_graph.py::captured_while`` puts
a stamp on the parent graph just before each WHILE node and one just
after it (never inside a body), on the stamped card and inside a
stamped step only.  The stamp after the node adds the node's time to
the loop's slot and to the phase that holds it (so the phases still add
up), one to the loop's runs, the loop's ``k`` (its iterations, which
the test kernel advances) to the loop's iterations, and ``k`` times the
body's nodes to `NODES`.  `PhaseRecorder.loops` maps a live loop's slot
to the phase open at its capture; a capture's ``CapturedStep`` holds
its top-level nodes, its stamps, its bodies' nodes and its loops' slots,
and gives the slots back when it is dropped.  Graph nodes executed
= top-level nodes of every replay (counted on the host) + Σ body nodes
× iterations (on the device), stamps excluded; a replay of a graph with
an unstamped loop leaves the call's nodes uncounted.  On a mesh over
several cards only the state's card is stamped: the other cards' loops
get no stamps and their graphs' nodes are not counted; the 2D engine is
not stamped.

**Host spans.**  While a ``torch.profiler`` is recording, and only
then, the replay loop opens ``record_function`` ranges (`SPANS`) in
the profiler's trace, beside the device's kernels on its clock:
``pfs_simulate`` a `simulate` call and ``pfs_step`` a call of
``replaying_step``'s step (the call's id as the argument), and inside
them ``pfs_replayer_for``, ``pfs_capture``, ``pfs_load``,
``pfs_branch``, ``pfs_replay``, ``pfs_advance``, ``pfs_metrics``,
``pfs_result``.

**The ring.**  At the end of every such call `PhaseRecorder.call`
snapshots the card's accumulators (one device-side clone of its small
buffer) into a `CallRecord`, kept in `PhaseRecorder.ring` (the last
`RING` calls): its steps, whether a profiler was recording, and through
`CallRecord.counters` the call's per-phase ns, per-loop ns, iterations
and runs, and nodes, as differences from the previous call's
snapshot (a second clone at the call's start only where the card's
clocks moved since, as a lone eager ``step_3d`` or a replay outside a
call moves them).  Reading a record copies it to the host.

``profiler_trace`` is the CLI's ``--profile-dir``: a Chrome trace and
``phases.json`` (`phases_summary`) of the calls it spans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch

PHASES = ("dt", "advect", "levelset", "density", "p2g", "viscosity", "pressure", "extrapolate", "boundary", "g2p",
          "finish")
SOLVE_PHASES = ("density", "viscosity", "pressure")
GRID_PHASES = tuple(p for p in PHASES if p not in SOLVE_PHASES)
BETWEEN = "between"
CLOCKS = (BETWEEN,) + PHASES
SPANS = {
    "pfs_simulate": "one simulate call (argument: the call's id in the ring)",
    "pfs_step": "one call of replaying_step's step (argument: the call's id)",
    "pfs_replayer_for": "the capture's key check (a new replayer where the arguments changed)",
    "pfs_capture": "the eager warm-up step and the capture of one graph",
    "pfs_load": "the state copied into the graph's inputs",
    "pfs_branch": "the 'auto' viscosity branch read on the host",
    "pfs_replay": "the cudaGraphLaunch of one step",
    "pfs_advance": "a replay's state copied into the next replay's inputs",
    "pfs_metrics": "a step's metrics cloned",
    "pfs_result": "the last state cloned for the caller",
}

# the buffer of a card (int64): the last stamp's time, the loops' body
# nodes executed, each clock's ns, then three slots a loop (ns,
# iterations, runs)
LAST, NODES = 0, 1
_NS = 2
_LOOPS = _NS + len(CLOCKS)
MAX_LOOPS = 256  # live loops a process; a loop captured beyond them gets no stamps, its graph's nodes no count
SIZE = _LOOPS + 3 * MAX_LOOPS
RING = 64


def stamp_plain(values: list, now: int, ns_a: int = -1, ns_b: int = -1, count: int = -1, k: Optional[int] = None,
                iters: int = -1, body_nodes: int = 0):
    """`pfs_stamp`'s arithmetic on a list of ints (the CPU's clock):
    the time since the last stamp added to the slots ``ns_a`` and
    ``ns_b``, one to ``count``, and with ``k`` (a loop's iterations) k to
    ``iters`` and k × ``body_nodes`` to `NODES`; a negative slot skips
    its term.  The stamp's time becomes the last."""
    d = now - values[LAST]
    if ns_a >= 0:
        values[ns_a] += d
    if ns_b >= 0:
        values[ns_b] += d
    if count >= 0:
        values[count] += 1
    if k is not None:
        values[iters] += k
        values[NODES] += k * body_nodes
    values[LAST] = now


def profiling() -> bool:
    """Whether a ``torch.profiler`` (or the autograd profiler) records."""
    return torch.autograd._profiler_enabled()


_NO_SPAN = contextlib.nullcontext()


def span(name: str, arg: Optional[str] = None):
    """A ``record_function`` range while a profiler records, else nothing."""
    return torch.profiler.record_function(name, arg) if profiling() else _NO_SPAN


def _no_stamp(name: str):
    pass


@dataclasses.dataclass
class Counters:
    """A card's accumulators on the host, cumulative or a difference:
    ``ns`` a clock (`CLOCKS`), ``loops`` {slot: (ns, iterations, runs)}, the body nodes the loops executed, and the host's
    counts of the recorded calls: top-level nodes replayed (stamps
    excluded), steps, calls, and replays of graphs whose nodes are not
    counted."""

    ns: Dict[str, int]
    loops: Dict[int, tuple]
    body_nodes: int = 0
    top_nodes: int = 0
    steps: int = 0
    calls: int = 0
    uncounted: int = 0

    @classmethod
    def of(cls, values, top_nodes=0, steps=0, calls=0, uncounted=0) -> "Counters":
        values = list(values)
        loops = {}
        for j in range(MAX_LOOPS):
            row = tuple(values[_LOOPS + 3 * j:_LOOPS + 3 * j + 3])
            if any(row):
                loops[j] = row
        return cls({c: values[_NS + i] for i, c in enumerate(CLOCKS)}, loops, values[NODES], top_nodes, steps,
                   calls, uncounted)

    def minus(self, other: "Counters") -> "Counters":
        loops = {}
        for j in set(self.loops) | set(other.loops):
            a, b = self.loops.get(j, (0, 0, 0)), other.loops.get(j, (0, 0, 0))
            row = tuple(x - y for x, y in zip(a, b))
            if any(row):
                loops[j] = row
        scalars = [getattr(self, f) - getattr(other, f)
                   for f in ("body_nodes", "top_nodes", "steps", "calls", "uncounted")]
        return Counters({c: self.ns[c] - other.ns[c] for c in CLOCKS}, loops, *scalars)

    @property
    def grid_ns(self) -> int:
        """The particles and grids layer's ns (`GRID_PHASES`)."""
        return sum(self.ns[p] for p in GRID_PHASES)

    @property
    def solve_ns(self) -> int:
        """The solvers layer's ns (`SOLVE_PHASES`)."""
        return sum(self.ns[p] for p in SOLVE_PHASES)

    @property
    def while_ns(self) -> int:
        """The WHILE nodes' ns (also counted in their phases)."""
        return sum(row[0] for row in self.loops.values())

    @property
    def nodes(self) -> Optional[int]:
        """Graph nodes executed, stamps excluded; None where a replayed
        graph's nodes are not counted."""
        return None if self.uncounted else self.top_nodes + self.body_nodes


@dataclasses.dataclass
class _Snapshot:
    values: object  # a device tensor (a clone of the card's buffer) or a tuple of ints
    top_nodes: int
    steps: int
    calls: int
    uncounted: int

    def read(self) -> Counters:
        values = self.values.tolist() if isinstance(self.values, torch.Tensor) else self.values
        return Counters.of(values, self.top_nodes, self.steps, self.calls, self.uncounted)


@dataclasses.dataclass
class CallRecord:
    """One recorded call: its id, card, steps, whether a profiler was
    recording, and the card's snapshots before and after it."""

    call: int
    device: torch.device
    steps: int
    profiled: bool
    before: Optional[_Snapshot] = None
    after: Optional[_Snapshot] = None

    def counters(self) -> Counters:
        """This call's accumulators (copied to the host)."""
        return self.after.read().minus(self.before.read())


class _Card:
    """A card's (or the CPU's) accumulators and host counts."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cpu = device.type != "cuda"
        self.values = [0] * SIZE if self.cpu else torch.zeros(SIZE, dtype=torch.int64, device=device)
        self.top_nodes = self.steps = self.calls = self.uncounted = 0
        self.open: Optional[int] = None  # index in PHASES of the phase the next stamp ends (None outside a step)
        self.last: Optional[_Snapshot] = None  # the last call's snapshot after it
        self.moved = True  # the clocks may have moved since `last`

    def snapshot(self) -> _Snapshot:
        values = tuple(self.values) if self.cpu else self.values.clone()
        return _Snapshot(values, self.top_nodes, self.steps, self.calls, self.uncounted)


class PhaseRecorder:
    """The process's phase clocks: a buffer a card, the loop registry,
    and the ring of recorded calls (see the module's docstring).  One
    instance, `RECORDER`."""

    def __init__(self):
        self.cards: Dict[torch.device, _Card] = {}
        self.loops: Dict[int, str] = {}  # a live loop's slot: the phase open at its capture
        self.ring = collections.deque(maxlen=RING)
        self.stamps = 0  # stamp kernels launched or recorded (a capture's count of its own comes from this)
        self.calls = 0
        self._in_call = False

    def card(self, device) -> Optional[_Card]:
        """The card's accumulators, made at first use outside any capture
        (no graph pool owns the buffer); None while a capture would own
        it."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        card = self.cards.get(device)
        if card is None:
            if device.type == "cuda":
                with torch.cuda.device(device):
                    if torch.cuda.is_current_stream_capturing():
                        return None
            card = self.cards[device] = _Card(device)
        return card

    def _stamp(self, card: _Card, ns_a=-1, ns_b=-1, count=-1, k=None, iters=-1, body_nodes=0):
        card.moved = True
        if card.cpu:
            stamp_plain(card.values, time.perf_counter_ns(), ns_a, ns_b, count, None if k is None else int(k), iters,
                        body_nodes)
            return
        from python_fluid_simulation_tpu_torch.ops import _cuda_build as cb

        with cb.launching("stamp", card.values) as stream:
            cb.check(cb.LIB.get().pfs_stamp(stream, card.values.data_ptr(), ns_a, ns_b, count,
                                            None if k is None else k.data_ptr(), iters, body_nodes), "stamp")
        self.stamps += 1

    def step_clock(self, device):
        """Stamp a step's start on ``device`` and return ``stamp(phase)``,
        which stamps the end of each phase of `PHASES` in turn."""
        card = self.card(device)
        if card is None:
            return _no_stamp
        card.open = 0
        self._stamp(card, ns_a=_NS)

        def stamp(name: str):
            i = PHASES.index(name)
            self._stamp(card, ns_a=_NS + 1 + i)
            card.open = i + 1 if i + 1 < len(PHASES) else None

        return stamp

    def loop_begin(self, device) -> Optional[int]:
        """Stamp before a WHILE node being captured on ``device`` (ending a
        piece of the open phase) and take a slot for the loop; None, and
        no stamp, outside a stamped step or while every slot is live."""
        card = self.cards.get(torch.device(device))
        if card is None or card.open is None:
            return None
        slot = next((j for j in range(MAX_LOOPS) if j not in self.loops), None)
        if slot is None:
            return None
        self.loops[slot] = PHASES[card.open]
        self._stamp(card, ns_a=_NS + 1 + card.open)
        return slot

    def loop_end(self, device, slot: int, k: torch.Tensor, body_nodes: int):
        """Stamp after the node: its time to the loop and to its phase, one
        run, ``k`` iterations and k × ``body_nodes`` nodes."""
        card = self.cards[torch.device(device)]
        base = _LOOPS + 3 * slot
        self._stamp(card, ns_a=base, ns_b=_NS + 1 + PHASES.index(self.loops[slot]), count=base + 2, k=k,
                    iters=base + 1, body_nodes=body_nodes)

    def release(self, slots):
        """Give back the slots of loops whose graph is gone (None: an
        unstamped loop)."""
        for slot in slots:
            if slot is not None:
                self.loops.pop(slot, None)

    def replayed(self, device, nodes: int, counted: bool):
        """A replay of a graph with ``nodes`` top-level nodes (stamps
        excluded); counted inside a recorded call."""
        card = self.cards.get(torch.device(device))
        if card is None:
            return
        card.moved = True
        if self._in_call:
            card.top_nodes += nodes
            card.uncounted += not counted

    @contextlib.contextmanager
    def call(self, kind: str, device, steps: int):
        """Record one call of ``steps`` steps on ``device``: its span while
        a profiler records, a stamp that restarts the clock, and on a
        normal exit a snapshot into the ring."""
        card = self.card(device)
        self.calls += 1
        rec = CallRecord(self.calls, torch.device(device), steps, profiling())
        with span(f"pfs_{kind}", str(rec.call)):
            if card is not None:
                before = card.snapshot() if card.moved or card.last is None else card.last
                self._stamp(card)
            self._in_call = True
            try:
                yield rec
            finally:
                self._in_call = False
                if card is not None:
                    card.open = None
            if card is not None:
                card.steps += steps
                card.calls += 1
                rec.before, rec.after = before, card.snapshot()
                card.last, card.moved = rec.after, False
                self.ring.append(rec)

    def read(self, device) -> Counters:
        """The card's cumulative accumulators (copied to the host; zeros
        for a card never stamped)."""
        card = self.cards.get(torch.device(device))
        return card.snapshot().read() if card is not None else Counters.of([0] * SIZE)


RECORDER = PhaseRecorder()
step_clock = RECORDER.step_clock


def phases_summary(counters: Counters, device) -> dict:
    """What ``phases.json`` holds for one card: each clock's ms a step,
    the layers' ms a step, the loops (phase, runs, iterations, ms),
    nodes a step."""
    steps = counters.steps
    per = (lambda v: v / steps) if steps else (lambda v: None)
    ms = (lambda ns: per(ns * 1e-6))
    loops = []
    for slot, (ns, iters, runs) in sorted(counters.loops.items()):
        loops.append({"slot": slot, "phase": RECORDER.loops.get(slot), "runs": runs, "iterations": iters,
                      "ms": ns * 1e-6})
    nodes = counters.nodes
    return {
        "clock": "host perf_counter_ns" if torch.device(device).type != "cuda" else "device %globaltimer",
        "steps": steps,
        "calls": counters.calls,
        "phase_ms_per_step": {c: ms(counters.ns[c]) for c in CLOCKS},
        "grid_ms_per_step": ms(counters.grid_ns),
        "solve_ms_per_step": ms(counters.solve_ns),
        "while_ms_per_step": ms(counters.while_ns),
        "nodes_per_step": None if nodes is None else per(nodes),
        "loops": loops,
    }


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """A ``torch.profiler`` scope (CPU, and CUDA where a device is
    present) whose Chrome trace is written to ``<logdir>/trace.json``,
    with ``<logdir>/phases.json``: `phases_summary` of every card's calls
    inside the scope and the spans' names (`SPANS`); a no-op for None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    before = {d: RECORDER.read(d) for d in RECORDER.cards}
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    cards = {}
    for d in RECORDER.cards:
        got = RECORDER.read(d)
        cards[str(d)] = phases_summary(got.minus(before[d]) if d in before else got, d)
    with open(os.path.join(logdir, "phases.json"), "w") as f:
        json.dump({"cards": cards, "spans": SPANS}, f, indent=1)
