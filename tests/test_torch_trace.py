"""The step's phase clocks, loop counters, host spans and ring
(``utils/timers.py``) and the benchmark's readers of them.

On the CPU: an eager ``step_3d`` at 12x20x12 stamps the eleven phases in
order, once each; ``simulate`` adds one ring entry a call, tagged
profiled under ``torch.profiler`` with its ``pfs_simulate`` range; the
stamps change no bit of the step; the recorder's bookkeeping of a
replay (phases, loops, nodes) on stated counts; the readers of
``portbench/metrics/`` on a built ring; the stamp's arithmetic against a
plain model.

On the card (marker ``card``; skipped without a CUDA device, decided
inside the test): a captured 15-step flagship block with the multigrid
cell solves (WHILE nodes).  This file imports no JAX, so it runs there
without the tests' conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -m card -s
"""

import dataclasses
import gc
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import catalog  # noqa: E402
from python_fluid_simulation_tpu_torch.engine import step as step_mod  # noqa: E402
from python_fluid_simulation_tpu_torch.engine.scenes import buckling_config, buckling_scene  # noqa: E402
from python_fluid_simulation_tpu_torch.engine.step import build_geom_cache, simulate, step_3d  # noqa: E402
from python_fluid_simulation_tpu_torch.utils import timers  # noqa: E402
from python_fluid_simulation_tpu_torch.utils.timers import (  # noqa: E402
    CLOCKS,
    GRID_PHASES,
    PHASES,
    RECORDER,
    SIZE,
    SOLVE_PHASES,
    CallRecord,
    PhaseRecorder,
    _Snapshot,
    stamp_plain,
)

READERS = ("grid_ms_per_step", "solve_ms_per_step", "while_ms_per_step", "nodes_per_step")


@pytest.fixture(scope="module")
def scene():
    torch.set_num_threads(1)
    cfg = buckling_config(dx=0.05)
    s0 = buckling_scene(cfg, device="cpu")
    return cfg, s0, build_geom_cache(s0.solid)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves(v)]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) for x in _leaves(getattr(obj, f.name))]
    return [torch.as_tensor(obj)]


def test_eager_step_stamps_the_eleven_phases_in_order(scene, monkeypatch):
    cfg, s0, geom = scene
    names = []
    clock = step_mod.step_clock

    def logged(dev):
        stamp = clock(dev)

        def each(name):
            names.append(name)
            stamp(name)

        return each

    monkeypatch.setattr(step_mod, "step_clock", logged)
    before = RECORDER.read("cpu")
    step_3d(s0, cfg, geom=geom)
    got = RECORDER.read("cpu").minus(before)
    assert names == list(PHASES)
    assert all(got.ns[c] >= 0 for c in CLOCKS)
    assert got.grid_ns + got.solve_ns == sum(got.ns[p] for p in PHASES) > 0
    assert not got.loops and got.body_nodes == 0  # no WHILE node runs eagerly


def test_simulate_adds_one_ring_entry_a_call(scene):
    cfg, s0, geom = scene
    first = RECORDER.calls
    s1, _ = simulate(s0, cfg, 2, geom=geom)
    simulate(s1, cfg, 1, geom=geom)
    recs = [r for r in RECORDER.ring if r.call > first]
    assert [(r.steps, r.profiled, r.device.type) for r in recs] == [(2, False, "cpu"), (1, False, "cpu")]
    for r in recs:
        got = r.counters()
        assert got.steps == r.steps and got.calls == 1
        assert got.top_nodes == 0 and got.nodes == 0  # nothing replayed on the CPU


def test_a_call_under_the_profiler_is_profiled_and_spanned(scene):
    from torch.profiler import ProfilerActivity, profile

    cfg, s0, geom = scene
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        simulate(s0, cfg, 1, geom=geom)
    rec = RECORDER.ring[-1]
    assert rec.profiled and rec.steps == 1
    assert "pfs_simulate" in {e.name for e in prof.events()}
    simulate(s0, cfg, 1, geom=geom)
    assert not RECORDER.ring[-1].profiled


def test_stamps_change_no_bit_of_the_step(scene, monkeypatch):
    cfg, s0, geom = scene
    stamped = step_3d(s0, cfg, geom=geom)
    monkeypatch.setattr(step_mod, "step_clock", lambda dev: (lambda name: None))
    plain = step_3d(s0, cfg, geom=geom)
    a, b = _leaves(stamped), _leaves(plain)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _replays(rec: PhaseRecorder, steps, top, loops):
    """``steps`` replays in one call on the CPU card as a captured step's
    stamps would run them: each step's phases, and in its 'density' and
    'pressure' phases a loop of (body nodes, iterations a step).  Returns
    each loop's slot by phase."""
    slots = {}
    with rec.call("simulate", "cpu", len(steps)):
        for k_step in steps:
            stamp = rec.step_clock("cpu")
            for name in PHASES:
                if name in loops:
                    if name not in slots:
                        slots[name] = rec.loop_begin("cpu")
                    else:
                        rec._stamp(rec.cards[torch.device("cpu")], ns_a=timers._NS + 1 + PHASES.index(name))
                    rec.loop_end("cpu", slots[name], torch.tensor(k_step[name], dtype=torch.int32), loops[name])
                stamp(name)
            rec.replayed("cpu", top, True)
    return slots


def test_the_node_count_is_top_level_plus_bodies_times_iterations():
    rec = PhaseRecorder()
    iters = [{"density": 8, "pressure": 10}, {"density": 7, "pressure": 12}, {"density": 9, "pressure": 10}]
    slots = _replays(rec, iters, top=5000, loops={"density": 92, "pressure": 57})
    got = rec.ring[-1].counters()
    want = 3 * 5000 + sum(92 * it["density"] + 57 * it["pressure"] for it in iters)
    assert got.nodes == want and got.top_nodes == 15000 and got.steps == 3
    assert {rec.loops[s]: got.loops[s][1:] for s in slots.values()} == {"density": (24, 3), "pressure": (32, 3)}
    assert got.while_ns <= got.solve_ns
    # a replayed graph whose loops were not all stamped leaves nodes uncounted
    with rec.call("simulate", "cpu", 1):
        rec.replayed("cpu", 5000, False)
    assert rec.ring[-1].counters().nodes is None
    # outside a call a replay is not counted
    rec.replayed("cpu", 5000, True)
    assert rec.read("cpu").top_nodes == 20000


def test_loop_slots_are_given_back_and_a_loop_past_them_is_unstamped():
    """A loop takes the lowest free slot inside a stamped step, none
    outside one; a capture that is dropped gives its slots back; a loop
    captured while every slot is live gets no slot (its capture then
    counts no nodes, `CapturedStep.counted`)."""
    rec = PhaseRecorder()
    assert rec.loop_begin("cpu") is None  # no card stamped yet
    rec.step_clock("cpu")("dt")
    taken = [rec.loop_begin("cpu") for _ in range(timers.MAX_LOOPS)]
    assert taken == list(range(timers.MAX_LOOPS)) and set(rec.loops.values()) == {"advect"}
    assert rec.loop_begin("cpu") is None
    rec.release((3, None, 7))
    assert rec.loop_begin("cpu") == 3 and rec.loop_begin("cpu") == 7 and rec.loop_begin("cpu") is None
    rec.cards[torch.device("cpu")].open = None  # outside a step
    rec.release((0,))
    assert rec.loop_begin("cpu") is None and 0 not in rec.loops


def test_stamp_arithmetic_matches_a_plain_model():
    """Each stamp adds the time since the previous one to its slots: the
    phases' slots, which every stamp names once, sum to the span of the
    stamps' times; a loop's slots read its time (also in its phase), its
    iterations, and k × body nodes."""
    values = [0] * SIZE
    times = [100, 130, 175, 400, 410, 1000]
    stamp_plain(values, times[0])  # restarts the clock, adds nothing
    assert values == [100] + [0] * (SIZE - 1)
    stamp_plain(values, times[1], ns_a=5, count=20)
    stamp_plain(values, times[2], ns_a=6, count=21)
    stamp_plain(values, times[3], ns_a=40, ns_b=6, count=42, k=7, iters=41, body_nodes=11)
    stamp_plain(values, times[4], ns_a=6, count=21)
    stamp_plain(values, times[5], ns_a=5, count=20)
    assert values[5] == 30 + 590 and values[6] == 45 + 225 + 10 and values[40] == 225
    assert values[5] + values[6] == times[-1] - times[0]  # the loop's 225 ns is inside phase 6's
    assert values[20] == 2 and values[21] == 2 and values[42] == 1 and values[41] == 7
    assert values[timers.NODES] == 77 and values[timers.LAST] == 1000


def _record(call, device, steps, profiled, before, after):
    return CallRecord(call, torch.device(device), steps, profiled, before=before, after=after)


def _ring(device="cuda", uncounted_block=None):
    """A recorder whose ring holds a set-up call, 2 untraced blocks of 15
    steps, then 2 profiled ones, on ``device``: each block's counters
    known (``uncounted_block`` replayed a graph with an unstamped loop)."""
    rec = PhaseRecorder()
    values = [0] * SIZE
    snaps, top = [], 0
    for block in range(5):
        for _ in range(15):
            for i, c in enumerate(CLOCKS):
                values[timers._NS + i] += 1000 * (i + 1) * (block + 1)
            values[timers._LOOPS] += 700 * (block + 1)  # a loop in 'density'
            values[timers._LOOPS + 1] += 8
            values[timers._LOOPS + 2] += 1
            values[timers.NODES] += 8 * 90
            top += 4000
        snaps.append(_Snapshot(tuple(values), top, 15 * (block + 1), block + 1,
                               int(uncounted_block is not None and block >= uncounted_block)))
    zero = _Snapshot((0,) * SIZE, 0, 0, 0, 0)
    for i, snap in enumerate(snaps):
        rec.ring.append(_record(i + 1, device, 15, i >= 3, snaps[i - 1] if i else zero, snap))
    return rec


@pytest.mark.parametrize("name", READERS)
def test_a_stamp_reader_with_nothing_to_read_returns_nothing(name, monkeypatch):
    read = catalog.load_metric(name)
    assert read({}) is None
    monkeypatch.setattr(timers, "RECORDER", _ring())
    assert read({}) is None
    assert read({"steps": 45}) is None  # the untraced calls hold 30 steps
    monkeypatch.setattr(timers, "RECORDER", _ring("cpu"))
    assert read({"steps": 30}) is None  # never a CPU number under a device metric
    monkeypatch.setattr(timers, "RECORDER", _ring(uncounted_block=2))
    assert read({"steps": 30}) is None  # an untraced block replayed a graph with an unstamped loop
    monkeypatch.setattr(timers, "RECORDER", _ring(uncounted_block=3))
    assert read({"steps": 30}) is not None  # only a traced block did
    monkeypatch.setattr(timers, "RECORDER", PhaseRecorder())
    assert read({"steps": 30}) is None  # no profiled call


def test_the_stamp_readers_read_the_untraced_blocks(monkeypatch):
    monkeypatch.setattr(timers, "RECORDER", _ring())
    got = {n: catalog.load_metric(n)({"steps": 30}) for n in READERS}
    # blocks 2 and 3 (the two calls before the first profiled one), 15 steps each
    per_step = {c: 1000 * (i + 1) * (2 + 3) / 2 * 1e-6 for i, c in enumerate(CLOCKS)}
    assert got["grid_ms_per_step"] == pytest.approx(sum(per_step[p] for p in GRID_PHASES))
    assert got["solve_ms_per_step"] == pytest.approx(sum(per_step[p] for p in SOLVE_PHASES))
    assert got["while_ms_per_step"] == pytest.approx(700 * (2 + 3) / 2 * 1e-6)
    assert got["nodes_per_step"] == 4000 + 8 * 90


def test_phase_names_and_layers():
    assert CLOCKS[0] == "between" and set(GRID_PHASES) | set(SOLVE_PHASES) == set(PHASES)
    assert not set(GRID_PHASES) & set(SOLVE_PHASES) and len(PHASES) == 11


@pytest.mark.card
def test_card_captured_block_counts_and_times_its_phases(monkeypatch):
    """A captured 15-step flagship block with ``precond='mg'`` (the cell
    solves are WHILE nodes): every step's loop iterations equal its
    density and pressure iterations, its nodes the host's count from the
    capture, its phases sum to 80-100% of its CUDA-event time (an event
    before each replay, as the benchmark records them), and the block is
    bitwise the eager ``step_3d``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = buckling_config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, precond="mg"))
    s0 = buckling_scene(cfg, device=dev)
    geom = build_geom_cache(s0.solid)
    s0, _ = simulate(s0, cfg, 3, geom=geom)  # past the first transient; the capture

    marks, snaps = [], []

    class Probe(step_mod.StepReplayer):
        def load(self, state):
            super().load(state)
            snaps.append(RECORDER.cards[dev].snapshot())

        def replay(self, branch):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            cap = super().replay(branch)
            snaps.append(RECORDER.cards[dev].snapshot())
            return cap

    monkeypatch.setattr(step_mod.simulate, "capture", step_mod.SimulateCapture(replayer=Probe))
    simulate(s0, cfg, 15, geom=geom)  # captures
    marks.clear()
    snaps.clear()
    state, m = simulate(s0, cfg, 15, geom=geom)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    cap = next(iter(step_mod.simulate.capture.replayer.captured.values()))
    assert len(cap.loop_nodes) == 2 and cap.counted and cap.stamps == len(PHASES) + 1 + 2 * 2
    counters = [b.read().minus(a.read()) for a, b in zip(snaps[:-1], snaps[1:])]
    event_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:] + [end])]
    phases = [RECORDER.loops[s] for s in cap.loop_slots]
    assert phases == ["density", "pressure"]
    ratios = []
    for i, got in enumerate(counters):
        iters = {p: got.loops[s][1] for p, s in zip(phases, cap.loop_slots)}
        assert iters == {"density": int(m["density_iters"][i]), "pressure": int(m["pressure_iters"][i])}
        assert all(got.loops[s][2] == 1 for s in cap.loop_slots)
        host = cap.nodes - cap.stamps + sum(n * iters[p] for n, p in zip(cap.loop_nodes, phases))
        assert got.nodes == host
        phases_ms = (got.grid_ns + got.solve_ns) * 1e-6
        ratios.append(phases_ms / event_ms[i])
        assert got.while_ns <= got.solve_ns
    print("phases / CUDA-event ms a step:", [round(r, 4) for r in ratios])
    assert all(0.8 <= r <= 1.0 for r in ratios)
    rec = RECORDER.ring[-1]
    assert rec.steps == 15 and not rec.profiled and rec.counters().nodes == sum(c.nodes for c in counters)

    eager = s0
    for _ in range(15):
        eager, _ = step_3d(eager, cfg, geom=geom)
    for a, b in zip(_leaves(state), _leaves(eager)):
        assert torch.equal(a, b)

    slots = cap.loop_slots
    del cap
    step_mod.simulate.capture.clear()
    gc.collect()
    assert not set(slots) & set(RECORDER.loops)  # the dropped capture gave its slots back
