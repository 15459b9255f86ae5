"""Readings for the limits of the correctness check, on the card at a
cell's own size, in one process:

- the program's readings: for each of ``--seeds``, the cell's set-up and
  one block through the timed path, then the run's own check
  (``harness.checked``) over every step of the block (``--all-steps``) or
  the steps a run draws, with the start (solids, first step from the
  scene);
- the control's readings: for each of ``--control-seeds``, the frozen
  reference holding its state and grid velocities in bfloat16
  (``reference/engine/step.py``'s ``low``) put in the program's place,
  compared with the float32 reference on the same inputs, the same
  numbers.

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 --out control_<cell>.json

Not run by the benchmark's runs.  Prints one JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import catalog, check, harness, inputs  # noqa: E402


def program_readings(cell, config, seed: int, all_steps: bool, device) -> dict:
    from portbench.program import Program

    rb = inputs.body_table(config)
    prog = Program(config, cell.viscosity_mode, rb, inputs.particle_positions(config, seed), device)
    s0, _ = prog.simulate(prog.scene, cell.start_steps)
    block_last, _ = prog.simulate(s0, cell.segment_steps)
    ref = check.Reference(config, cell.viscosity_mode, rb, device)
    picks = list(range(cell.segment_steps)) if all_steps else None
    t0 = time.perf_counter()
    numbers, live, notes = harness.checked(prog, ref, s0, block_last, cell, seed, picks=picks)
    return {"seed": seed, "kind": "program", "numbers": numbers, "live": live, **notes,
            "check_seconds": time.perf_counter() - t0}


def control_readings(cell, config, seed: int, device, low=torch.bfloat16) -> dict:
    """The reference in ``low`` in the program's place, against the
    reference in float32, on the steps the run draws and the start."""
    from portbench.program import Program, particles_of, state_parts

    rb = inputs.body_table(config)
    prog = Program(config, cell.viscosity_mode, rb, inputs.particle_positions(config, seed), device)
    s0, _ = prog.simulate(prog.scene, cell.start_steps)
    states, _ = prog.chained(s0, cell.segment_steps)
    picks = check.sample_steps(seed, cell.segment_steps, min(harness.CHECK_STEPS, cell.segment_steps))
    befores = [{k: v.cpu() for k, v in state_parts(states[k]).items()} for k in picks]
    scene = {k: v.cpu() for k, v in state_parts(prog.scene).items()}
    del states
    prog.release()
    ref = check.Reference(config, cell.viscosity_mode, rb, device)
    rows = []
    for k, before in zip(picks, befores):
        good, gdt, _, _ = ref.step(before)
        bad, bdt, _, _ = ref.step(before, low=low)
        rows.append({"step": k, **check.step_gaps(bad, bdt, good, gdt)})
    good, gdt, _, _ = ref.step(scene)
    bad, bdt, _, _ = ref.step(scene, low=low)
    phi = ref.solid.phi
    return {"seed": seed, "kind": "control", "steps": rows, "start": check.step_gaps(bad, bdt, good, gdt),
            "solid_phi_m": check.max_abs(phi, phi.to(low).to(phi.dtype)), "block_repeat": 0.0}


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--all-steps", action="store_true")
    p.add_argument("--out", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = catalog.load_cell(args.workload)
    config = catalog.load_config(cell.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for seed in args.seeds:
        rows.append(program_readings(cell, config, seed, args.all_steps, "cuda"))
        print(json.dumps(rows[-1]), flush=True)
    for seed in args.control_seeds:
        rows.append(control_readings(cell, config, seed, "cuda"))
        print(json.dumps(rows[-1]), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(),
                                          "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
