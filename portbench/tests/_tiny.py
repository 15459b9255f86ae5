"""A tiny copy of a cell, written to a temporary directory: the buckling
scene at dx 0.05 (12x20x12 cells, 1,424 particles) under the limits of
``buckling48.apic``, found by name like any cell."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"


def write_tiny(tmp: Path, cell: str = "buckling48.apic") -> Path:
    """A benchmark folder under ``tmp`` (with its BENCHMARK.json beside
    it) holding the cell ``tiny.apic``; returns the folder."""
    root = tmp / "pb"
    (root / "configs").mkdir(parents=True)
    (root / "workloads").mkdir()
    shutil.copytree(BENCH / "metrics", root / "metrics")
    src = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{src['config']}.json").read_text())
    cfg.update(name="tiny", particles=1424)
    cfg["sim"]["grid"]["dx"], cfg["sim"]["particle_dx"] = 0.05, 0.025
    cfg["sim"]["solver"].update(precond="jacobi", max_iter=600)
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    src.update(config="tiny", start_steps=3, segment_steps=4)
    (root / "workloads" / "tiny.apic.json").write_text(json.dumps(src))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "tiny.apic", "config": "tiny", "traffic": "apic", "chips": 1, "why": "tests"}]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
