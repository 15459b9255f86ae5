"""On the card: one short run of each cell through the command the
benchmark runs, correct and with every end-to-end metric.  Skipped, with
its reason, where no CUDA device is present.  On the card:

    python3 -m pytest portbench/tests -q -m card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["buckling48.apic", "buckling128.apic"])
def test_a_short_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["compared"]
    assert set(result["metrics"]) == {"steps_per_s", "step_ms_p95", "peak_mem_gb", "setup_s"}


def test_no_card_no_result(monkeypatch, capsys):
    from portbench import harness

    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "buckling48.apic", "--seed", "1", "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
