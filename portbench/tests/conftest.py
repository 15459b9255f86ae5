"""CPU tests of the port's benchmark.  Run from the repository's root:

    python -m pytest portbench/tests -q

A test that needs the card carries the ``card`` marker and skips, with its
reason, where no CUDA device is present (decided inside the test)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (an H100); skipped elsewhere")
