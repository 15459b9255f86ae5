"""Find a cell, its configuration and the per-layer metrics by name.

Everything that belongs to one cell, one configuration or one metric is a
file of its own under the benchmark's folder, found by the name
``BENCHMARK.json`` gives it:

- ``workloads/<cell>.json``: the cell's configuration name, its traffic
  (the parameters below) and the limits of its correctness check;
- ``configs/<config>.json``: the scene (the ``SimConfig`` fields, the
  rigid bodies, the fluid box) as it is run;
- ``metrics/<metric>.py``: a reader with ``read(ctx) -> float | None``.

Adding a cell, a configuration or a metric is adding files.  A traffic
parameter this module does not know is refused by name, never ignored.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")

# traffic parameters: name -> (type, meaning)
TRAFFIC_KEYS = {
    "viscosity_mode": (str, "the step's viscosity mode; the frozen reference checks 'apic'"),
    "start_steps": (int, "steps simulated from the seeded scene in set-up; every block starts from that state"),
    "segment_steps": (int, "steps a block: one `simulate` call and one synchronise, as the CLI's --block"),
}
CELL_KEYS = {"config", "traffic", "why", "limits"} | set(TRAFFIC_KEYS)
LIMIT_KEYS = ("x_m", "v_m_per_s", "c_per_s", "solid_phi_m")


class CatalogError(ValueError):
    """A cell, configuration or metric file that is missing or malformed."""


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    viscosity_mode: str
    start_steps: int
    segment_steps: int
    limits: Dict[str, float]


def _check_name(kind: str, name: str):
    if not isinstance(name, str) or not _NAME.match(name):
        raise CatalogError(f"{kind} name {name!r} is not 1-64 letters, digits, '_', '.' or '-'")


def _load_json(path: Path) -> dict:
    if not path.is_file():
        raise CatalogError(f"no file {path}")
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise CatalogError(f"{path}: a JSON object is expected")
    return data


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``workloads/<name>.json``: every key known, every
    traffic parameter of its type and positive, a limit for each compared
    number."""
    _check_name("cell", name)
    path = root / "workloads" / f"{name}.json"
    data = _load_json(path)
    unknown = sorted(set(data) - CELL_KEYS)
    if unknown:
        raise CatalogError(f"{path}: unknown key(s) {', '.join(unknown)}; known: {', '.join(sorted(CELL_KEYS))}")
    missing = sorted(CELL_KEYS - set(data) - {"why"})
    if missing:
        raise CatalogError(f"{path}: missing key(s) {', '.join(missing)}")
    for key, (kind, _) in TRAFFIC_KEYS.items():
        value = data[key]
        if not isinstance(value, kind) or isinstance(value, bool):
            raise CatalogError(f"{path}: {key} must be {kind.__name__}, got {value!r}")
        if kind is int and value < 1:
            raise CatalogError(f"{path}: {key} must be at least 1, got {value}")
    _check_name("config", data["config"])
    _check_name("traffic", data["traffic"])
    limits = data["limits"]
    if not isinstance(limits, dict) or sorted(limits) != sorted(LIMIT_KEYS):
        raise CatalogError(f"{path}: limits must have exactly the keys {', '.join(LIMIT_KEYS)}")
    for key, value in limits.items():
        if not isinstance(value, (int, float)) or isinstance(value, bool) or value < 0:
            raise CatalogError(f"{path}: limit {key} must be a number >= 0, got {value!r}")
    return Cell(name=name, config=data["config"], traffic=data["traffic"],
                limits={k: float(v) for k, v in limits.items()},
                **{k: data[k] for k in TRAFFIC_KEYS})


def load_config(name: str, root: Path = ROOT) -> dict:
    """The configuration ``configs/<name>.json``: ``sim`` (the
    ``SimConfig`` fields), ``bodies`` (the rigid bodies, as
    ``RigidBodySet.add`` takes them), ``fluid_box`` and ``particles``."""
    _check_name("config", name)
    path = root / "configs" / f"{name}.json"
    data = _load_json(path)
    for key in ("sim", "bodies", "fluid_box", "particles", "precision"):
        if key not in data:
            raise CatalogError(f"{path}: missing key {key!r}")
    if data["precision"] != "float32":
        raise CatalogError(f"{path}: precision {data['precision']!r}; the reference is float32")
    return data


def load_metric(name: str, root: Path = ROOT) -> Callable[[dict], Optional[float]]:
    """The reader ``metrics/<name>.py``'s ``read``."""
    _check_name("metric", name)
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CatalogError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    read = getattr(module, "read", None)
    if not callable(read):
        raise CatalogError(f"{path}: no read(ctx) function")
    return read


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` beside the benchmark's folder."""
    return _load_json(root.parent / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` ('end_to_end' or 'per_layer') that
    ``cell`` reports: those without a ``workloads`` key, and those whose
    list names it."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]
