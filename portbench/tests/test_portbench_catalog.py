"""Discovery of cells, configurations and metrics by name, from files
alone; refusal of what the harness does not know."""

import json

import pytest
from _tiny import BENCH, REPO, write_tiny

from portbench import catalog


def test_benchmark_names_resolve_to_files():
    bench = catalog.load_benchmark()
    for w in bench["workloads"]:
        cell = catalog.load_cell(w["name"])
        assert cell.config == w["config"] and cell.traffic == w["traffic"]
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert catalog.load_config(c["name"])["name"] == c["name"]
    for m in bench["per_layer"]:
        assert callable(catalog.load_metric(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_cell_config_and_metric_added_as_files(tmp_path):
    root = write_tiny(tmp_path)
    (root / "metrics" / "always_seven.py").write_text("def read(ctx):\n    return 7.0\n")
    cell = catalog.load_cell("tiny.apic", root)
    assert (cell.config, cell.segment_steps, cell.start_steps) == ("tiny", 4, 3)
    assert catalog.load_config("tiny", root)["particles"] == 1424
    assert catalog.load_metric("always_seven", root)({}) == 7.0
    bench = catalog.load_benchmark(root)
    assert [w["name"] for w in bench["workloads"]] == ["tiny.apic"]


def test_unknown_traffic_key_is_refused_by_name(tmp_path):
    root = write_tiny(tmp_path)
    path = root / "workloads" / "tiny.apic.json"
    data = json.loads(path.read_text())
    data["arrival_rate"] = 3
    path.write_text(json.dumps(data))
    with pytest.raises(catalog.CatalogError, match="arrival_rate"):
        catalog.load_cell("tiny.apic", root)


@pytest.mark.parametrize("key,value", [("segment_steps", 0), ("start_steps", "100"), ("viscosity_mode", 1)])
def test_bad_traffic_values_are_refused(tmp_path, key, value):
    root = write_tiny(tmp_path)
    path = root / "workloads" / "tiny.apic.json"
    data = json.loads(path.read_text())
    data[key] = value
    path.write_text(json.dumps(data))
    with pytest.raises(catalog.CatalogError, match=key):
        catalog.load_cell("tiny.apic", root)


def test_missing_limit_is_refused(tmp_path):
    root = write_tiny(tmp_path)
    path = root / "workloads" / "tiny.apic.json"
    data = json.loads(path.read_text())
    del data["limits"]["x_m"]
    path.write_text(json.dumps(data))
    with pytest.raises(catalog.CatalogError, match="limits"):
        catalog.load_cell("tiny.apic", root)


@pytest.mark.parametrize("name", ["../x", "a b", "", "x" * 65])
def test_bad_names_are_refused(name):
    with pytest.raises(catalog.CatalogError):
        catalog.load_cell(name)


def test_config_files_hold_the_published_scene():
    for name, res, n in (("buckling48", [48, 80, 48], 89648), ("buckling128", [77, 128, 77], 356256)):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        assert cfg["grid_res"] == res and cfg["particles"] == n and cfg["reduced"] == []
        assert cfg["sim"]["physics"]["mu"] == 1.0 and cfg["sim"]["dt_mode"] == "cfl"
