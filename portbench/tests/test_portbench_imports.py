"""Nothing in the benchmark's folder imports JAX or the JAX package, and
the reference and the counts import nothing of the port: an import walk
over every file's syntax tree, names compared whole by their top-level
part (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "python_fluid_simulation_tpu"}
PORT = "python_fluid_simulation_tpu_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of every module a file imports, anywhere in it."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def files():
    return sorted(BENCH.rglob("*.py"))


def test_the_walk_sees_every_form():
    src = "import jax.numpy as jnp\nfrom python_fluid_simulation_tpu.ops import x\ndef f():\n    import flax\n"
    tmp = BENCH / "tests" / "_walk_probe.txt"
    try:
        tmp.write_text(src)
        assert imported_tops(tmp) == {"jax", "python_fluid_simulation_tpu", "flax"}
    finally:
        tmp.unlink()
    assert PORT.split(".")[0] not in FORBIDDEN and PORT.startswith("python_fluid_simulation_tpu")


@pytest.mark.parametrize("path", files(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in files() if p.relative_to(BENCH).parts[0] in ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_counts_import_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.harness, portbench.program, portbench.check; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & %r); print(bad); sys.exit(1 if bad else 0)"
            % (str(BENCH.parent), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
