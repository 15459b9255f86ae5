"""The PyTorch port stands alone: no JAX, no JAX package, no CPU fallback
for the chip smoke run.

* In a fresh interpreter whose import system refuses ``jax``, ``flax``,
  ``msgpack`` (which only the Flax checkpoint reader imports, when
  called) and ``python_fluid_simulation_tpu`` (the JAX package), every
  module of ``python_fluid_simulation_tpu_torch`` (the ``parallel/``
  modules among them) and ``chip_smoke`` imports.
* The CLI (``run``), ``utils`` and ``native`` are among those modules,
  and importing them starts no process: the native library is built
  with ``g++`` at its first use, never at import.
* ``python3 chip_smoke.py`` on a machine without CUDA exits non-zero
  with a clear message and prints no result line; so does a copy of the
  script alone in an empty directory.
"""

import os
import shutil
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "msgpack", "python_fluid_simulation_tpu"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import python_fluid_simulation_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
parallel = {"python_fluid_simulation_tpu_torch." + m for m in ("parallel", "parallel.mesh", "parallel.halo",
                                                               "parallel.halo_rdma", "ops.cuda_halo",
                                                               "parallel.particles", "engine.step2d", "ops.sdf2d")}
assert parallel <= set(names), sorted(parallel - set(names))
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "python_fluid_simulation_tpu")]
assert not bad, bad
print(len(names), "modules")
"""


_HOST_MODULES = r"""
import importlib, importlib.abc, pkgutil, subprocess, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "python_fluid_simulation_tpu"):
            raise ImportError("refused: " + name)
        return None

started = []

class NoProcess(subprocess.Popen):
    def __init__(self, args, *a, **kw):
        started.append(args)
        raise AssertionError("a process was started at import: %r" % (args,))

sys.meta_path.insert(0, Refuse())
subprocess.Popen = NoProcess
import python_fluid_simulation_tpu_torch as pkg
names = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
want = {"python_fluid_simulation_tpu_torch." + m for m in (
    "run", "native", "utils", "utils.metrics", "utils.io", "utils.checkpoint", "utils.timers", "utils.roofline",
    "utils.viewer")}
assert want <= names, sorted(want - names)
for name in sorted(want):
    importlib.import_module(name)
assert not started, started
run = sys.modules["python_fluid_simulation_tpu_torch.run"]
assert callable(run.build_argparser) and callable(run.main)
print("ok")
"""


def test_cli_utils_and_native_import_without_jax_or_a_build():
    out = subprocess.run(
        [sys.executable, "-c", _HOST_MODULES], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = ROOT
    return env


def test_port_imports_without_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 20  # every ported module was imported


def _last_line(text):
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not _last_line(out.stdout).startswith('{"ok": true')


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
