"""What the benchmark loads: no module of JAX or of the JAX package in any
cell's run, and nothing of the program in the reference."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "yolo_from_scratch_tpu"}
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


def _modules(path: Path) -> set:
    """Full names of the modules a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    """The reference imports the program neither directly nor through the
    harness: of the benchmark, only the reference itself."""
    mods = _modules(path)
    assert not {m for m in mods if m.split(".")[0] ==
                "yolo_from_scratch_tpu_torch"}
    assert all(m.startswith("portbench.reference") for m in mods
               if m.split(".")[0] == "portbench")


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import portbench.reference.model, portbench.reference.train, "
            "portbench.reference.quant, portbench.reference.serve; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'yolo_from_scratch_tpu_torch', 'jax', "
            "'yolo_from_scratch_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


RUN = """
import sys, time
sys.path.insert(0, {root!r})
from portbench import run
from portbench.core import registry
from portbench.tests.conftest import tiny
full = registry.workload
registry.workload = lambda name: tiny(full(name))
ok, result, _, _ = run.run_cell({cell!r}, 2**33 + 5, 0.5, False, "cpu",
                             lambda: 0.0)
found = run.forbidden_modules()
print(sorted(found), ok)
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    """A whole run of the cell, cut to a CPU size, in a fresh interpreter:
    afterwards `sys.modules` holds nothing of JAX or the JAX package."""
    out = subprocess.run([sys.executable, "-c", RUN.format(root=str(ROOT),
                                                          cell=cell)],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["[]", "True"], out.stdout
