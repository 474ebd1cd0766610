"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference takes nothing from the port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import tiny

REFERENCE = tiny.ROOT / "benchmark" / "reference"


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert _imports(path) <= {"__future__", "collections", "contextlib", "dataclasses", "functools", "numpy", "torch",
                              "benchmark"}


def test_reference_loads_no_module_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.check, benchmark.reference.features, benchmark.reference.optflow\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'microaligner_tpu_torch', 'microaligner_tpu', 'jax'}))"
            % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "from benchmark import harness\n"
            "assert tiny.run('optflow_20k.cycif4')['correct']\n"
            "print(harness.forbidden_modules())" % str(tiny.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_names_compare_whole():
    import types

    sys.modules["microaligner_tpu_torch_probe"] = types.ModuleType("microaligner_tpu_torch_probe")
    try:
        assert "microaligner_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["microaligner_tpu_torch_probe"]
    sys.modules["microaligner_tpu.probe"] = types.ModuleType("microaligner_tpu.probe")
    try:
        assert "microaligner_tpu.probe" in harness.forbidden_modules()
    finally:
        del sys.modules["microaligner_tpu.probe"]
