"""No module the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``rrin_tpu_torch`` is not ``rrin_tpu``); the reference
imports nothing of the program; nothing reads the JAX package's benchmark
folder."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "rrin_tpu"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text()


def test_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        assert _imports(path) <= {"__future__", "typing", "torch"}, path


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run as r, portbench.control;"
            "import rrin_tpu_torch.pipeline; print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
