"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program either (top-level names compared
whole: nanorq_tpu_torch begins with nanorq_tpu)."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "nanorq_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert not _imports(path) & (JAX | {"nanorq_tpu_torch"})
    assert _imports(path) <= {"base64", "dataclasses", "numpy", "torch", "rqbench"}


def test_a_run_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import rqbench.run, rqbench.harness, rqbench.control; "
            "from rqbench import harness; import nanorq_tpu_torch.codec.batch; "
            "print(rqbench.run.forbidden_modules())") % str(HERE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
