"""The measurement path refuses to run without a card: no CPU fallback, no
result line."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("argv", [
    ["rqbench/run.py", "--workload", "k1000.bulk_enc", "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
    ["rqbench/run.py", "--workload", "k1000.bulk_dec_fixed", "--seed", "2", "--seconds", "1", "--trace", "1"],
    ["rqbench/run.py", "--workload", "k50000.bulk_enc", "--seed", "3", "--seconds", "1", "--trace", "0"],
    ["-m", "rqbench.run", "--workload", "k1000.bulk_dec_fixed", "--seed", "1", "--seconds", "1", "--trace", "1"],
    ["rqbench/control.py", "--workload", "k1000.bulk_enc", "--seeds", "1"],
])
def test_refuses_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is what a host without one sees")
    p = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the harness has no program to run."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rqbench", tmp_path / "rqbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "rqbench/run.py", "--workload", "k1000.bulk_enc", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
