"""On the card: a cell runs as its command line runs it and comes out correct, and
its control comes out not correct.  Skips where torch sees no CUDA device."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    _card()
    p = subprocess.run([sys.executable, "rqbench/run.py", "--workload", "k1000.bulk_enc", "--seed", "3000000001",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert d["correct"] and d["attempted"] > 0 and d["device"]["busy_s"] > 0
    assert list(d)[-1] == "checks"


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    _card()
    p = subprocess.run([sys.executable, "rqbench/control.py", "--workload", "k1000.bulk_enc", "--seeds", "5",
                        "--seconds", "2"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    d = json.loads(p.stdout.strip().splitlines()[-1])
    assert not d["correct"] and d["checks"]["enc_wrong_bytes"]["value"] > 0
