"""The port's soak (`nanorq_tpu_torch/tools/longfuzz.py`): a few trials on
the CPU, every one bit-exact, with the counters in its JSON lines; its draw
against the JAX package's `tools/longfuzz.py` on the fields they share; the
port's own fields; and on the card (`cuda`) ten trials at a 1-byte program
budget."""

import contextlib
import importlib.util
import io
import json
import pathlib

import pytest
import torch

from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.tools import longfuzz

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(argv) -> tuple[dict, list]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        last = longfuzz.main(argv)
    return last, [json.loads(x) for x in out.getvalue().splitlines()]


def test_cpu_trials_pass_and_print_the_counters():
    last, lines = _run(["--device", "cpu", "--trials", "3"])
    assert lines == [last] and last["trials"] == 3 and last["bit_exact"] and last["done"]
    assert last["first_seed"] == longfuzz.BASE_SEED and last["device"] == "cpu" and "power_limit_w" in last
    assert set(longfuzz.COUNTERS) <= set(last) and set(last["blocks_per_arm"]) == set(longfuzz.ARM_BLOCKS)
    assert last["replay_program_capture"] == 0  # nothing is captured on the CPU
    assert last["replay_compile_new"] + last["replay_compile_hit"] > 0


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_longfuzz", REPO / "tools" / "longfuzz.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [7000051, 7000104])  # trials of a few symbols: seconds on the CPU
def test_the_draw_is_the_jax_tools_configuration(seed):
    """The JAX tool's trial, run through the JAX package, returns its
    configuration; the port's draw of the same seed holds it field for
    field."""
    want = _jax_tool().run_trial(seed)
    cfg = longfuzz.draw(seed, "cpu")[0]
    assert set(want) == set(longfuzz.SHARED)
    assert {k: cfg[k] for k in longfuzz.SHARED} == want


def test_the_ports_fields():
    """The port's fields come from a generator of their own, a forced field
    replaces the drawn one, and only the port's fields can be forced; no
    budget on the CPU, and `res` only where the native factorization is."""
    arms = set()
    for seed in range(7000000, 7000060):
        cfg, rng, _, _ = longfuzz.draw(seed, "cpu")
        assert rng.integers(1 << 30) == longfuzz.draw(seed, "cpu", lanes=4, arm="host")[1].integers(1 << 30)
        assert cfg["budget"] is None and 0 <= cfg["lanes"] <= 4 and cfg["device"] == "cpu"
        arms.add(cfg["arm"])
    assert arms == (set(longfuzz.ARMS) if native_available() else set(longfuzz.ARMS) - {"res"})
    cfg = longfuzz.draw(7000000, "cpu", lanes=2, budget=1)[0]
    assert cfg["lanes"] == 2 and cfg["budget"] == 1
    with pytest.raises(ValueError, match="port's fields"):
        longfuzz.draw(7000000, "cpu", size=10)


def test_a_failure_names_its_seed_and_how_to_replay_it(monkeypatch, capsys):
    def broken(seed, device, **force):
        raise AssertionError("the decoded bytes differ from the object")

    monkeypatch.setattr(longfuzz, "run_trial", broken)
    with pytest.raises(AssertionError, match="decoded bytes"):
        longfuzz.soak(7000005, "cpu", trials=2, forced=[{"lanes": 2}], quiet=True)
    out = capsys.readouterr().out
    assert "FUZZ FAILURE at seed=7000005" in out and '"lanes": 2' in out
    assert "--seed 7000005 --trials 1 --device cpu (forced lanes=2)" in out


@pytest.mark.cuda
def test_cuda_ten_trials_at_a_one_byte_program_budget():
    """Every trial bit-exact with each device's program cache held to one
    program: every capture after the first evicts the one before."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    line = longfuzz.soak(longfuzz.BASE_SEED, "cuda", trials=10, forced=[{"budget": 1}] * 10, quiet=True)
    assert line["trials"] == 10 and line["bit_exact"]
    assert line["replay_program_evict"] >= line["replay_program_capture"] - 1
