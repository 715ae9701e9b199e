"""The port's retuning sweeps (`nanorq_tpu_torch/tools/`: cb_probe,
slotfill_probe, bsweep, wb_probe, replay_stage_prof), the cold decode
block's profile (decprep_prof) and the main path's A/B tool (main_path_ab)
at a tiny size on the CPU: their lines, cb_probe's bit-identical C across chunk sizes (and its
refusal of a C that differs), and slotfill_probe's counts against the JAX
package's `tools/slotfill_probe.py` at the same K."""

import ast
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import (bsweep, cb_probe, decprep_prof, main_path_ab, replay_stage_prof, slotfill_probe,
                                    wb_probe)

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--T", "16", "--device", "cpu"]
PRINTED = ("device", "power_limit_w", "timing")


def _run(main, argv):
    """The tool's lines, returned and printed alike."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = main(argv)
    assert [json.loads(x) for x in out.getvalue().splitlines()] == lines
    return lines


def _timed(line):
    return line["ms"] > 0 and line["graph_ms"] is None and line["timing"] == "perf_counter" and line["device"] == "cpu"


def test_cb_probe_gives_one_c_across_chunk_sizes():
    lines = _run(cb_probe.main, ["300", "64", "128", "256", "--blocks", "2", "--iters", "1", *TINY])
    assert [ln["CB"] for ln in lines] == [64, 128, 256] and all(ln["C_equal"] and _timed(ln) for ln in lines)
    assert [ln["chunks"] for ln in lines] == [-(-lines[0]["chunks"] * 64 // cb) for cb in (64, 128, 256)]
    assert [ln["default_cb"] for ln in lines] == [False, False, True]


def test_cb_probe_refuses_a_c_that_differs(monkeypatch):
    """A replay that came out differently at the second CB is an error."""
    real = cb_probe.replay

    def off_at_128(arr, D):
        C = real(arr, D)
        if arr["CB"] == 128:
            C[3, 5] ^= 1
        return C

    monkeypatch.setattr(cb_probe, "replay", off_at_128)
    with pytest.raises(AssertionError, match="CB=128"):
        _run(cb_probe.main, ["300", "64", "128", "--blocks", "1", "--iters", "1", *TINY])


def _jax_slotfill(K: int) -> dict:
    """grid -> (slots, launches, segs, slots by width) as tools/slotfill_probe.py prints them."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    r = subprocess.run([sys.executable, str(REPO / "tools" / "slotfill_probe.py"), str(K)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got, lines = {}, r.stdout.splitlines()
    for head, widths in zip(lines[::2], lines[1::2]):
        m = re.match(rf"K={K} (\w+): slots (\d+) fill [\d.]+ launches (\d+) segs (\d+)", head)
        by_w = ast.literal_eval(widths.split("slots by width:", 1)[1].strip())
        got[m[1]] = (int(m[2]), int(m[3]), int(m[4]), {str(w): n for w, n in by_w.items()})
    return got


@pytest.mark.parametrize("K", [1000, 3000])
def test_slotfill_probe_counts_as_the_jax_tool(K):
    want = _jax_slotfill(K)
    lines = _run(slotfill_probe.main, [str(K)])
    got = {ln["grid"]: (ln["slots"], ln["launches"], ln["segs"], ln["slots_by_width"]) for ln in lines}
    assert set(want) == {"pow2", "hybrid64"} and set(got) == {"dense", "hybrid64", "pow2"}
    for grid in want:
        assert got[grid] == want[grid], grid
    assert [ln["default"] for ln in lines if ln["grid"] == "hybrid64"] == [True]
    from nanorq_tpu_torch.precode import device_schedule

    assert device_schedule.WIDTH_GRID == device_schedule._WQ_GRIDS["hybrid64"]  # put back


def test_bsweep_lines():
    lines = _run(bsweep.main, ["100", "1", "3", "--iters", "1", *TINY])
    assert [(ln["B"], ln["stage"]) for ln in lines] == [(1, "replay"), (1, "replay+lt"), (3, "replay"), (3, "replay+lt")]
    assert all(_timed(ln) and ln["t"] == 16 * ln["B"] and ln["gbps"] > 0 for ln in lines)


def test_sweeps_time_the_program_path_beside_the_eager_one():
    """bsweep's lines and replay_stage_prof's `full` carry `program_ms` (the
    replay through the schedule's program); null on the CPU, where nothing
    is captured, as `graph_ms` is."""
    for ln in _run(bsweep.main, ["100", "2", "--iters", "1", *TINY]):
        assert ln["program_ms"] is None and ln["program_gbps"] is None and ln["graph_ms"] is None
    stages = _run(replay_stage_prof.main, ["100", "1", "1", *TINY])[1:]
    assert all("program_ms" in ln and ln["program_ms"] is None for ln in stages)


def test_main_path_ab_steps():
    """The A/B tool's four steps at a tiny size: each call's seconds, and
    the memory fields null on the CPU (no device memory to read)."""
    argv = ["--device", "cpu", "--K", "10", "--T", "16", "--Z", "3", "--cli-bytes", "3000", "--encodes", "3",
            "--cli", "2", "--tag", "t"]
    lines = _run(main_path_ab.main, argv)
    assert [ln["step"] for ln in lines] == ["encode", "decode", "lanes4", "cli"]
    assert [len(ln["s"]) for ln in lines[:3]] == [3, 2, 4] and all(x > 0 for ln in lines[:3] for x in ln["s"])
    assert len(lines[3]["encode_s"]) == len(lines[3]["decode_s"]) == 2
    for ln in lines:
        assert ln["tag"] == "t" and ln["timing"] == "perf_counter" and set(PRINTED) <= set(ln)
        assert ln["allocated_GiB"] is None and ln["peak_GiB"] is None and ln["programs_MB"] is None


def test_wb_probe_forms_are_exact():
    lines = _run(wb_probe.main, ["300", "--bs", "1", "2", "--iters", "1", *TINY])
    forms = ("W", "W_stacked", "canonical", "own")
    assert [(ln["B"], ln["form"]) for ln in lines] == [(b, f) for b in (1, 2) for f in forms]
    assert all(ln["exact"] and _timed(ln) for ln in lines)
    assert all(ln["slots"] > 0 for ln in lines if ln["form"] in ("canonical", "own"))


def test_replay_stage_prof_stages():
    lines = _run(replay_stage_prof.main, ["300", "2", "1", *TINY])
    head, stages = lines[0], lines[1:]
    assert head["Kp"] == 301 and head["chunks"] == head["Lpad"] // head["CB"] and 0 <= head["range_fill"] <= 1
    assert [ln["stage"] for ln in stages] == ["full", "take_rows", "tri", "tri_gather", "tri_matmul", "bsel",
                                               "hdpc", "vinv", "wut", "mid", "out_sel", "lt"]
    assert all(_timed(ln) or ln["ms"] >= 0 for ln in stages) and all(set(PRINTED) <= set(ln) for ln in lines)


def test_replay_stages_compose_to_the_replay():
    """Stages 2-5 of the profile, once each in the replay's order from where
    `stages` leaves its buffers, give the replay's C: the profile times what
    the replay runs."""
    from nanorq_tpu_torch.codec.cache import encoder_schedule
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
    from nanorq_tpu_torch.ops.replay import device_arrays, replay

    P = params_init(300)
    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds, "cpu")
    D = torch.zeros((ds.M_pad, 32), dtype=torch.uint8)
    D[:300] = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (300, 32), dtype=np.uint8))
    plan = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, "cpu")
    C = replay(arr, D)
    st = replay_stage_prof.stages(arr, D, plan)
    for name in ("bsel", "hdpc", "vinv", "wut"):
        st[name]()
    assert torch.equal(st["out_sel"](), C) and torch.equal(st["full"](), C)
    assert torch.equal(st["lt"](), lt_combine(C, plan))


def test_decprep_prof_structured_columns():
    """A cold block's host prep and device steps at a small K through the
    structured path: every column timed for every pattern, the copy-in null
    where the replay runs eagerly (always, on the CPU)."""
    lines = _run(decprep_prof.main, ["300", "--patterns", "2", "--structured", *TINY])
    (ln,) = lines
    assert ln["plan"] == "structured" and ln["route"] == ["eager", "eager"] and set(PRINTED) <= set(ln)
    assert set(ln["ms"]) == set(decprep_prof.HOST + decprep_prof.DEVICE) and ln["ms"]["copy_in"] is None
    assert all(len(v) == 2 for v in ln["ms_all"].values())
    assert all(ln["ms"][c] > 0 for c in decprep_prof.HOST + decprep_prof.DEVICE if c != "copy_in")
    assert ln["host_ms"] == pytest.approx(sum(ln["ms"][c] for c in decprep_prof.HOST))
    assert ln["ingest_ms"] == min(ln["ingest_ms_all"]) > 0 and len(ln["ingest_ms_all"]) == 2


def test_decprep_prof_follows_the_decoders_path_selection():
    """Without --structured, a K at or below the dense-W limit times the
    host prep of its dense-W plan alone, as the JAX tool does."""
    (ln,) = _run(decprep_prof.main, ["300", "--patterns", "1", *TINY])
    assert ln["plan"] == "dense-W" and ln["device_ms"] is None and set(ln["ms"]) == set(decprep_prof.HOST)


def test_wb_probe_cold_patterns_through_the_structured_forms():
    """--cold: each fresh pattern once through the canonical schedule's
    program path, the canonical eager replay and its own layout's, every
    form's recovered rows the same; on the CPU the program path is eager."""
    lines = _run(wb_probe.main, ["300", "--cold", "2", *TINY])
    forms = ("canonical", "canonical_eager", "own_eager")
    assert [(ln["pattern"], ln["form"]) for ln in lines] == [(p, f) for p in (0, 1) for f in forms]
    assert all(ln["exact"] and ln["ms"] > 0 and ln["B"] == 1 and set(PRINTED) <= set(ln) for ln in lines)
    assert [ln["route"] for ln in lines if ln["form"] == "canonical"] == ["eager", "eager"]
    for p in (0, 1):
        sig = {ln["form"]: ln["sig"] for ln in lines if ln["pattern"] == p}
        assert sig["canonical"] == sig["canonical_eager"] != sig["own_eager"]
