"""The port's bench (`python -m nanorq_tpu_torch.bench`) on the CPU at a tiny
K: its lines and keys, the deadline path, the reference table against the
JAX package's bench, and its decode_e2e object against what the JAX package
encodes and decodes from the same seed (byte equality)."""

import ast
import io
import json
import math
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest

from nanorq_tpu.codec.api import Decoder as JDecoder
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu_torch import bench
from nanorq_tpu_torch.codec import cache
from nanorq_tpu_torch.codec.oti import make_tag

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--T", "16", "--iters", "1", "--blocks", "2"]


def _run(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = bench.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def tiny_run():
    cache.clear_encoder_cache()  # as in a fresh process: each K's schedules are built by the run
    return _run(TINY + ["--ks", "10", "12", "--arms"])


def test_bench_prints_one_line_per_k_then_the_summary(tiny_run):
    rc, lines = tiny_run
    assert rc == 0 and [ln.get("K") for ln in lines] == [10, 12, None]
    for ln in lines[:2]:
        assert ln["device"] == "cpu" and ln["power_limit_w"] is None and ln["timing"] == "perf_counter"
        assert set(bench.KEYS) <= set(ln) and ln["blocks"] == 2 and ln["partial"] is False
        assert ln["dec_plan"] in ("W", "structured") and isinstance(ln["e2e_auto_ok"], bool)
        for key in bench.KEYS:  # every cell ran: a finite number, or null where K is off the reference grid
            v = ln[key]
            assert (v is None and key in ("vs_ref", "fresh_vs_ref")) or isinstance(v, (bool, str)) or math.isfinite(v), key
        for key in ("encode", "encode_e2e", "decode_e2e", *(f"e2e_{a}" for a in bench.ARMS[1:])):
            assert ln[key + "_mbps"] == pytest.approx(ln[key] * 1e9 / 2**20)  # BASELINE.md's unit beside Gbps


def test_bench_lines_carry_the_program_counters(tiny_run):
    """Each K's line has the program counters; on the CPU nothing is
    captured, and each K's schedules count their signatures."""
    _, lines = tiny_run
    for ln in lines[:2]:
        assert set(bench.PROGRAM_KEYS) <= set(ln) and ln["capture_ms"] is None
        assert ln["replay_program_capture"] == 0 and ln["replay_program_replay"] == 0
        assert ln["replay_compile_new"] + ln["replay_compile_hit"] >= 1


def test_bench_summary_has_emit_s_shape(tiny_run):
    _, lines = tiny_run
    summary = lines[-1]
    assert {"metric", "value", "unit", "vs_baseline", "detail", "partial", "device", "power_limit_w"} <= set(summary)
    assert summary["unit"] == "Gbps" and summary["partial"] is False and sorted(summary["detail"]) == ["10", "12"]
    assert "K=10 T=16" in summary["metric"] and summary["value"] == pytest.approx(lines[0]["agg_e2e"], abs=1e-3)


def test_bench_runs_ks_in_its_own_order_and_arms_only_where_asked():
    rc, lines = _run(TINY + ["--ks", "100", "1000", "--no-pipe", "--deadline", "0"])
    assert rc == 0 and len(lines) == 1  # nothing starts, so the order is read from a run that does:
    rc, lines = _run(TINY + ["--ks", "12", "10"])
    assert [ln.get("K") for ln in lines] == [12, 10, None]  # off the grid: as given
    assert lines[0]["decode_e2e"] > 0 and lines[0]["e2e_host"] is None and lines[0]["e2e_auto_ok"] is None
    assert [k for k in bench.RUN_ORDER if k in (100, 1000, 50000)] == [1000, 50000, 100]
    assert sorted(bench.RUN_ORDER) == sorted(bench.GRID) == sorted(bench.REF_BASELINE)


def test_bench_mesh_adds_its_cells_and_only_when_asked(tiny_run):
    """`--mesh 3` on the CPU: three CPU lanes, the two mesh cells beside the
    unsharded ones (each behind its byte-equality gate); without it, no such key."""
    rc, lines = _run(TINY + ["--ks", "10", "--mesh", "3"])
    assert rc == 0 and [ln.get("K") for ln in lines] == [10, None]
    ln = lines[0]
    assert set(bench.KEYS) | set(bench.MESH_KEYS) <= set(ln) and ln["mesh_lanes"] == 3
    for key in ("encode_e2e_mesh", "e2e_device_mesh"):
        assert math.isfinite(ln[key]) and ln[key] > 0
        assert ln[key + "_mbps"] == pytest.approx(ln[key] * 1e9 / 2**20)
    assert ln["encode_e2e"] > 0 and ln["decode_e2e"] > 0 and ln["e2e_device"] is None  # arms only where asked
    assert not set(bench.MESH_KEYS) & set(tiny_run[1][0])


def test_bench_deadline_zero_prints_a_partial_summary():
    rc, lines = _run(TINY + ["--ks", "10", "--deadline", "0"])
    assert rc == 0 and len(lines) == 1
    assert lines[0]["partial"] is True and lines[0]["value"] is None and lines[0]["detail"] == {}
    assert "[PARTIAL]" in lines[0]["metric"]


def test_bench_deadline_inside_a_k_leaves_the_later_cells_null(monkeypatch):
    """A deadline that passes after the first cell: that K's line still comes,
    its later cells null, and the summary is partial with exit code 0."""
    real = bench.Clock.timed

    def timed_then_late(self, fn, iters):
        per = real(self, fn, iters)
        self.end = 0.0
        return per

    monkeypatch.setattr(bench.Clock, "timed", timed_then_late)
    rc, lines = _run(TINY + ["--ks", "10", "12"])
    assert rc == 0 and [ln.get("K") for ln in lines] == [10, None]
    assert lines[0]["encode_replay"] > 0 and lines[0]["solve_ms"] > 0 and lines[0]["partial"] is True
    assert all(lines[0][k] is None for k in ("encode", "encode_e2e", "decode", "decode0", "decode_e2e"))
    assert lines[1]["partial"] is True and list(lines[1]["detail"]) == ["10"]


def test_bench_does_not_swallow_an_exception(monkeypatch, capsys):
    """A failure inside the second K: the first K's line stands, the summary
    is partial, the traceback goes to stderr and the exit code is 1."""
    real = bench.bench_K

    def fails_at_12(K, *a, **kw):
        if K == 12:
            raise RuntimeError("cell failed")
        return real(K, *a, **kw)

    monkeypatch.setattr(bench, "bench_K", fails_at_12)
    rc = bench.main(TINY + ["--ks", "10", "12", "--no-pipe"])
    cap = capsys.readouterr()
    lines = [json.loads(line) for line in cap.out.splitlines()]
    assert rc == 1 and [ln.get("K") for ln in lines] == [10, None]
    assert lines[1]["partial"] is True and "RuntimeError: cell failed" in cap.err


def test_bench_short_regions_grow_or_null():
    """A region under the floor is repeated with more calls; a cell that
    cannot reach it in MAX_CALLS calls is null."""
    import torch

    clock = bench.Clock(torch.device("cpu"), 60.0)
    calls = []
    clock.floor_s = 2e-3
    per = clock.timed(lambda: calls.append(sum(range(2000))), 1)
    assert per is not None and len(calls) > 2 and 2e-3 <= per * (len(calls) - 2) < 1.0
    clock.floor_s = 1e9
    assert clock.timed(lambda: None, 1) is None and not clock.partial
    assert bench.Clock(torch.device("cpu"), 0.0).expired()


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--ks", "10"])


def test_ref_baseline_is_the_jax_bench_s():
    """REF_BASELINE and E2E_BLOCKS equal the root bench.py's, read from its
    source (importing it would set JAX environment variables)."""
    found = {}
    for node in ast.parse((REPO / "bench.py").read_text()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) in ("REF_BASELINE", "E2E_BLOCKS"):
            found[node.targets[0].id] = ast.literal_eval(node.value)
    assert found == {"REF_BASELINE": bench.REF_BASELINE, "E2E_BLOCKS": bench.E2E_BLOCKS}
    assert bench.default_blocks(1000, 1280) == 209 and bench.default_blocks(100, 1280) == 256
    assert bench.default_blocks(50000, 1280) == 4 and bench.default_blocks(10**6, 1280) == 1


def test_decode_e2e_object_is_what_the_jax_package_makes_and_decodes():
    """At K = 10 the bench's decode_e2e object -- data, loss patterns and
    repair payloads from seed 7 -- equals what the JAX package encodes by the
    root bench.py's recipe (bench.py:158-170), the JAX decoder restores it,
    and the bench's own run through every arm restores it too."""
    K, T, nb = 10, 16, 6
    data, enc, per_block = bench.e2e_object(K, T, nb, "cpu")
    rng = np.random.default_rng(7)
    jdata = rng.integers(0, 256, K * T * nb, dtype=np.uint8)
    assert np.array_equal(data, jdata)
    jenc = JEncoder(jdata.size, T, Al=8, Z=nb)
    assert (jenc.oti_common(), jenc.oti_scheme_specific()) == (enc.oti_common(), enc.oti_scheme_specific())
    jdec = JDecoder(jenc.oti_common(), jenc.oti_scheme_specific())
    out = np.zeros(jdata.size, np.uint8)
    jio = JMemoryIO(out)
    lost = 0
    for sbn, (keep, rep_esis, rep_pl) in enumerate(per_block):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        nrep = gaps.size + max(1, int(0.05 * K))
        assert np.array_equal(keep, np.setdiff1d(np.arange(K), gaps)) and np.array_equal(rep_esis, np.arange(K, K + nrep))
        assert np.array_equal(rep_pl, jenc.encode_batch(sbn, rep_esis, JMemoryIO(jdata)))
        jdec.add_symbols(jdata.reshape(nb * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], jio)
        jdec.add_symbols(rep_pl, [make_tag(sbn, int(e)) for e in rep_esis], jio)
        lost += gaps.size
    assert lost and jdec.repair_all(jio) and np.array_equal(out, jdata)
    import torch

    secs, spread, ingest_ms = bench.bench_decode_e2e(K, T, nb, 3, torch.device("cpu"),
                                                     bench.Clock(torch.device("cpu"), 60.0),
                                                     arms=bench.ARMS)  # asserts byte equality per arm and round
    assert sorted(secs) == sorted(bench.ARMS) and all(0 < s < 60 for s in secs.values()) and ingest_ms > 0
    assert sorted(spread) == sorted(bench.ARMS) and all(s >= 0 for s in spread.values())


def test_arms_emit_a_spread_beside_each_median(tiny_run):
    """An `--arms` run reads every arm cold and warm in rounds and prints,
    beside each median, its spread: (slowest - fastest) / median."""
    _, lines = tiny_run
    for ln in lines[:2]:
        for arm in bench.ARMS:
            for state in ("", "_warm"):
                v = ln[f"e2e_{arm}{state}_spread"]
                assert isinstance(v, float) and math.isfinite(v) and v >= 0, (arm, state)


def test_auto_ok_decides_on_the_medians(monkeypatch):
    """A clock that returns fixed round times: "auto" has the fastest single
    round (1 s against host's 2 s) but a median of 5 s, so it is not within
    10% of the best arm; with the round times swapped it is.  The medians and
    spreads are those of the rounds, whichever arm a round starts with."""
    import torch

    def clock_of(times):
        seq = iter(times)

        def wall(self, fn):
            fn()
            return next(seq)

        monkeypatch.setattr(bench.Clock, "wall", wall)
        return bench.Clock(torch.device("cpu"), 60.0)

    K, T, nb = 10, 16, 2
    rounds = [(1.0, 2.0), (5.0, 2.0), (5.0, 2.1), (6.0, 1.9), (5.0, 2.0)]  # (auto, host) per round
    # each round starts one arm later: auto first in rounds 0, 2, 4, host first in 1, 3
    clock = clock_of([x for r, (a, h) in enumerate(rounds) for x in ((a, h) if r % 2 == 0 else (h, a))])
    secs, spread, _ = bench.bench_decode_e2e(K, T, nb, 5, torch.device("cpu"), clock, arms=("auto", "host"))
    assert secs == {"auto": 5.0, "host": 2.0}
    assert spread == pytest.approx({"auto": (6.0 - 1.0) / 5.0, "host": (2.1 - 1.9) / 2.0})
    assert not bench._auto_ok(K, "cold", secs, K * T * nb)
    clock = clock_of([x for r, (a, h) in enumerate(rounds) for x in ((h, a) if r % 2 == 0 else (a, h))])
    secs, _, _ = bench.bench_decode_e2e(K, T, nb, 5, torch.device("cpu"), clock, arms=("auto", "host"))
    assert secs == {"auto": 2.0, "host": 5.0} and bench._auto_ok(K, "cold", secs, K * T * nb)
