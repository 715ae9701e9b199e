"""The port's ASan round trips (`nanorq_tpu_torch/tools/asan_drive.py`) without
the sanitizer, and its host-arm profiler (`tools/hostarm_prof.py`) at a
tiny size on the CPU: every column of every arm, the device arm alone over
both dense-W plan kinds, the first decoder's one-shot fields, a K outside
the JAX tool's block table, and the errors where the native library is
missing."""

import contextlib
import io
import json

import pytest
import torch

from nanorq_tpu_torch.codec.api import Decoder
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.tools import asan_drive, hostarm_prof

needs_native = pytest.mark.skipif(not native_available(), reason="the native host arms need the native library")


@needs_native
@pytest.mark.parametrize("case", [asan_drive.CASES[0], asan_drive.CASES[4]], ids=["host", "res_host"])
def test_asan_drive_round_trips(case):
    got = asan_drive.drive(*case)
    assert got["backend"] == case[5] and got["K"] == case[0] and not got["pinned"]


def _run(argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = hostarm_prof.main(argv)
    assert [json.loads(x) for x in out.getvalue().splitlines()] == lines
    return lines


TINY = ["--iters", "1", "--T", "16", "--device", "cpu"]


@needs_native
def test_hostarm_prof_gives_every_column_of_every_arm():
    lines = _run(["30", "37", "--blocks", "2", *TINY])
    assert 37 not in hostarm_prof.BLOCKS
    assert [(ln["K"], ln["arm"]) for ln in lines] == [(K, arm) for K in (30, 37) for arm in hostarm_prof.ARMS]
    for ln in lines:
        assert ln["blocks"] == 2 and ln["device"] == "cpu" and ln["timing"] == "perf_counter"
        for state in ("cold", "warm"):
            run = ln[state]
            assert set(run) == set(hostarm_prof.COLUMNS[ln["arm"]]), (ln["arm"], state)
            assert all(run[c] is not None for c in run if c != "busy_share") and run["total_ms"] > 0
            assert run["ingest_ms"] > 0
            if ln["arm"] == "device":
                assert run["busy_share"] is None  # no card: no device time
                assert run["apply_ms"] == pytest.approx(sum(run["apply_ms_by_kind"].values()))
            else:
                assert run["batch_ms"] == pytest.approx(run["native_ms"] + run["py_build_ms"])
                assert run["total_ms"] >= run["prep_ms"] + run["batch_ms"]
            if ln["arm"] == "host":
                assert set(run["native_split"]) == set(hostarm_prof.STAGES)
    assert {ln["plan"] for ln in lines if ln["arm"] == "device"} == {"dense-W"}


@needs_native
def test_hostarm_prof_device_arm_and_first_decoder():
    """`--arms device` alone restores the object (the tool raises where it
    does not) through a GF(256) plan (K = 30) and a GF(2) one (K = 700), with
    every column; each line has the first decoder's ingestion and cold
    decode and the bytes its slabs hold."""
    lines = _run(["30", "700", "--blocks", "2", "--arms", "device", *TINY])
    kinds = set()
    for ln in lines:
        assert ln["arm"] == "device" and ln["plan"] == "dense-W"
        assert ln["ingest_first_ms"] > 0 and ln["decode_first_ms"] > 0 and ln["host_memory_kept"] is None
        assert ln["ingest_bytes"] == ln["pinned_bytes"] == 2 * ln["K"] * 16  # both blocks' rows
        assert ln["registered_kept"] == 0  # nothing is page-locked on the CPU
        for state in ("cold", "warm"):
            run = ln[state]
            assert set(run) == set(hostarm_prof.COLUMNS["device"]) and run["ingest_ms"] > 0
            assert run["stage_ms"] >= 0 and run["upload_ms"] > 0
            kinds |= set(run["apply_ms_by_kind"])
    assert kinds == {"gf2", "gf256"}


@needs_native
def test_hostarm_prof_computes_the_blocks_of_a_k_outside_the_table():
    (host, *_) = _run(["37", *TINY])
    assert host["blocks"] == hostarm_prof.blocks_for(37, 16) == 128
    assert [hostarm_prof.blocks_for(K, 1280) for K in (1000, 5000, 10000, 50000)] == [64, 16, 8, 2]
    assert all(hostarm_prof.blocks_for(K, 1280) == 1 << (hostarm_prof.blocks_for(K, 1280).bit_length() - 1)
               for K in range(50, 60000, 997))


def test_hostarm_prof_raises_without_the_native_library(monkeypatch):
    monkeypatch.setattr(hostarm_prof, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native library"):
        hostarm_prof.main(["30", "--blocks", "1", *TINY])


@needs_native
def test_hostarm_prof_names_a_missing_native_call(monkeypatch):
    """A host arm whose native call finds no library says so, rather than
    unpacking the None it returns."""
    obj = hostarm_prof._Object(30, 16, 1, torch.device("cpu"))
    monkeypatch.setattr(Decoder, "_repair_host_batch", lambda self, work, io=None: None)
    with pytest.raises(RuntimeError, match="native library"):
        hostarm_prof._host_run(obj, "host")
