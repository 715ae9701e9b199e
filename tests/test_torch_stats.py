"""The port's observability, `nanorq_tpu_torch.utils.stats`: counters and
timers always on; spans only while tracing is on (inside `stats.traced()`
or while a torch.profiler records), with their parents on each thread, a
bounded buffer, the span "gc", and under a profiler the ranges "nrq.<name>"
of its trace.  Then the span tree the codec records on the CPU for the
sender's `load_object` / `generate` / `repair_symbols` and the receiver's
`add_symbols` / `repair_block`, and the ingestion counters against the
statuses `add_symbols` returns."""

import gc
import json
import threading
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec.api import SYM_ADDED, SYM_DUP, SYM_ERR, SYM_IGN, Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.utils import stats

K, T, Z, N_REPAIR = 10, 16, 3, 8


@pytest.fixture(autouse=True)
def _empty_buffer():
    stats.take_spans()
    yield
    stats.take_spans()


def _pairs(spans) -> set:
    return {(n, p) for n, p, _, _, _ in spans if n != "gc"}


def _counters() -> dict:
    return dict(stats.snapshot()["counters"])


def _grew(before: dict, names) -> dict:
    after = _counters()
    return {n: after.get(n, 0) - before.get(n, 0) for n in names}


def test_counters_and_timers_keep_their_totals_with_tracing_off():
    stats.reset()
    stats.count("x")
    stats.count("x", 2)
    with stats.timer("t"):
        time.sleep(0.002)
    with stats.timer("t"):
        pass
    snap = stats.snapshot()
    assert snap["counters"]["x"] == 3
    assert snap["timers"]["t"]["count"] == 2 and snap["timers"]["t"]["total_s"] >= 0.002
    assert stats.take_spans() == []  # a timer is a span only while tracing is on
    stats.reset()
    assert stats.snapshot() == {"counters": {}, "timers": {}}


def test_off_span_is_one_shared_object_and_records_nothing():
    assert stats.span("a") is stats.span("b")
    with stats.span("a"):
        with stats.span("b"):
            gc.collect()
    assert stats.take_spans() == []
    with stats.traced():
        pass
    assert stats.span("a") is stats.span("b")  # off again after traced()


def test_on_records_nesting_and_parents_and_timers():
    with stats.traced():
        assert stats.span("a") is not stats.span("a")
        with stats.span("a"):
            with stats.span("b"):
                pass
            with stats.timer("t"):
                with stats.span("c"):
                    pass
        with stats.span("d"):
            pass
    spans = stats.take_spans()
    assert [s[0] for s in spans if s[0] != "gc"] == ["b", "c", "t", "a", "d"]  # in the order they closed
    assert _pairs(spans) == {("a", None), ("b", "a"), ("t", "a"), ("c", "t"), ("d", None)}
    at = {s[0]: s for s in spans}
    for child, parent in (("b", "a"), ("t", "a"), ("c", "t")):
        assert at[parent][3] <= at[child][3] <= at[child][4] <= at[parent][4]
    assert len({s[2] for s in spans}) == 1 and spans[0][2] == threading.get_ident()
    assert stats.take_spans() == []


def test_parents_are_kept_apart_on_two_threads():
    ready = threading.Barrier(2, timeout=30)

    def work(k):
        with stats.span(f"outer{k}"):
            ready.wait()  # both outer spans open at once
            with stats.span(f"inner{k}"):
                ready.wait()

    with stats.traced():
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    spans = stats.take_spans()
    assert _pairs(spans) == {("outer0", None), ("outer1", None), ("inner0", "outer0"), ("inner1", "outer1")}
    tid = {s[0]: s[2] for s in spans}
    assert tid["inner0"] == tid["outer0"] != tid["inner1"] == tid["outer1"]


def test_the_buffer_is_bounded_and_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(stats, "SPAN_CAP", 3)
    before = _counters()
    gc.disable()
    try:
        with stats.traced():
            for k in range(5):
                with stats.span(f"s{k}"):
                    pass
    finally:
        gc.enable()
    assert [s[0] for s in stats.take_spans()] == ["s0", "s1", "s2"]
    assert _grew(before, ["spans_dropped"]) == {"spans_dropped": 2}


def test_a_collection_is_a_span_under_the_span_open_on_its_thread():
    with stats.traced():
        with stats.span("work"):
            gc.collect()
    gcs = [s for s in stats.take_spans() if s[0] == "gc"]
    assert any(p == "work" and t0 <= t1 for _, p, _, t0, t1 in gcs)


def _encode(obj: np.ndarray):
    enc = Encoder(obj.size, T, Al=8, Z=Z, device="cpu")
    assert enc.num_blocks == Z and all(enc.block_symbols(b) == K for b in range(Z))
    b = tbatch.load_object(enc, MemoryIO(obj))
    tbatch.generate(b, "cpu")
    return enc, tbatch.repair_symbols(b, N_REPAIR, "cpu")


ENCODER_TREE = {("load_object", None), ("load.alloc", "load_object"), ("load.read", "load_object"),
                ("generate", None), ("generate.upload", "generate"), ("generate.replay", "generate"),
                ("repair_symbols", None), ("lt.combine", "repair_symbols"), ("fetch", "repair_symbols"),
                ("fetch.wait", "fetch")}


def test_the_sender_records_its_span_tree_and_counts_every_symbol_it_loads():
    obj = np.random.default_rng(1).integers(0, 256, Z * K * T, dtype=np.uint8)
    _encode(obj)  # the encoder schedule solved and cached first
    before = _counters()
    with stats.traced():
        _encode(obj)
    assert _pairs(stats.take_spans()) == ENCODER_TREE
    assert _grew(before, ["load_symbols"]) == {"load_symbols": Z * K}


def _packets(obj: np.ndarray, lost: int):
    """Per block: the source symbols but the first `lost`, then the repair
    symbols, as (payloads, tags)."""
    enc, rep = _encode(obj)
    src = obj.reshape(Z, K, T)
    out = []
    for b in range(Z):
        esis = list(range(lost, K)) + list(range(K, K + N_REPAIR))
        rows = np.concatenate([src[b, lost:], np.asarray(rep[b])])
        out.append((rows, [make_tag(b, e) for e in esis]))
    return enc, out


DECODER_TREE = {("add_symbols", None), ("ingest.status", "add_symbols"), ("ingest.write", "add_symbols"),
                ("ingest.slab", "add_symbols"), ("ingest.repair", "add_symbols"),
                ("repair_block", None), ("repair.prepare", "repair_block"), ("repair.plan", "repair_block"),
                ("repair.assemble", "repair_block"), ("host_stage", "repair.assemble"),
                ("repair.apply", "repair_block"), ("repair.finish", "repair_block"),
                ("fetch", "repair.finish"), ("fetch.wait", "fetch")}


def test_the_receiver_records_its_span_tree():
    obj = np.random.default_rng(2).integers(0, 256, Z * K * T, dtype=np.uint8)
    enc, packets = _packets(obj, lost=3)
    for warm in (False, True):  # the second decoder finds its plans cached: no solve under repair.plan
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
        out = np.zeros_like(obj)
        with stats.traced():
            for sbn, (rows, tags) in enumerate(packets):
                dec.add_symbols(rows, tags, MemoryIO(out))
                assert dec.repair_block(MemoryIO(out), sbn)
        spans = stats.take_spans()
        assert np.array_equal(out, obj)
        if warm:
            assert _pairs(spans) == DECODER_TREE
        else:
            assert _pairs(spans) >= DECODER_TREE and ("dec_solve", "repair.plan") in _pairs(spans)


def test_profiler_ranges_nest_as_the_span_tree(tmp_path):
    obj = np.random.default_rng(3).integers(0, 256, Z * K * T, dtype=np.uint8)
    _encode(obj)
    assert stats.span("x") is stats.span("y")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert stats.span("x") is not stats.span("y")  # a profiler that records turns tracing on
        _encode(obj)
    assert stats.span("x") is stats.span("y")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"][4:], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
              if e.get("ph") == "X" and e.get("name", "").startswith("nrq.")]
    names = {r[0] for r in ranges} - {"gc"}
    assert names == {n for n, _ in ENCODER_TREE}
    at = {r[0]: r for r in ranges}
    for child, parent in ENCODER_TREE:
        if parent is not None:
            assert at[parent][1] <= at[child][1] and at[child][2] <= at[parent][2], (child, parent)
    assert _pairs(stats.take_spans()) == ENCODER_TREE  # the buffer holds the same spans
    with profile(activities=[ProfilerActivity.CPU]) as prof:  # no span opened: no range
        np.zeros(4).sum()
    path2 = tmp_path / "none.json"
    prof.export_chrome_trace(str(path2))
    assert not [e for e in json.loads(path2.read_text())["traceEvents"] if e.get("name", "").startswith("nrq.")
                and e["name"] != "nrq.gc"]


def test_ingest_counters_equal_the_statuses_returned():
    obj = np.random.default_rng(4).integers(0, 256, Z * K * T, dtype=np.uint8)
    enc, packets = _packets(obj, lost=2)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
    io = MemoryIO(np.zeros_like(obj))
    rows0, tags0 = packets[0]
    rows1 = np.concatenate([obj.reshape(Z, K, T)[1, :2], packets[1][0]])
    tags1 = [make_tag(1, e) for e in range(2)] + packets[1][1]
    bursts = [
        (rows0[:4], tags0[:4]),  # new source symbols of an untouched block 0: the fast path
        (np.concatenate([rows0[2:6], rows0[3:4]]), tags0[2:6] + tags0[3:4]),  # seen before, new, repeated
        (rows1, tags1),  # block 1 whole: its repair symbols come after completion (IGN)
        (rows1[:3], tags1[:3]),  # block 1 complete: IGN
        (rows0[:2], [make_tag(Z + 1, 0), make_tag(0, dec.max_esi + 1)]),  # no such block, ESI too large: ERR
        (rows0[:2, :-1], tags0[:2]),  # malformed payloads: ERR
        (packets[2][0][:K - 2], packets[2][1][:K - 2]),  # the fast path again
    ]
    before = _counters()
    got = []
    for rows, tags in bursts:
        got += dec.add_symbols(rows, tags, io)
    want = {"ingest_symbols": len(got), "ingest_added": got.count(SYM_ADDED), "ingest_dup": got.count(SYM_DUP),
            "ingest_ign": got.count(SYM_IGN), "ingest_err": got.count(SYM_ERR), "ingest_fast": 2}
    assert all(v > 0 for v in want.values())
    assert _grew(before, want) == want
    before = _counters()
    st = [dec.add_symbol(rows0[k], tags0[k], io) for k in range(6)]
    assert _grew(before, ["ingest_symbols", "ingest_added", "ingest_dup"]) == {
        "ingest_symbols": 6, "ingest_added": st.count(SYM_ADDED), "ingest_dup": st.count(SYM_DUP)}
