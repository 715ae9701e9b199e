"""The program's own spans in a run: the per-layer readers of them on a
synthetic `Run`, `InnerTrace` on a synthetic Chrome trace (`Op.inner` across
nesting, threads and a CUDA-graph launch; `idle_by_inner` summing by
harness span to `idle_by_span`), the new entries of BENCHMARK.json, and a
window on the CPU whose every new reader reads a number."""

import pytest

from rqbench import harness, inside, run as runmod, traffic
from rqbench.trace import Trace

NEW = {"load_read_us.bulk", "load_alloc_ms.bulk", "enc_wait_ms.bulk", "ingest_status_ms.dec",
       "ingest_slab_ms.dec", "ingest_write_ms.dec", "repair_wait_ms.dec", "repair_host_ms.dec"}
CELLS = {"k1000.bulk_enc", "k50000.bulk_enc", "k1000.bulk_dec_fixed"}  # the benchmark's cells before these metrics


def _run(spans, program_spans, counters=None) -> harness.Run:
    run = harness.Run(cfg={}, mix={}, K=1, T=1, Z=1, n_repair=1, overhead=0)
    run.spans, run.program_spans, run.counters = spans, program_spans, counters or {}
    return run


def _sender():
    """Two objects: harness spans load / repair_symbols, program spans inside."""
    spans, prog = [], []
    for i, base in enumerate((0.0, 10.0)):
        spans += [("load", i, base, base + 5.0), ("repair_symbols", i, base + 6.0, base + 8.0)]
        s = 1.0 + i  # object 1's read is a second longer
        prog += [("load.alloc", "load_object", 1, base + 0.1, base + 0.6),
                 ("gc", "load.read", 1, base + 1.0, base + 1.5),
                 ("load.read", "load_object", 1, base + 0.6, base + 0.6 + s + 0.5),
                 ("load_object", None, 1, base + 0.05, base + 4.9),
                 ("fetch.wait", "fetch", 1, base + 7.0, base + 7.25 + 0.25 * i),
                 ("fetch", "repair_symbols", 1, base + 6.9, base + 7.9),
                 ("repair_symbols", None, 1, base + 6.1, base + 7.95)]
    prog.append(("load.read", None, 1, 50.0, 60.0))  # outside every harness span: no object's
    return _run(spans, prog, {"load_symbols": 4000})


def _receiver():
    spans, prog = [], []
    for i, base in enumerate((0.0, 10.0)):
        spans += [("ingest", i, base, base + 4.0), ("repair", i, base + 4.0, base + 9.0)]
        prog += [("ingest.status", "add_symbols", 1, base + 0.1, base + 0.4),
                 ("ingest.write", "add_symbols", 1, base + 0.4, base + 1.4),
                 ("gc", "ingest.slab", 1, base + 1.5, base + 1.6),
                 ("ingest.slab", "add_symbols", 1, base + 1.4, base + 1.9 + i),
                 ("ingest.status", "add_symbols", 1, base + 2.0 + i, base + 2.2 + i),
                 ("add_symbols", None, 1, base + 0.05, base + 3.9),
                 ("fetch.wait", "fetch", 1, base + 7.0, base + 7.5),
                 ("fetch", "repair.finish", 1, base + 6.9, base + 7.6),
                 ("repair.finish", "repair_block", 1, base + 6.8, base + 8.0),
                 ("repair_block", None, 1, base + 4.1, base + 8.9)]
    return _run(spans, prog)


def _read(name, run):
    return runmod.reader(name)(run)


def test_sender_readers():
    run = _sender()
    # load.read self: (1.5 - 0.5) + (2.5 - 0.5) s over 4000 symbols
    assert _read("load_read_us.bulk", run) == pytest.approx(1e6 * 3.0 / 4000)
    assert _read("load_alloc_ms.bulk", run) == pytest.approx(500.0)
    assert _read("enc_wait_ms.bulk", run) == pytest.approx(1e3 * (0.25 + 0.5) / 2)


def test_receiver_readers():
    run = _receiver()
    assert _read("ingest_status_ms.dec", run) == pytest.approx(500.0)
    assert _read("ingest_write_ms.dec", run) == pytest.approx(1000.0)
    assert _read("ingest_slab_ms.dec", run) == pytest.approx(1e3 * (0.4 + 1.4) / 2)  # the gc span left out
    assert _read("repair_wait_ms.dec", run) == pytest.approx(500.0)
    assert _read("repair_host_ms.dec", run) == pytest.approx(1e3 * (4.8 - 0.5))
    agree = inside.agreement(run)
    assert agree["add_symbols"]["ratio_median"] == pytest.approx(3.85 / 4.0)
    assert agree["repair_block"]["self_share_median"] == pytest.approx((4.8 - 1.2) / 4.8)


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    from nanorq_tpu_torch.utils import stats

    for make in (_sender, _receiver):
        run = make()
        run.program_spans = []  # a run in which the program recorded nothing
        assert all(_read(n, run) is None for n in NEW)
    run = _sender()
    del run.program_spans
    monkeypatch.delattr(stats, "take_spans")  # a program older than its spans
    assert all(_read(n, run) is None for n in NEW)


def test_new_entries_name_accepted_cells_that_report_what_they_move():
    spec = harness.load_spec()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in spec["end_to_end"]}
    new = [m for m in spec["per_layer"] if m["name"] in NEW]
    assert {m["name"] for m in new} == NEW and spec["per_layer"][-len(NEW):] == new
    for m in new:
        assert m["workloads"] and set(m["workloads"]) <= CELLS & e2e[m["moves"]]
        assert m["source"] == "program_span" and (harness.HERE / "metrics" / f"{m['name']}.py").is_file()


def _events():
    a = "user_annotation"
    return [
        {"ph": "X", "cat": a, "name": "rq.window", "ts": 100.0, "dur": 100.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "rq.load", "ts": 100.0, "dur": 40.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.load_object", "ts": 101.0, "dur": 38.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.load.alloc", "ts": 102.0, "dur": 8.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.load.read", "ts": 110.0, "dur": 28.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.gc", "ts": 120.0, "dur": 2.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "rq.generate", "ts": 150.0, "dur": 20.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.generate", "ts": 150.5, "dur": 19.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.generate.upload", "ts": 151.0, "dur": 2.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.generate.replay", "ts": 153.0, "dur": 16.0, "tid": 1},
        {"ph": "X", "cat": a, "name": "nrq.fetch", "ts": 158.0, "dur": 4.0, "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 152.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 160.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 175.0, "dur": 1.0, "tid": 1,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 160.0, "dur": 1.0, "tid": 2,
         "args": {"correlation": 4}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 153.0, "dur": 5.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gather_xor_kernel", "ts": 156.0, "dur": 10.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gf2_kernel", "ts": 170.0, "dur": 5.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gf2_kernel", "ts": 176.0, "dur": 4.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gather_xor_kernel", "ts": 185.0, "dur": 30.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)", "ts": 181.0, "dur": 2.0,
         "args": {"correlation": 4}},
    ]


def test_op_inner_across_nesting_threads_and_a_graph_launch():
    t = inside.InnerTrace(_events())
    base = Trace(_events())
    assert [(o.name, o.span, o.start, o.end) for o in t.ops] == [(o.name, o.span, o.start, o.end) for o in base.ops]
    inner = [(o.name, o.inner) for o in t.ops]
    assert inner == [("Memcpy HtoD (Pinned -> Device)", "generate.upload"), ("gather_xor_kernel", "generate.upload"),
                     ("gf2_kernel", "generate.replay"), ("gf2_kernel", "generate.replay"),  # both of one graph
                     ("gather_xor_kernel", None),  # launched between the program's spans
                     ("Memcpy DtoH (Device -> Pinned)", "fetch")]  # thread 2's own range


def test_innermost_pieces():
    got = inside.innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"), (6, 8, "d"), (12, 13, "e")])
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"), (6, 8, "d"), (8, 10, "a"), (12, 13, "e")]


def test_idle_by_inner_sums_by_harness_span_to_idle_by_span():
    t = inside.InnerTrace(_events())
    by_span, by_inner = t.idle_by_span(), t.idle_by_inner()
    assert by_span == Trace(_events()).idle_by_span()
    assert inside.by_prefix(by_inner) == pytest.approx(by_span)
    # idle [100, 153): load 100-101 alone, load_object 101-102 and 138-140 (its end at 139, then load alone),
    # alloc 102-110, read 110-120 and 122-138, gc 120-122; harness 140-150; generate 150-150.5 alone,
    # generate 150.5-151, upload 151-153
    assert by_inner["load"] == pytest.approx(2e-6)
    assert by_inner["load/load_object"] == pytest.approx(2e-6)
    assert by_inner["load/load.alloc"] == pytest.approx(8e-6)
    assert by_inner["load/load.read"] == pytest.approx(26e-6)
    assert by_inner["load/gc"] == pytest.approx(2e-6)
    assert by_inner["generate/generate.upload"] == pytest.approx(2e-6)
    assert by_inner["generate/generate.replay"] == pytest.approx(3e-6)  # 166-169 between the kernels


def test_a_cpu_window_reads_every_new_metric():
    small = {"K": 300, "T": 16, "Al": 8, "bulk_blocks": 5}
    spec = harness.load_spec()
    from nanorq_tpu_torch.utils import stats

    for mix_name, cell in (("bulk_enc", "k1000.bulk_enc"), ("bulk_dec_fixed", "k1000.bulk_dec_fixed")):
        mix = traffic.load(harness.HERE / "traffic" / f"{mix_name}.json")
        c = harness.Cell(small, dict(mix, warmup=1), 2**31 + 7, "cpu")
        c.make_pool()
        c.warm_up()
        with stats.traced():
            c.window(0.3)
        names = {m["name"] for m in runmod.metrics_for(spec, cell, True)} & NEW
        assert names and all(runmod.reader(n)(c.run) is not None for n in names), cell
        agree = inside.agreement(c.run)
        assert agree and all(0.8 < a["ratio_median"] <= 1.0 for a in agree.values())


def test_an_untraced_window_records_no_program_span():
    """A `--trace 0` window: no profiler, no `stats.traced()`, so the program's tracing stays off."""
    from nanorq_tpu_torch.utils import stats

    mix = traffic.load(harness.HERE / "traffic" / "bulk_dec_fixed.json")
    c = harness.Cell({"K": 300, "T": 16, "Al": 8, "bulk_blocks": 3}, dict(mix, warmup=1), 2**31 + 9, "cpu")
    c.make_pool()
    c.warm_up()
    stats.take_spans()
    c.window(0.2)
    assert c.run.objects and stats.take_spans() == []
    assert all(_read(n, c.run) is None for n in NEW)


def test_to_children_puts_idle_time_down_to_the_spans_under_a_public_call():
    by_span = {"load": 40e-6, "ingest": 10e-6, "harness": 5e-6}
    idle = {"load": 2e-6, "load/load_object": 10e-6, "load/load.read": 28e-6, "ingest/add_symbols": 10e-6,
            "harness": 5e-6}
    assert inside.by_prefix(idle) == pytest.approx(by_span)
    assert inside.to_children(idle, by_span) == pytest.approx({"load": 28 / 40, "ingest": 0.0})


def test_program_off_records_no_span_and_no_range_under_the_profiler(tmp_path):
    """`--program 0`: the traced run's profiler without the program's spans."""
    import gc
    import json

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.host import MemoryIO
    from nanorq_tpu_torch.utils import stats

    enc = Encoder(2 * 40 * 16, 16, Al=8, Z=2, device="cpu")
    data = MemoryIO(np.arange(2 * 40 * 16, dtype=np.uint32).astype(np.uint8))
    span = stats.span
    try:
        inside._program_off(stats)
        stats.take_spans()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tbatch.load_object(enc, data)
            gc.collect()
        assert stats.take_spans() == []
    finally:
        stats.span = span
        if stats._on_gc not in gc.callbacks:
            gc.callbacks.append(stats._on_gc)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert not [e for e in json.loads(path.read_text())["traceEvents"] if e.get("name", "").startswith("nrq.")]
    with profile(activities=[ProfilerActivity.CPU]):  # restored
        tbatch.load_object(enc, data)
    assert {sp[0] for sp in stats.take_spans()} >= {"load_object", "load.alloc", "load.read"}
