"""The trace arithmetic on a synthetic Chrome trace: device busy union, idle
time by the host span open at the time, kernels tied to the span that
launched them."""

import json

import pytest

from rqbench.trace import Trace, gaps, length, union


def test_union_gaps():
    u = union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert u == [[0, 3], [5, 8]] and length(u) == 6
    assert gaps(u, -1, 10) == [[-1, 0], [3, 5], [8, 10]]


def _events():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "rq.window", "ts": 100.0, "dur": 100.0},
        {"ph": "X", "cat": "user_annotation", "name": "rq.load", "ts": 100.0, "dur": 40.0},
        {"ph": "X", "cat": "user_annotation", "name": "rq.generate", "ts": 150.0, "dur": 20.0},
        {"ph": "X", "cat": "user_annotation", "name": "rq.other_process", "ts": 0.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 152.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 160.0, "dur": 1.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 175.0, "dur": 1.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)", "ts": 153.0, "dur": 5.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gather_xor_kernel", "ts": 156.0, "dur": 10.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gf2_kernel", "ts": 170.0, "dur": 10.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gather_xor_kernel", "ts": 185.0, "dur": 30.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "before_window", "ts": 10.0, "dur": 5.0, "args": {"correlation": 9}},
    ]
    return ev


def test_trace_window_busy_idle_and_attribution(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    t = Trace.from_file(p)
    assert t.window_s == pytest.approx(100e-6)
    # busy: [153, 166) + [170, 180) + [185, 200) (cut at the window's end) = 13 + 10 + 15 us
    assert t.busy_s == pytest.approx(38e-6)
    spans = {(o.name, o.span) for o in t.ops}
    assert ("gather_xor_kernel", "generate") in spans and ("gf2_kernel", "generate") in spans
    assert ("gather_xor_kernel", "harness") in spans  # launched at 175, after the generate span
    assert all(o.name != "before_window" for o in t.ops)
    idle = t.idle_by_span()
    # idle: [100, 153) -> load 40, harness 10, generate 3; [166, 170) generate; [180, 185) harness
    assert idle["load"] == pytest.approx(40e-6)
    assert idle["generate"] == pytest.approx(7e-6)
    assert idle["harness"] == pytest.approx(15e-6)
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    top = dict(t.top_ops())
    assert top["gather_xor_kernel"] == pytest.approx(25e-6)


def test_trace_without_window_is_refused():
    with pytest.raises(ValueError):
        Trace([e for e in _events() if e["name"] != "rq.window"])
