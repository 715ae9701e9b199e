"""Counters, timers and spans: the port's observability.

- Counters (`count`) and timers (`timer`, a cumulative total of host
  seconds) are process-wide and always on; `snapshot()` reads them.
- Spans (`span`) mark where the host's time goes, at each layer boundary of
  the codec.  They record only while tracing is on: inside `traced()`, or
  while a torch.profiler records.  Then each closed span is kept as
  (name, parent, thread, t0, t1) on `time.perf_counter` (parent: the name of
  the span open around it on the same thread, or None), in a buffer of at
  most `SPAN_CAP` spans (counter "spans_dropped" counts the rest) that
  `take_spans()` hands over; each garbage collection is a span "gc"; and,
  under a profiler, each span is also the range "nrq.<name>" of its trace,
  on the clock of the device's kernels and copies.  While tracing is off,
  `span` returns one shared object that does nothing: one flag check, no
  lock, no clock.
- A timer is a span as well while tracing is on.
- A profiler turns tracing on because the benchmark's traced runs
  (`rqbench`) open one and have no other switch into the program yet.  So a
  tool that profiles holds the spans of its profiled runs until
  `take_spans()` (at most `SPAN_CAP`), and its sums over a profile's device
  events skip the ranges (`is_range`).
"""

import gc
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _aprof

SPAN_CAP = 1 << 20
# a span's profiler range is named RANGE + its name.  Under CUDA activity the
# trace also holds each range as an annotation of the device's timeline, an
# event of the CUDA device type by that name
RANGE = "nrq."
# the C++ form of record_function: a tenth of its cost
_range = torch._C._profiler._RecordFunctionFast

# re-entrant: a collection, and so the span "gc", can start while this thread holds it
_lock = threading.RLock()
_counters: dict[str, int] = defaultdict(int)
_timers: dict[str, list] = defaultdict(lambda: [0, 0.0])  # [count, total_s]
_on = False  # inside traced()
_spans: list = []
_tls = threading.local()  # .stack: names of the spans open on this thread; .gc: an open collection


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


@contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            rec = _timers[name]
            rec[0] += 1
            rec[1] += dt


def snapshot() -> dict:
    with _lock:
        return {
            "counters": dict(_counters),
            "timers": {k: {"count": v[0], "total_s": round(v[1], 6)} for k, v in _timers.items()},
        }


def reset() -> None:
    with _lock:
        _counters.clear()
        _timers.clear()


def is_range(name: str) -> bool:
    """Whether a profiler event of this name is a span's range (on the host,
    or its annotation of the device's timeline), not an operation."""
    return name.startswith(RANGE)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _keep(rec: tuple) -> None:
    with _lock:
        if len(_spans) < SPAN_CAP:
            _spans.append(rec)
        else:
            _counters["spans_dropped"] += 1


class _Span:
    __slots__ = ("name", "parent", "t0", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # the clock is read outside the profiler's range, so that a span's
        # time holds what tracing it costs, and its parent's does not
        self.t0 = time.perf_counter()
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self.name)
        self.rf = None
        if _aprof._is_profiler_enabled:
            self.rf = _range(RANGE + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        t1 = time.perf_counter()
        _keep((self.name, self.parent, threading.get_ident(), self.t0, t1))
        return False


def span(name: str):
    """A context manager that records the time inside it as the span `name`
    while tracing is on (the module docstring), and does nothing else."""
    if not (_on or _aprof._is_profiler_enabled):
        return _OFF
    return _Span(name)


@contextmanager
def traced():
    """Tracing on inside, from an empty buffer; `take_spans()` reads it."""
    global _on
    prev = _on
    take_spans()
    _on = True
    try:
        yield
    finally:
        _on = prev


def take_spans() -> list:
    """The spans recorded since the last call, in the order they closed (a
    child before its parent); the buffer is left empty."""
    global _spans
    with _lock:
        out, _spans = _spans, []
    return out


def _on_gc(phase: str, info: dict) -> None:
    """A collection is the span "gc" of the thread it runs on, a child of
    the span open there."""
    if phase == "start":
        if _on or _aprof._is_profiler_enabled:
            st = _stack()
            rf = None
            if _aprof._is_profiler_enabled:
                rf = _range(RANGE + "gc")
                rf.__enter__()
            _tls.gc = (st[-1] if st else None, rf, time.perf_counter())
        return
    opened = getattr(_tls, "gc", None)
    if opened is not None:
        t1 = time.perf_counter()
        _tls.gc = None
        parent, rf, t0 = opened
        if rf is not None:
            rf.__exit__(None, None, None)
        _keep(("gc", parent, threading.get_ident(), t0, t1))


gc.callbacks.append(_on_gc)
