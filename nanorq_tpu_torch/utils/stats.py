"""Lightweight counters/timers for codec observability.

The reference's observability is printf-only (SURVEY.md s5); here a small
process-wide registry counts the events that matter operationally (solves,
cache hits, decode failures, bytes moved) and times host phases.  Zero
dependencies, negligible overhead, queryable via snapshot()/report().
"""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_lock = threading.Lock()
_counters: dict[str, int] = defaultdict(int)
_timers: dict[str, list] = defaultdict(lambda: [0, 0.0])  # [count, total_s]


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


@contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
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


def report() -> str:
    s = snapshot()
    lines = [f"{k} = {v}" for k, v in sorted(s["counters"].items())]
    lines += [
        f"{k}: n={v['count']} total={v['total_s']:.3f}s avg={v['total_s']/max(1,v['count'])*1e3:.2f}ms"
        for k, v in sorted(s["timers"].items())
    ]
    return "\n".join(lines)
