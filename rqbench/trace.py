"""What a `--trace 1` run reads off torch.profiler's trace of the window.

The harness opens a `record_function` range around the window ("rq.window")
and around each public call it times ("rq.load", "rq.generate", ...).  The
profiler's Chrome trace holds those ranges, the CUDA runtime calls that
launched device work, and the device operations themselves (kernels, copies,
fills), each device operation tied to its launch by a correlation id.  From
that:

- `Trace.ops`: every device operation inside the window, with the harness
  span that was open on the host when it was launched (a kernel of a CUDA
  graph is tied to the graph's launch);
- `busy_s`: the union of all device operations' intervals;
- `idle_by_span`: the device's idle time in the window, split by the harness
  span open on the host at the time ("harness" where none was).

Interval arithmetic (`union`, `length`) is copied from
nanorq_tpu_torch/tools/pipe_sweep.py as of commit 11c11aa, so that later
changes to the program's tools cannot move this yardstick.
"""

import bisect
import json
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "rq."


def union(spans) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def length(spans) -> float:
    return sum(b - a for a, b in spans)


def gaps(spans, lo: float, hi: float) -> list:
    """The complement of merged `spans` within [lo, hi)."""
    out, t = [], lo
    for a, b in spans:
        if a > t:
            out.append([t, min(a, hi)])
        t = max(t, b)
    if t < hi:
        out.append([t, hi])
    return [g for g in out if g[1] > g[0]]


@dataclass
class Op:
    name: str
    cat: str
    start: float  # us, the trace's clock
    end: float
    span: str  # the harness span open when it was launched


class Trace:
    """The window of one Chrome trace (times in microseconds)."""

    def __init__(self, events: list):
        spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
                 and e.get("ph") == "X"]
        win = [e for e in spans if e["name"] == PREFIX + "window"]
        if not win:
            raise ValueError("the trace holds no rq.window range")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])
        # the harness spans are not nested inside each other (the window aside)
        inner = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
                       for e in spans if e["name"] != PREFIX + "window")
        self.spans = inner
        self._starts = [s[0] for s in inner]
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = float(e["ts"])
        self.ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b <= self.lo or a >= self.hi:
                continue
            t = launch.get(e.get("args", {}).get("correlation"))
            self.ops.append(Op(e["name"], e["cat"], max(a, self.lo), min(b, self.hi),
                               "harness" if t is None else self.span_at(t)))

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc["traceEvents"] if isinstance(doc, dict) else doc)

    def span_at(self, t: float) -> str:
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t < self.spans[i][1]:
            return self.spans[i][2]
        return "harness"

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy(self, pick=lambda op: True) -> list:
        return union([(o.start, o.end) for o in self.ops if pick(o)])

    @property
    def busy_s(self) -> float:
        return length(self.busy()) / 1e6

    def idle_by_span(self) -> dict:
        """Seconds the device was idle, by the harness span open on the host."""
        out: dict = {}
        for g0, g1 in gaps(self.busy(), self.lo, self.hi):
            t = g0
            i = max(bisect.bisect_right(self._starts, g0) - 1, 0)
            while t < g1 and i < len(self.spans):
                a, b, name = self.spans[i]
                if b <= t:
                    i += 1
                    continue
                if a > t:  # the host between spans
                    cut = min(a, g1)
                    out["harness"] = out.get("harness", 0.0) + cut - t
                    t = cut
                    continue
                cut = min(b, g1)
                out[name] = out.get(name, 0.0) + cut - t
                t = cut
                i += 1
            if t < g1:
                out["harness"] = out.get("harness", 0.0) + g1 - t
        return {k: v / 1e6 for k, v in out.items()}

    def top_ops(self, n: int = 10) -> list:
        per: dict = {}
        for o in self.ops:
            per[o.name] = per.get(o.name, 0.0) + (o.end - o.start)
        return [[k, v / 1e6] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:n]]
