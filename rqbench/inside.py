"""What the program's own spans say about a run: inside the harness's spans.

The program (`nanorq_tpu_torch.utils.stats`) records its spans while a
torch.profiler records, so in a `--trace 1` run, and inside
`stats.traced()`: (name, parent, thread, t0, t1) on `time.perf_counter`, the
clock of the harness's own spans (`Run.spans`).  A program span belongs to
the object of the harness span that encloses it.  Under the profiler each
program span is also the range "nrq.<name>" of the trace, which
`InnerTrace` reads beside the harness's "rq." ranges.

- `program_spans(run)`: the window's program spans, taken from the program
  once and kept on the run; None where the program records none (an older
  program, or a run with no tracing);
- `median_ms`, `self_s`, `total_s`: the readers' sums (self time: a
  span's time less its child spans');
- `InnerTrace`: `trace.Trace` whose device operations also name the
  innermost program range open on the launching thread (`Op.inner`), and
  whose `idle_by_inner()` splits each idle gap by the harness span and the
  innermost program range open on the host ("<harness span>/<program
  span>", the harness span alone where none was);
- `python3 -m rqbench.inside --workload <cell> --seed <n> --seconds <s>
  [--trace 0|1] [--program 0|1]`: one run of a cell with the harness as
  run.py drives it, printing one JSON line with the rate, the per-layer
  metrics, the idle split by program span and how far the program's spans
  agree with the harness's.  `--program 0` keeps the program's tracing off
  (under the profiler too), `--trace 0 --program 1` turns it on through
  `stats.traced()` with no profiler: the four runs give what the spans cost,
  with and without their profiler ranges.

While `Op.inner` is not in `trace.py`, `InnerTrace` reads the device
operations a second time, after `Trace` has, to name their launches.
"""

import bisect
import gc
import statistics
from dataclasses import dataclass

from rqbench.trace import DEVICE_CATS, PREFIX, Op, Trace, gaps

INNER = "nrq."
# the harness span and the program span around the same public call
SAME_CALL = {"load": "load_object", "ingest": "add_symbols", "repair": "repair_block"}


def program_spans(run):
    got = getattr(run, "program_spans", None)
    if got is None:
        try:
            from nanorq_tpu_torch.utils import stats
        except ImportError:
            return None
        take = getattr(stats, "take_spans", None)
        if take is None:
            return None
        got = run.program_spans = take()
    return got or None


def by_harness_span(run) -> dict:
    """{(object, harness span): [program spans inside it]}, kept on the run."""
    got = getattr(run, "_inside", None)
    if got is not None:
        return got
    spans = program_spans(run) or []
    hs = sorted((t0, t1, name, i) for name, i, t0, t1 in run.spans)
    starts = [h[0] for h in hs]
    out: dict = {}
    for sp in spans:
        k = bisect.bisect_right(starts, sp[3]) - 1
        if k >= 0 and sp[4] <= hs[k][1]:
            out.setdefault((hs[k][3], hs[k][2]), []).append(sp)
    run._inside = out
    return out


def self_s(spans, name: str) -> float:
    """Seconds in the spans `name` less those in their children."""
    return (sum(t1 - t0 for n, _, _, t0, t1 in spans if n == name)
            - sum(t1 - t0 for n, p, _, t0, t1 in spans if p == name))


def total_s(spans, name: str) -> float:
    return sum(t1 - t0 for n, _, _, t0, t1 in spans if n == name)


def median_ms(run, harness_span: str, value, need: str):
    """The median over the window's objects that have the harness span of
    value(the program spans inside it), in ms; None where no program span
    `need` was recorded under that harness span."""
    groups = by_harness_span(run)
    if not any(sp[0] == need for (_, h), sps in groups.items() if h == harness_span for sp in sps):
        return None
    objs = sorted({i for n, i, _, _ in run.spans if n == harness_span})
    return statistics.median([1e3 * value(groups.get((i, harness_span), [])) for i in objs])


# --- the program's ranges on the trace's clock ------------------------------


def innermost(ranges) -> list:
    """Nested ranges [(start, end, name)] of one thread as sorted, disjoint
    pieces [(start, end, name)], each named by the innermost range open
    there; where none is open there is no piece."""
    out, stack, t = [], [], None
    for a, b, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][1] <= a:
            _, e, n = stack.pop()
            if e > t:
                out.append((t, e, n))
                t = e
        if stack and a > t:
            out.append((t, a, stack[-1][2]))
        stack.append((a, b, name))
        t = a
    while stack:
        _, e, n = stack.pop()
        if e > t:
            out.append((t, e, n))
            t = e
    return out


class _Pieces:
    def __init__(self, pieces):
        self.pieces = pieces
        self.starts = [p[0] for p in pieces]

    def at(self, t: float):
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and self.pieces[k][0] <= t < self.pieces[k][1]:
            return self.pieces[k][2]
        return None

    def split(self, lo: float, hi: float):
        """[(start, end, name or None)] covering [lo, hi)."""
        out, t = [], lo
        k = max(bisect.bisect_right(self.starts, lo) - 1, 0)
        while t < hi and k < len(self.pieces):
            a, b, name = self.pieces[k]
            if b <= t:
                k += 1
                continue
            if a > t:
                cut = min(a, hi)
                out.append((t, cut, None))
                t = cut
                continue
            cut = min(b, hi)
            out.append((t, cut, name))
            t = cut
            k += 1
        if t < hi:
            out.append((t, hi, None))
        return out


@dataclass
class InnerOp(Op):
    inner: str | None = None  # the innermost program range open on the launching thread


class InnerTrace(Trace):
    """`Trace` with the program's "nrq." ranges: `ops` are `InnerOp`s."""

    def __init__(self, events: list):
        super().__init__(events)
        ranges: dict = {}
        win_tid = None
        for e in events:
            if e.get("cat") not in ("user_annotation", "cpu_op") or e.get("ph") != "X":
                continue
            name = e.get("name", "")
            if name.startswith(INNER):
                a = float(e["ts"])
                ranges.setdefault(e.get("tid"), []).append((a, a + float(e["dur"]), name[len(INNER):]))
            elif name == PREFIX + "window":
                win_tid = e.get("tid")
        self.inner = {tid: _Pieces(innermost(r)) for tid, r in ranges.items()}
        self.host = self.inner.get(win_tid, _Pieces([]))  # the thread that runs the window
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
        ops = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = float(e["ts"])
            b = a + float(e.get("dur", 0.0))
            if b <= self.lo or a >= self.hi:
                continue
            got = launch.get(e.get("args", {}).get("correlation"))
            if got is None:
                span, inner = "harness", None
            else:
                span, pieces = self.span_at(got[0]), self.inner.get(got[1])
                inner = None if pieces is None else pieces.at(got[0])
            ops.append(InnerOp(e["name"], e["cat"], max(a, self.lo), min(b, self.hi), span, inner))
        self.ops = ops

    @classmethod
    def from_profile(cls, prof) -> "InnerTrace":
        import os
        import tempfile

        fd, path = tempfile.mkstemp(suffix=".json", prefix="rqbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return cls.from_file(path)
        finally:
            os.unlink(path)

    def idle_by_inner(self) -> dict:
        """Seconds the device was idle, by "<harness span>/<program span>":
        `idle_by_span`'s split, each piece split again by the innermost
        program range open on the window's thread."""
        out: dict = {}

        def put(name, lo, hi):
            for a, b, inner in self.host.split(lo, hi):
                key = name if inner is None else f"{name}/{inner}"
                out[key] = out.get(key, 0.0) + b - a

        for g0, g1 in gaps(self.busy(), self.lo, self.hi):
            t = g0
            i = max(bisect.bisect_right(self._starts, g0) - 1, 0)
            while t < g1 and i < len(self.spans):
                a, b, name = self.spans[i]
                if b <= t:
                    i += 1
                    continue
                if a > t:
                    cut = min(a, g1)
                    put("harness", t, cut)
                    t = cut
                    continue
                cut = min(b, g1)
                put(name, t, cut)
                t = cut
                i += 1
            if t < g1:
                put("harness", t, g1)
        return {k: v / 1e6 for k, v in out.items()}


def to_children(idle: dict, by_span: dict) -> dict:
    """For each public call's harness span, the share of its idle time put
    down to a program span under the call's own (not to the call's span
    itself, nor to no program span)."""
    return {h: sum(v for k, v in idle.items() if k.startswith(h + "/") and k != f"{h}/{p}") / by_span[h]
            for h, p in SAME_CALL.items() if by_span.get(h)}


def by_prefix(idle: dict) -> dict:
    """`idle_by_inner`'s seconds summed by harness span."""
    out: dict = {}
    for k, v in idle.items():
        h = k.split("/", 1)[0]
        out[h] = out.get(h, 0.0) + v
    return out


# --- one run, with the split ---------------------------------------------------


def agreement(run) -> dict:
    """For each public call, over the window's objects: the median of
    (program span / harness span) per object, and of the program span's
    self time / its time."""
    out = {}
    groups = by_harness_span(run)
    for h, p in SAME_CALL.items():
        objs = sorted({i for n, i, _, _ in run.spans if n == h})
        ratio, own = [], []
        for i in objs:
            sps = groups.get((i, h), [])
            hs = sum(t1 - t0 for n, j, t0, t1 in run.spans if n == h and j == i)
            ps = total_s(sps, p)
            if hs > 0 and ps > 0:
                ratio.append(ps / hs)
                own.append(self_s(sps, p) / ps)
        if ratio:
            out[p] = {"harness_span": h, "objects": len(ratio), "ratio_median": statistics.median(ratio),
                      "ratio_min": min(ratio), "ratio_max": max(ratio), "self_share_median": statistics.median(own),
                      "self_share_max": max(own)}
    return out


def _program_off(stats) -> None:
    """The program's tracing kept off under the profiler too: every span the
    shared no-op, no span "gc" (for what tracing costs in a traced run)."""
    stats.span = lambda name: stats._OFF
    gc.callbacks.remove(stats._on_gc)


def _read(name: str, run):
    from rqbench import run as runmod

    try:
        return runmod.reader(name)(run)
    except Exception:  # a reader of the trace, in a run without one
        return None


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    import time
    from contextlib import nullcontext
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="one run of a cell, with the program's spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1,
                    help="the program's tracing: 1 as a --trace 1 run of the benchmark has it, and with --trace 0 "
                         "on through stats.traced(); 0 off, under the profiler too")
    args = ap.parse_args(argv)

    import torch

    from rqbench import harness, run as runmod
    from nanorq_tpu_torch.utils import stats

    spec = harness.load_spec(root)
    w, cfg, mix = harness.cell_files(spec, args.workload, root)
    if not torch.cuda.is_available():
        print("rqbench.inside: torch sees no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if not args.program:
        _program_off(stats)
    harness._read_trace = InnerTrace.from_profile
    cell = harness.Cell(cfg, mix, args.seed, dev, trace=bool(args.trace))
    cell.make_pool()
    cell.warm_up()
    setup_s = time.perf_counter() - t_start
    with stats.traced() if args.program and not args.trace else nullcontext():
        cell.window(args.seconds)
    run = cell.run
    run.setup_s = setup_s
    run.program_spans = stats.take_spans()
    cell.release()
    checks = cell.check()
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace, "program": args.program,
           "objects": len(run.objects), "window_s": run.window_s, "setup_s": setup_s,
           "device": torch.cuda.get_device_name(dev), "correct": cell.verdict(checks),
           "checks": {k: v for k, (v, _) in checks.items()}}
    names = [m["name"] for m in runmod.metrics_for(spec, args.workload, False)]
    names += [m["name"] for m in runmod.metrics_for(spec, args.workload, True)]
    out["metrics"] = {n: _read(n, run) for n in names}
    out["program_spans"] = len(run.program_spans)
    out["spans_dropped"] = stats.snapshot()["counters"].get("spans_dropped", 0)
    out["counters"] = run.counters
    out["agreement"] = agreement(run)
    if run.trace is not None:
        t = run.trace
        out["busy_s"] = t.busy_s
        by_span = t.idle_by_span()
        inner = t.idle_by_inner()
        out["idle_by_span"] = by_span
        out["idle_by_inner"] = sorted(([k, v] for k, v in inner.items()), key=lambda kv: -kv[1])[:40]
        out["idle_prefix_error"] = max(abs(v - by_span.get(k, 0.0)) / max(by_span.get(k, 0.0), 1e-12)
                                       for k, v in by_prefix(inner).items())
        out["idle_to_child"] = to_children(inner, by_span)
        kern: dict = {}
        for o in t.ops:
            key = f"{o.span}/{o.inner}"
            kern[key] = kern.get(key, 0.0) + (o.end - o.start) / 1e6
        out["device_s_by_inner"] = sorted(([k, v] for k, v in kern.items()), key=lambda kv: -kv[1])[:20]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
