"""What the metric readers (`rqbench/metrics/<name>.py`) share.  A reader
takes a `harness.Run` and returns a number, or None where its run holds
nothing to read (a per-layer metric then stays out of the line)."""

import statistics

from rqbench import roofline
from rqbench.reference import rfc6330
from rqbench.trace import length, union


def rate_mbps(run, key: str):
    """BASELINE.md's unit over the window: 8 x the bytes of every object that
    went through `key` ("enc_s" or "dec_s") / 2**20 / window seconds."""
    done = sum(o["bytes"] for o in run.objects if key in o)
    return 8.0 * done / 2**20 / run.window_s if done and run.window_s > 0 else None


def span_median_ms(run, names):
    """The median over objects of the time in the named spans."""
    xs = run.per_object_s(set(names))
    return 1e3 * statistics.median(xs) if xs else None


def idle_pct(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def kernel_s(run, span: str) -> float:
    """Seconds in which a kernel launched under `span` ran (the union)."""
    t = run.trace
    return length(t.busy(lambda o: o.cat == "kernel" and o.span == span)) / 1e6 if t is not None else 0.0


def objects_with(run, span: str) -> int:
    return len({i for n, i, _, _ in run.spans if n == span})


def encode_roofline(run, span: str, rows_fn):
    """Share of the bandwidth roofline of the kernels launched under `span`
    (one per object), the rows counted by `rows_fn(P)`."""
    secs = kernel_s(run, span)
    if secs <= 0:
        return None
    rows_in, rows_out = rows_fn(rfc6330.params(run.K))
    nbytes = (rows_in + rows_out) * run.Z * run.T * objects_with(run, span)
    return roofline.share_pct(nbytes, secs)


def htod_ms(run):
    t = run.trace
    n = objects_with(run, "load")
    if t is None or not n:
        return None
    return length(union([(o.start, o.end) for o in t.ops if o.name.startswith("Memcpy HtoD")])) / 1e3 / n
