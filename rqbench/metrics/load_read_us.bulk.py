"""load_read_us.bulk: the window's self time of the program's span
`load.read` (codec.batch.load_object's loop over the symbols, the spans under
it left out) over the symbols it read (the window's increase of the
program's counter "load_symbols"), in us a symbol."""

from rqbench.inside import by_harness_span, self_s


def read(run):
    n = run.counters.get("load_symbols", 0)
    spans = [sp for (_, h), sps in by_harness_span(run).items() if h == "load" for sp in sps]
    secs = self_s(spans, "load.read")
    return 1e6 * secs / n if n and secs > 0 else None
