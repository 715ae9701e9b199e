"""ingest_ms.bulk: the median over objects of the spans around an object's add_symbols calls."""

from rqbench.readers import span_median_ms


def read(run):
    return span_median_ms(run, ["ingest"])
