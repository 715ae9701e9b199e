"""load_ms.bulk: the median over objects of the span around codec.batch.load_object."""

from rqbench.readers import span_median_ms


def read(run):
    return span_median_ms(run, ["load"])
