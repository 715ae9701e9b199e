"""repair_ms.bulk: the median over objects of the spans around an object's Decoder.repair_block calls."""

from rqbench.readers import span_median_ms


def read(run):
    return span_median_ms(run, ["repair"])
