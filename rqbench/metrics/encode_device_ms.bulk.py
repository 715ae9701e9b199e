"""encode_device_ms.bulk: the median over objects of the spans around
codec.batch.generate and repair_symbols (the device half of the sender)."""

from rqbench.readers import span_median_ms


def read(run):
    return span_median_ms(run, ["generate", "repair_symbols"])
