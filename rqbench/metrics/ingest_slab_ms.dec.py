"""ingest_slab_ms.dec: the median over objects of the self time of the
program's spans `ingest.slab` under Decoder.add_symbols (the spans under
them left out)."""

from rqbench.inside import median_ms, self_s


def read(run):
    return median_ms(run, "ingest", lambda sps: self_s(sps, "ingest.slab"), "ingest.slab")
