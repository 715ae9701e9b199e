"""load_alloc_ms.bulk: the median over objects of the program's span
`load.alloc` (codec.batch.load_object's zeroed, pinned payload matrix)."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "load", lambda sps: total_s(sps, "load.alloc"), "load.alloc")
