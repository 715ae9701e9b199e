"""enc_wait_ms.bulk: the median over objects of the program's span
`fetch.wait` inside codec.batch.repair_symbols: the host blocked on the
card until the repair symbols' downloads were done."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "repair_symbols", lambda sps: total_s(sps, "fetch.wait"), "fetch.wait")
