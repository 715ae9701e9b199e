"""repair_wait_ms.dec: the median over objects of the program's span
`fetch.wait` inside Decoder.repair_block: the host blocked on the card until
each block's recovered rows were downloaded."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "repair", lambda sps: total_s(sps, "fetch.wait"), "fetch.wait")
