"""repair_host_ms.dec: the median over objects of the program's span
`repair_block` less its `fetch.wait`: Decoder.repair_block's time on the
host outside the wait for the card."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "repair", lambda sps: total_s(sps, "repair_block") - total_s(sps, "fetch.wait"),
                     "repair_block")
