"""repair_lt_ms.dec: the median over objects of the program's spans
`repair.lt` inside Decoder.repair_block: a structured plan's LT plan of the
gap ISIs and the launch of its LT combine, on the host's clock.  Nothing to
read where every plan was dense-W."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "repair", lambda sps: total_s(sps, "repair.lt"), "repair.lt")
