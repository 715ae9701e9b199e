"""repair_replay_ms.dec: the median over objects of the program's spans
`repair.replay` inside Decoder.repair_block: a structured plan's device
arrays, the lookup of its replay program and the replay's launch, on the
host's clock.  Nothing to read where every plan was dense-W."""

from rqbench.inside import median_ms, total_s


def read(run):
    return median_ms(run, "repair", lambda sps: total_s(sps, "repair.replay"), "repair.replay")
