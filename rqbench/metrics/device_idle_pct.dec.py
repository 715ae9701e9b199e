"""device_idle_pct.dec: 100 x (1 - the union of the device's kernels, copies and fills / the traced window)."""

from rqbench.readers import idle_pct


def read(run):
    return idle_pct(run)
