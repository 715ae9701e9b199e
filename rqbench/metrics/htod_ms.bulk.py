"""htod_ms.bulk: the union of the host-to-device copies in the traced window, per object."""

from rqbench.readers import htod_ms


def read(run):
    return htod_ms(run)
