"""encode_mbps: 8 x the bytes of the objects encoded / 2**20 / window seconds."""

from rqbench.readers import rate_mbps


def read(run):
    return rate_mbps(run, "enc_s")
