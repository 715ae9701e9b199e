"""replay_roofline.bulk: the intermediate symbols' generation against the
bandwidth roofline: its RFC rows in and out (rqbench.roofline.generate_rows)
over the union of the kernels launched under codec.batch.generate."""

from rqbench.readers import encode_roofline
from rqbench.roofline import generate_rows


def read(run):
    return encode_roofline(run, "generate", generate_rows)
