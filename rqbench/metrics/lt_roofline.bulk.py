"""lt_roofline.bulk: the LT combine of the repair symbols against the bandwidth
roofline: its RFC rows in and out (rqbench.roofline.lt_rows) over the union of
the kernels launched under codec.batch.repair_symbols."""

from rqbench.readers import encode_roofline
from rqbench.roofline import lt_rows


def read(run):
    return encode_roofline(run, "repair_symbols", lambda P: lt_rows(P, run.n_repair))
