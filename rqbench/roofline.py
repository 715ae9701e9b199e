"""The work of each operation in RFC 6330 rows, and the card's peaks.

A share of the roofline counts the rows an operation has to read and write,
once each, times the payload width, against the card's memory bandwidth: the
least time any implementation of the operation could take.  It is counted
from the RFC's parameters (`reference.rfc6330`), not from how the program
decomposes the work, so that it reads the same whatever implements it.
"""

import numpy as np

from rqbench.reference import rfc6330

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (at the 700 W power limit)
PEAK_BYTES_S = 3.35e12


def generate_rows(P: rfc6330.Params) -> tuple[int, int]:
    """(rows in, rows out) of the intermediate symbols' generation: the K
    source symbols in (the padding and constraint rows are zero), the L
    intermediate symbols out."""
    return P.K, P.L


def lt_rows(P: rfc6330.Params, n_repair: int) -> tuple[int, int]:
    """(rows in, rows out) of the LT combine of the repair ISIs K' ..
    K'+n-1: the distinct intermediate symbols their tuples touch, and the
    repair symbols."""
    touched = np.unique(np.concatenate(rfc6330.neighbors(P, np.arange(P.Kp, P.Kp + n_repair))))
    return int(touched.size), n_repair


def decode_rows(K: int, lost: int, overhead: int) -> tuple[int, int]:
    """(rows in, rows out) of one block's recovery: the K - lost received
    source symbols and the lost + overhead repair symbols in, the lost source
    symbols out."""
    return K + overhead, lost


def share_pct(nbytes: float, seconds: float) -> float | None:
    """Percent of the bandwidth roofline; None where no device time was seen."""
    if seconds <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_S / seconds
