"""RFC 6330 specification constants, decoded into NumPy arrays.

Parity: reference lib/rand.c:3-181 (V0..V3), lib/tuple.c:4-8 (degree dist),
include/table2.h (Table 2: K_padded / J_K_padded / S_H_W, Z_max, K_max).
"""

import base64

import numpy as np

from nanorq_tpu_torch.rfc import _tabledata as _d


def _unpack(b64: str, dtype: str) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(b64), dtype=dtype)
    a.flags.writeable = False
    return a


# Four 256-entry uint32 tables of the spec PRNG (RFC 6330 s5.5).
V0 = _unpack(_d.V0_B64, "<u4")
V1 = _unpack(_d.V1_B64, "<u4")
V2 = _unpack(_d.V2_B64, "<u4")
V3 = _unpack(_d.V3_B64, "<u4")

# Cumulative degree distribution f[0..30] (RFC 6330 s5.3.5.2); f[30] = 2^20.
DEGREE_DIST = _unpack(_d.DEG_B64, "<u4")

# Table 2 (RFC 6330 s5.6): the 477 supported K' values with per-K' systematic
# index J and precode parameters (S, H, W).
K_PADDED = _unpack(_d.K_PADDED_B64, "<u2")
J_K_PADDED = _unpack(_d.J_K_B64, "<u2")
S_H_W = _unpack(_d.S_H_W_B64, "<u2").reshape(477, 3)

Z_MAX = 256  # max source blocks per object (reference include/table2.h:52)
K_MAX = 56403  # max symbols per source block (include/table2.h:53)

# ~881 GB object-size bound (reference include/nanorq.h:14)
MAX_TRANSFER = 946270874880
