"""RFC 6330 s5.3.5.1 table-based PRNG Rand[y, i, m].

Parity: reference lib/rand.c:183-190.  Vectorized over y so tuple/index
expansion for a whole block of symbols is a handful of NumPy gathers.
"""

import numpy as np

from nanorq_tpu_torch.rfc.tables import V0, V1, V2, V3


def rnd_get(y, i, m):
    """Rand[y, i, m] = (V0[x0] ^ V1[x1] ^ V2[x2] ^ V3[x3]) % m.

    `y` may be a scalar or ndarray (uint32 semantics); `i` a small int;
    `m` a positive int (or broadcastable array).  Returns uint32 ndarray
    (or Python int for scalar input).
    """
    y = np.asarray(y, dtype=np.uint32)
    x0 = (y + i) & 0xFF
    x1 = ((y >> np.uint32(8)) + i) & 0xFF
    x2 = ((y >> np.uint32(16)) + i) & 0xFF
    x3 = ((y >> np.uint32(24)) + i) & 0xFF
    r = (V0[x0] ^ V1[x1] ^ V2[x2] ^ V3[x3]) % np.uint32(m)
    if r.ndim == 0:
        return int(r)
    return r
