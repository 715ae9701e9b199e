"""The host half of the codec that the port reuses from `nanorq_tpu`, and the
numpy oracle of its payload math.

These are re-exported so that callers of the port (scripts such as
`chip_smoke.py`) import only `nanorq_tpu_torch`; none of them loads JAX:

- object I/O and packet tags: `MemoryIO`, `make_tag`;
- the native C++ solver probe: `native_available`;
- the codec's counters and timers: `stats`;
- RFC parameters and the encoder's precode schedule: `params_init`,
  `encoder_schedule`;
- the oracle: `replay_numpy` (the structured replay in numpy) and
  `lt_numpy` (LT symbols by the RFC tuples), independent of the port's
  torch code and kernels.
"""

import numpy as np

from nanorq_tpu.codec.cache import encoder_schedule
from nanorq_tpu.codec.oti import make_tag
from nanorq_tpu.io.ioctx import MemoryIO
from nanorq_tpu.native import native_available
from nanorq_tpu.precode.device_schedule import replay_structured_numpy as replay_numpy
from nanorq_tpu.rfc.params import Params, params_init
from nanorq_tpu.rfc.tuples import lt_indices
from nanorq_tpu.utils import stats

__all__ = ["MemoryIO", "encoder_schedule", "lt_numpy", "make_tag", "native_available",
           "params_init", "replay_numpy", "stats"]


def lt_numpy(C: np.ndarray, isis: np.ndarray, P: Params) -> np.ndarray:
    """LT symbols of `isis` over the intermediate symbols C [L, t], in numpy."""
    idx, valid = lt_indices(np.asarray(isis, np.uint32), P)
    out = np.zeros((idx.shape[0], C.shape[1]), np.uint8)
    for j in range(idx.shape[1]):
        out ^= np.where(valid[:, j, None], C[idx[:, j]], 0).astype(np.uint8)
    return out
