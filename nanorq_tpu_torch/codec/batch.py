"""Object-level batched encoding on torch tensors (counterpart of
`nanorq_tpu.codec.batch`).

All blocks of an object share K', so the whole object encodes as ONE
structured replay over D [M_pad, Z*T] with the blocks side by side, then one
LT combine for the repair symbols of every block.  `load_object` and
`source_symbol` are the JAX package's own (host-only) functions.
"""

import numpy as np
import torch

from nanorq_tpu.codec import cache as _cache
from nanorq_tpu.codec.batch import ObjectBatch, load_object, source_symbol  # noqa: F401  (re-exported)
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay


def generate(batch: ObjectBatch, device) -> torch.Tensor:
    """One structured replay for the whole object: batch.C [L, Z*T] on `device`."""
    dev = resolve(device)
    ds = _cache.encoder_schedule(batch.enc.P.Kp)
    batch.C = replay(device_arrays(ds, dev), torch.from_numpy(batch.D).to(dev))
    return batch.C


def repair_symbols(batch: ObjectBatch, n_repair: int, device) -> dict[int, np.ndarray]:
    """Repair payloads of every block: {batch index b: [n_repair, T]}.

    Repair ISIs are K-independent (arange(K, K+n) + K'-K == arange(K', K'+n)
    for every block length), so one plan and one combine cover the object."""
    dev = resolve(device)
    if batch.C is None:
        generate(batch, dev)
    T = batch.enc.symbol_size
    P = batch.enc.P
    plan = lt_plan(np.arange(P.Kp, P.Kp + n_repair, dtype=np.uint32), P, dev)
    sym = lt_combine(batch.C, plan)[:n_repair].cpu().numpy()
    return {b: sym[:, b * T : (b + 1) * T] for b in range(len(batch.sbns))}
