"""Object-level batched encoding on torch tensors (counterpart of
`nanorq_tpu.codec.batch`).

RaptorQ blocks of one object share the precode system (params derive from
block 0's K, reference nanorq.c:289, and all blocks pad to the same K'), so
the whole object encodes as ONE structured replay over a payload matrix
[M_pad, Z*T] with blocks laid side by side, then one LT combine for the
repair symbols of every block.  This is the production streaming path; the
per-block Encoder API remains for incremental use.
"""

from dataclasses import dataclass

import numpy as np
import torch

from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.codec.api import Encoder
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import IOContext
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay


@dataclass
class ObjectBatch:
    enc: Encoder
    sbns: list[int]
    Ks: np.ndarray  # per-block source symbol counts
    D: np.ndarray  # [M_pad, Z*T] host payload matrix
    C: object = None  # device intermediates [L, Z*T]


def load_object(enc: Encoder, io: IOContext, sbns=None) -> ObjectBatch:
    """Read all source symbols of the given blocks into one payload matrix."""
    sbns = list(range(enc.num_blocks)) if sbns is None else list(sbns)
    T = enc.symbol_size
    ds = _cache.encoder_schedule(enc.P.Kp)
    D = np.zeros((ds.M_pad, len(sbns) * T), np.uint8)
    Ks = np.zeros(len(sbns), np.int64)
    for b, sbn in enumerate(sbns):
        K = enc.block_symbols(sbn)
        Ks[b] = K
        for esi in range(K):
            D[esi, b * T : (b + 1) * T] = enc._read_symbol(io, sbn, esi, K)
    return ObjectBatch(enc=enc, sbns=sbns, Ks=Ks, D=D)


def generate(batch: ObjectBatch, device) -> torch.Tensor:
    """One structured replay for the whole object: batch.C [L, Z*T] on `device`."""
    dev = resolve(device)
    ds = _cache.encoder_schedule(batch.enc.P.Kp)
    batch.C = replay(device_arrays(ds, dev), torch.from_numpy(batch.D).to(dev))
    return batch.C


def source_symbol(batch: ObjectBatch, b: int, esi: int) -> np.ndarray:
    T = batch.enc.symbol_size
    return batch.D[esi, b * T : (b + 1) * T]


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
