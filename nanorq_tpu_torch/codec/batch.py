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

from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.codec.api import Encoder
from nanorq_tpu_torch.io.ioctx import IOContext
from nanorq_tpu_torch.parallel import mesh as lanes
from nanorq_tpu_torch.utils import stats


@dataclass
class ObjectBatch:
    enc: Encoder
    sbns: list[int]
    Ks: np.ndarray  # per-block source symbol counts
    # host payload matrix, blocks side by side: its rows are the schedule's
    # M_pad rows, of which rows >= max(Ks) are zero and may be absent
    # (`parallel.mesh.host_matrix`: [max(Ks), Z*T] pinned on CUDA)
    D: np.ndarray
    C: object = None  # device intermediates [L, Z*T]: a tensor, or a parallel.mesh.Sharded


def load_object(enc: Encoder, io: IOContext, sbns=None) -> ObjectBatch:
    """Read all source symbols of the given blocks into one payload matrix,
    in pinned memory when the encoder's device is a card.  Spans
    `load_object` > `load.alloc` (the matrix), `load.read` (the symbols,
    a block's in one row read where the layout allows: `_read_symbols_into`);
    counters "load_symbols" (the symbols read) and "load_fast" (those the
    row read served)."""
    with stats.span("load_object"):
        sbns = list(range(enc.num_blocks)) if sbns is None else list(sbns)
        T = enc.symbol_size
        Ks = np.array([enc.block_symbols(sbn) for sbn in sbns], np.int64)
        ds = _cache.encoder_schedule(enc.P.Kp)
        with stats.span("load.alloc"):
            D = lanes.host_matrix(int(Ks.max(initial=0)), ds.M_pad, len(sbns) * T, enc.device)
        with stats.span("load.read"):
            fast = sum(enc._read_symbols_into(io, sbn, int(K), D[:K, b * T : (b + 1) * T])
                       for b, (sbn, K) in enumerate(zip(sbns, Ks)))
        stats.count("load_symbols", int(Ks.sum()))
        stats.count("load_fast", fast)
        return ObjectBatch(enc=enc, sbns=sbns, Ks=Ks, D=D)


def generate(batch: ObjectBatch, device, mesh=None):
    """One structured replay for the whole object: batch.C [L, Z*T] on
    `device`.  Only the payload rows go up (the rows past the largest K are
    zero by construction and are zeroed on the device), straight out of a
    pinned D.  With `mesh`, the width is split over its lanes on whole blocks
    where there are enough of them, each lane uploads its columns and
    replays them on its own stream, and batch.C stays sharded.  With no
    mesh, the lanes are the default path's (`parallel.mesh.default_mesh`):
    on a card a wide object runs as width slices on streams of the card,
    every slice's upload issued before the first replay, and batch.C stays
    sharded over them; else one lane on the device's current stream, and
    batch.C is one tensor.  The JAX package pads the width to a multiple of
    the device count first (`pad_width`: its shards must be equal); lanes
    take unequal shards, so the object's matrix is not copied to pad it."""
    with stats.span("generate"):
        ds = _cache.encoder_schedule(batch.enc.P.Kp)
        T, live = batch.enc.symbol_size, int(batch.Ks.max())
        on = lanes.default_mesh(device, batch.D.shape[1], T, live) if mesh is None else mesh
        with stats.span("generate.upload"):
            Dsh = lanes.shard_width(batch.D, on, block=T, live_rows=live, rows=ds.M_pad)
        with stats.span("generate.replay"):
            C = lanes.replay_sharded(ds, Dsh, on)
        batch.C = C if mesh is not None or on.size > 1 else C.parts[0]
        return batch.C


def source_symbol(batch: ObjectBatch, b: int, esi: int) -> np.ndarray:
    T = batch.enc.symbol_size
    return batch.D[esi, b * T : (b + 1) * T]


def repair_symbols(batch: ObjectBatch, n_repair: int, device, mesh=None) -> dict[int, np.ndarray]:
    """Repair payloads of every block: {batch index b: [n_repair, T]},
    downloaded into pinned memory.

    Repair ISIs are K-independent (arange(K, K+n) + K'-K == arange(K', K'+n)
    for every block length), so one plan and one combine cover the object.
    With `mesh`, the combine runs on the lanes that hold the sharded batch.C
    (the layout of generate(mesh=)); with no mesh, on the default path's
    slices where generate left batch.C over them.  Every lane's combine is
    issued, then every lane's download, each on its lane's stream, and the
    host waits once per stream.  A batch.C that does not go with `mesh` is
    combined unsharded on its device, a sharded one gathered to `device`
    first."""
    if mesh is not None:
        lanes.check_mesh(mesh)
    if batch.C is None:
        generate(batch, device, mesh=mesh)
    with stats.span("repair_symbols"):
        P = batch.enc.P
        isis = np.arange(P.Kp, P.Kp + n_repair, dtype=np.uint32)
        if isinstance(batch.C, lanes.Sharded) and batch.C.mesh is not mesh and not (
                mesh is None and lanes.is_sliced(batch.C.mesh)):
            batch.C = batch.C.gather(device)
        C = batch.C if isinstance(batch.C, lanes.Sharded) else lanes.whole(batch.C)
        with stats.span("lt.combine"):
            S = lanes.lt_sharded(C, isis, P, C.mesh)
        return S.host_blocks(batch.enc.symbol_size, len(batch.sbns), n_repair)
