"""Encoder / Decoder of the port: `nanorq_tpu.codec.api` on torch tensors.

Functional parity with the reference API (include/nanorq.h): object
lifecycle, OTI words, per-symbol and batched encode, symbol ingestion with
ADDED/IGN/DUP/ERR statuses, gap tracking, block repair.  The host logic
(OTI, partitioning, ingestion, gap tracking, the patched system and its
solve) is the JAX package's, copied unchanged; every device call site runs
the port's torch code on the explicit `device` the object was built with:

- encode: the structured replay and LT combine (ops/lt.py); on a card the
  replay is the encoder schedule's program, one captured CUDA graph per
  width and stream from its second replay on (ops/program.py;
  ops/replay.py runs it eagerly);
- decode, per `backend` of `repair_all` (default: env NANORQ_DECODE_BACKEND,
  else "auto", as in the JAX package):
  - "device": the dense-W matmul (ops/wpath.py) for WSchedule plans, or the
    replay plus a gap LT combine for structured plans (on a card the
    program of the schedule's signature, shared by the patterns of one
    canonical layout, from the signature's second replay on);
  - "res": the residual arm, no per-pattern solve: canonical w-rows, a
    native G-inverse per block and one batched K3 product per chunk
    (ops/wpath.res_apply_batch).  Raises when the native factorization is
    missing, where the JAX package quietly reroutes to the host;
  - "res_host" and "host": the native CPU arms, with no device half;
  - "auto": the port's own rule (`auto_arm`), set from the medians of the
    H100 host's bench (`python -m nanorq_tpu_torch.bench --arms`, every arm
    cold and warm in 5 rounds at K = 100 ... 50000; PERF.md, sections 4 and
    6).  Cold patterns go to "res_host" up to K' = NANORQ_RES_HOST_MAX (560),
    else to "host", whether the pattern's plan would be dense-W or
    structured: the cold device arm never beat "host" by more than the two
    arms' spreads.  Warm patterns (a device plan cached) go to the device
    from K' = 251 up, and below it to "res_host", which matched or beat the
    warm device arm there.  The JAX package sends every warm pattern to the
    device and cold ones to "res_host" up to K' = 256, a crossover measured
    on another host.

`mesh=` (a `parallel.mesh.Mesh`) splits the device work over the mesh's
lanes, each a device with a stream of its own: the encoder's replay and LT
combine by payload width, the decoder's stacked W batches by block, its
structured plans block by block in turn.  With no mesh the same code runs
on one lane of `device` on its current stream (`parallel.mesh.local_mesh`):
pinned transfers of the live rows only.  A mesh forces the decoder's device
arm, and its lanes' devices do the work, whatever `device` the object has.
"""

import itertools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from nanorq_tpu_torch.codec import cache as _cache
from nanorq_tpu_torch.codec.oti import pack_oti_common, pack_oti_scheme, split_tag
from nanorq_tpu_torch.codec.oti import unpack_oti_common, unpack_oti_scheme
from nanorq_tpu_torch.codec.partition import Scheme, div_ceil, make_scheme, scheme_from_oti, symbol_ranges
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import IOContext, read_rows
from nanorq_tpu_torch.native import host_repair_shared, host_residual_flat, native_available, res_rinv
from nanorq_tpu_torch.ops import program, wpath
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays
from nanorq_tpu_torch.parallel import mesh as lanes
from nanorq_tpu_torch.rfc.params import Params, params_init
from nanorq_tpu_torch.rfc.tables import K_MAX, MAX_TRANSFER, Z_MAX
from nanorq_tpu_torch.utils import stats

_NO_FACTOR = ('backend "res" needs the native solver\'s canonical factorization, '
              "which is unavailable here; no other arm is taken in its place")
BACKENDS = ("auto", "device", "host", "res", "res_host")


# symbol ingestion statuses (include/nanorq.h:10-13)
SYM_ADDED = 0
SYM_IGN = 1
SYM_DUP = 2
SYM_ERR = -1

# the ingestion counter of each status
_STATUS_COUNTER = {SYM_ERR: "ingest_err", SYM_ADDED: "ingest_added", SYM_IGN: "ingest_ign", SYM_DUP: "ingest_dup"}


def _count_statuses(statuses: np.ndarray) -> None:
    """Counters "ingest_symbols" and one a status, for one call's statuses."""
    stats.count("ingest_symbols", int(statuses.size))
    for st, n in zip((SYM_ERR, SYM_ADDED, SYM_IGN, SYM_DUP), np.bincount(statuses + 1, minlength=4)):
        if n:
            stats.count(_STATUS_COUNTER[st], int(n))


# shared all-zeros symbol rows (per T), read-only: padding/constraint rows of
# the patched system point here in the host arm's zero-copy row-pointer map
_ZERO_ROWS: dict[int, np.ndarray] = {}


# K' at or below which "auto" sends a cold pattern to the solve-free host
# residual arm.  The crossover on the H100 host (bench --arms, cold medians
# of 5 rounds, Mb/s res_host / host, NVIDIA H100 80GB HBM3, 700 W): 11033 /
# 9500 at K'=511, 4737 / 9630 at 1002 (PERF.md, section 4; between them, PR
# 8's best rounds: 5924 / 6725 at 600); the JAX package's 256 was measured on
# an AVX-512 host.
_RES_HOST_MAX = int(os.environ.get("NANORQ_RES_HOST_MAX", "560"))
# K' at or below which "auto" sends a warm pattern (its device plan cached)
# to the host residual arm too: warm medians, res_host / device, 17958 /
# 16492 Mb/s at K'=200, 15798 / 22869 at 301 (PERF.md, section 4)
_RES_HOST_WARM_MAX = 250
# the cold arms above _RES_HOST_MAX, by the kind of plan a pattern gets.
# Cold medians, host / device, Mb/s: dense-W 9630 / 5597 at K'=1002, 8596 /
# 8288 at 5008, 7118 / 7052 at 10017; structured 6224 / 6047 at 20152, 5475
# / 5729 at 30037, 4503 / 5533 at 50511, where the spreads were 46% / 41%
# (PERF.md, section 4): the device never wins by more than the two spreads
_COLD_DENSE_ARM = "host"
_COLD_STRUCTURED_ARM = "host"


def auto_arm(Kp: int, warm: bool) -> str:
    """The arm "auto" sends a block of K' to (see the module docstring):
    `warm` when its pattern's device plan is cached.  Cold, above
    _RES_HOST_MAX, the kind of plan the pattern will get decides: dense-W
    up to `cache.WPATH_MAX_KP` (read at the call), structured above."""
    if warm:
        return "res_host" if Kp <= _RES_HOST_WARM_MAX else "device"
    if Kp <= _RES_HOST_MAX:
        return "res_host"
    return _COLD_DENSE_ARM if Kp <= _cache.WPATH_MAX_KP else _COLD_STRUCTURED_ARM


def auto_rule() -> dict:
    """The boundaries of `auto_arm` in force."""
    return {"res_host_max": _RES_HOST_MAX, "res_host_warm_max": _RES_HOST_WARM_MAX,
            "wpath_max_kp": _cache.WPATH_MAX_KP, "cold_dense": _COLD_DENSE_ARM,
            "cold_structured": _COLD_STRUCTURED_ARM}


def _device_may_read(Kp: int) -> bool:
    """Whether a decoder of K' is likely to meet the device arm: under the
    default backend (env NANORQ_DECODE_BACKEND) "device" always, a host arm
    never; "auto" where its cold rule sends K' to the device, or where a
    device plan of K' was built since the decoder cache was last cleared
    (the device arm has read decoders of K' in this process: the warm rule,
    an explicit backend or a mesh).  A decoder that the device arm reads all the same
    (explicit backends, meshes, `repair_block`) has its slabs page-locked in
    place by the upload."""
    backend = os.environ.get("NANORQ_DECODE_BACKEND", "auto")
    if backend != "auto":
        return backend == "device"
    return auto_arm(Kp, False) == "device" or _cache.has_device_plans(Kp)


def _zero_row(T: int) -> np.ndarray:
    z = _ZERO_ROWS.get(T)
    if z is None:
        z = _ZERO_ROWS.setdefault(T, np.zeros(T, np.uint8))
    return z


class _Block:
    """Per-SBN working state (reference struct block_encoder, nanorq.c:40-47).

    Source-ESI tracking is a bool array + count (the bitmask analog,
    lib/bitmask.c) so batched ingest and gap queries are vectorized; repair
    ESIs (sparse, unbounded) stay in a set.
    """

    __slots__ = ("K", "D", "C", "loaded", "got", "nsrc",
                 "rep_esis", "rep_rows", "nrep", "rep_seen")

    def __init__(self, K: int):
        self.K = K
        # payload matrix: an encoder's is `parallel.mesh.host_matrix`, a
        # decoder's a slot of its ingestion slab (`Decoder._source_rows`)
        self.D: np.ndarray | None = None
        self.C = None  # device intermediate symbols [L, T]
        self.loaded = False
        self.got = np.zeros(K, bool)  # received source esis
        self.nsrc = 0  # = got.sum(), tracked incrementally
        # repair symbols live in ONE contiguous [cap, T] buffer (doubling
        # growth) so repair-time fills and per-row address math vectorize
        self.rep_esis = np.empty(8, np.int64)
        self.rep_rows: np.ndarray | None = None
        self.nrep = 0
        self.rep_seen: set[int] = set()

    def add_repair(self, esis: np.ndarray, payloads: np.ndarray):
        """Append repair rows (esis int [n], payloads uint8 [n, T])."""
        n = int(esis.size)
        need = self.nrep + n
        if self.rep_rows is None or need > self.rep_rows.shape[0]:
            cap = max(8, 1 << (need - 1).bit_length())
            rows = np.empty((cap, payloads.shape[1]), np.uint8)
            if self.nrep:
                rows[: self.nrep] = self.rep_rows[: self.nrep]
            self.rep_rows = rows
            if cap > self.rep_esis.size:
                e = np.empty(cap, np.int64)
                e[: self.nrep] = self.rep_esis[: self.nrep]
                self.rep_esis = e
        self.rep_esis[self.nrep : need] = esis
        self.rep_rows[self.nrep : need] = payloads
        self.nrep = need
        self.rep_seen.update(int(x) for x in esis)

    def reset(self):
        self.D = None
        self.C = None
        self.loaded = False
        self.got[:] = False
        self.nsrc = 0
        self.nrep = 0
        self.rep_rows = None
        self.rep_seen.clear()


class _CodecBase:
    scheme: Scheme
    P: Params

    def __init__(self):
        self._blocks: dict[int, _Block] = {}

    # --- introspection (nanorq.h parity) ---
    def oti_common(self) -> int:
        return pack_oti_common(self.scheme.F, self.scheme.T)

    def oti_scheme_specific(self) -> int:
        return pack_oti_scheme(self.scheme.Z, self.scheme.N, self.scheme.Al)

    @property
    def transfer_length(self) -> int:
        return self.scheme.F

    @property
    def symbol_size(self) -> int:
        return self.scheme.T

    @property
    def num_blocks(self) -> int:
        return self.scheme.blocks

    @property
    def max_blocks(self) -> int:
        return Z_MAX

    def block_symbols(self, sbn: int) -> int:
        return self.scheme.block_symbols(sbn)

    def _block(self, sbn: int) -> _Block:
        b = self._blocks.get(sbn)
        if b is None:
            b = _Block(self.block_symbols(sbn))
            self._blocks[sbn] = b
        return b

    def cleanup(self, sbn: int) -> None:
        self._blocks.pop(sbn, None)

    def reset(self, sbn: int) -> None:
        b = self._blocks.get(sbn)
        if b is not None:
            b.reset()

    # --- shared I/O scatter/gather ---
    def _read_symbol(self, io: IOContext, sbn: int, esi: int, K: int) -> np.ndarray:
        out = np.zeros(self.scheme.T, np.uint8)
        for off, length, col in symbol_ranges(self.scheme, sbn, esi, K):
            data = io.read_at(off, length)
            out[col : col + len(data)] = np.frombuffer(data, np.uint8)
        return out

    def _read_symbols_into(self, io: IOContext, sbn: int, K: int, out: np.ndarray) -> int:
        """Read the block's K source symbols into out [K, T], which may be a
        strided view.  With N=1 the block is one T-strided byte range: the
        rows wholly inside F and inside the I/O's size (a prefix, the offsets
        rise) go through one read_rows, and the rest (a final short symbol,
        rows past a short I/O) through _read_symbol, which zero-pads them.
        With N > 1, symbol by symbol.  Returns the rows the row read served."""
        n = 0
        if self.scheme.N == 1 and K:
            T = self.scheme.T
            end = min(self.scheme.F, io.size()) if hasattr(io, "size") else self.scheme.F
            base = symbol_ranges(self.scheme, sbn, 0, K)[0][0]
            n = min(K, max(0, (end - base) // T))
            read_rows(io, base + T * np.arange(n, dtype=np.int64), out[:n])
        for esi in range(n, K):
            out[esi] = self._read_symbol(io, sbn, esi, K)
        return n

    def _write_symbol(self, io: IOContext, sbn: int, esi: int, K: int, payload: np.ndarray) -> None:
        for off, length, col in symbol_ranges(self.scheme, sbn, esi, K):
            io.write_at(off, payload[col : col + length])

    def _write_symbols_coalesced(self, io: IOContext, sbn: int, esis, K: int, payloads: np.ndarray) -> None:
        """Write-through many symbols with adjacent byte ranges merged into
        single io.write_at calls (in-order N=1 bursts collapse to one write)."""
        if self.scheme.N == 1:  # vectorized fast path: one range per symbol
            T = self.scheme.T
            base = symbol_ranges(self.scheme, sbn, 0, K)[0][0]
            es = np.asarray(esis, np.int64)
            offs = base + es * T
            pl = np.asarray(payloads, np.uint8)
            F = self.scheme.F
            full = offs + T <= F
            if full.any():
                # the io backend scatters row-aligned offsets vectorized
                # (MemoryIO) or merges adjacent runs into single writes
                io.write_rows_at(offs[full], pl[full])
            for i in np.nonzero(~full)[0]:  # final short symbol: clamp to F
                off = int(offs[i])
                if off < F:
                    io.write_at(off, pl[i][: F - off])
            return
        segs = []  # (object offset, length, payload row, payload col)
        for r, esi in enumerate(esis):
            for off, length, col in symbol_ranges(self.scheme, sbn, int(esi), K):
                segs.append((off, length, r, col))
        segs.sort()
        i = 0
        while i < len(segs):
            j = i
            end = segs[i][0] + segs[i][1]
            while j + 1 < len(segs) and segs[j + 1][0] == end:
                j += 1
                end = segs[j][0] + segs[j][1]
            data = (
                payloads[segs[i][2]][segs[i][3] : segs[i][3] + segs[i][1]]
                if j == i
                else np.concatenate([payloads[r][c : c + ln] for (_, ln, r, c) in segs[i : j + 1]])
            )
            io.write_at(segs[i][0], data)
            i = j + 1



class Encoder(_CodecBase):
    """Systematic RaptorQ encoder (reference nanorq_encoder_new_ex path)."""

    def __init__(self, transfer_length: int, symbol_size: int, Al: int = 4, K: int = 0, Z: int = 0, N: int = 1,
                 *, device):
        super().__init__()
        if transfer_length > MAX_TRANSFER:
            raise ValueError("transfer too large")
        # clamp alignment to the largest supported value <= Al (nanorq.c:252-259)
        for a in (8, 4, 2, 1):
            if Al >= a:
                Al = a
                break
        else:
            Al = 1
        T = max(symbol_size, Al)
        T -= T % Al
        # grow T until the transfer fits the symbol budget; step by at least
        # 2 so Al=1 cannot loop forever (reference nanorq.c:271 has that bug)
        while div_ceil(transfer_length, T) > Z_MAX * K_MAX:
            T *= max(Al, 2)
        if T > 1 << 16:
            # the OTI common word stores T-1 in 16 bits (codec/oti.py)
            raise ValueError(f"symbol size {T} exceeds the 65536-byte OTI limit")
        self.scheme = make_scheme(transfer_length, T, Al, K=K, Z=Z, N=N)
        self.P = params_init(max(1, self.scheme.block_symbols(0)))
        self.device = resolve(device)

    # --- schedule management ---
    def precalculate(self) -> bool:
        """Solve (and cache) the loss-independent encoder schedule."""
        _cache.encoder_schedule(self.P.Kp)
        return True

    def _load(self, io: IOContext, sbn: int) -> _Block:
        b = self._block(sbn)
        if not b.loaded:
            ds = _cache.encoder_schedule(self.P.Kp)
            D = lanes.host_matrix(b.K, ds.M_pad, self.scheme.T, self.device)
            self._read_symbols_into(io, sbn, b.K, D[: b.K])
            b.D = D
            b.loaded = True
        return b

    def generate_symbols(self, sbn: int, io: IOContext, mesh=None) -> bool:
        """Compute the block's intermediate symbols C [L, T] on the device;
        only the block's K payload rows are uploaded.

        With `mesh`, the payload width is split over its lanes (the replay is
        a stream of row operations, columnwise independent; shards may be
        unequal, so nothing is padded) and C stays sharded.  For a whole
        object prefer codec.batch, which lays the blocks side by side on the
        width axis before it splits."""
        b = self._load(io, sbn)
        if b.C is None:
            ds = _cache.encoder_schedule(self.P.Kp)
            if mesh is not None:
                lanes.check_mesh(mesh)
            on = lanes.local_mesh(self.device) if mesh is None else mesh
            C = lanes.replay_sharded(ds, lanes.shard_width(b.D, on, live_rows=b.K, rows=ds.M_pad), on)
            b.C = C if mesh is not None else C.parts[0]
        return True

    def encode_batch(self, sbn: int, esis: np.ndarray, io: IOContext, mesh=None) -> np.ndarray:
        """Encode many symbols of one block -> [n, T] uint8 (numpy).  Source
        ESIs come from the loaded rows, repair ESIs from the LT combine.

        With `mesh`, the combine runs on the lanes that hold the sharded C
        (generated sharded if not there yet).  Where C and `mesh` do not go
        together the combine is the unsharded one on `self.device`: a C
        sharded over another mesh, or met with no mesh, is first gathered
        there (`Sharded.gather`), and an unsharded C stays where it is."""
        if mesh is not None:
            lanes.check_mesh(mesh)
        esis = np.asarray(esis, dtype=np.int64)
        b = self._load(io, sbn)
        T = self.scheme.T
        out = np.zeros((len(esis), T), np.uint8)
        src_mask = esis < b.K
        if src_mask.any():
            out[src_mask] = b.D[esis[src_mask]]
        rep = np.nonzero(~src_mask)[0]
        if rep.size:
            self.generate_symbols(sbn, io, mesh=mesh)
            isis = (esis[rep] + (self.P.Kp - b.K)).astype(np.uint32)
            if isinstance(b.C, lanes.Sharded) and b.C.mesh is not mesh:
                b.C = b.C.gather(self.device)
            C = b.C if isinstance(b.C, lanes.Sharded) else lanes.whole(b.C)
            out[rep] = lanes.lt_sharded(C, isis, self.P, C.mesh).host(rep.size)
        return out

    def encode(self, esi: int, sbn: int, io: IOContext) -> np.ndarray:
        """Single-symbol encode (nanorq_encode parity)."""
        if esi > (1 << 24) - 1:
            raise ValueError("esi out of range")
        return self.encode_batch(sbn, np.array([esi]), io)[0]


class _HostResult:
    """Lazy host copy of one device result: the first np.asarray() of any
    of its views waits for the device and fetches the whole tensor once,
    into pinned memory.  `lane`: the lane whose stream produced it, and then
    downloads it."""

    __slots__ = ("dev", "lane", "_np")

    def __init__(self, dev: torch.Tensor, lane):
        self.dev = dev
        self.lane = lane
        self._np = None

    def numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = lanes.fetch([(self.lane, self.dev)])[0]
        return self._np


class _ShardedResult:
    """Lazy host copy of a stack of blocks split over a mesh: the first
    np.asarray() of any view downloads every lane's run, each on its stream,
    and waits once.  numpy()[j] is block j of the whole stack."""

    __slots__ = ("sharded", "_np")

    def __init__(self, sharded):
        self.sharded = sharded
        self._np = None

    def numpy(self) -> list:
        if self._np is None:
            self._np = [blk for part in self.sharded.host_parts() if part is not None for blk in part]
        return self._np


class _HostView:
    """Row block `j` of a stacked _HostResult (or all of it when j is None),
    resolved by np.asarray -- the form Decoder._repair_finish consumes."""

    __slots__ = ("res", "j")

    def __init__(self, res: _HostResult, j: int | None = None):
        self.res = res
        self.j = j

    def __array__(self, dtype=None, copy=None):
        a = self.res.numpy() if self.j is None else self.res.numpy()[self.j]
        return a if dtype is None else a.astype(dtype)


class Decoder(_CodecBase):
    """RaptorQ decoder (reference nanorq_decoder_new / add_symbol / repair)."""

    def __init__(self, oti_common: int, oti_scheme: int, *, device):
        super().__init__()
        F, T = unpack_oti_common(oti_common)
        Z, N, Al = unpack_oti_scheme(oti_scheme)
        if F > MAX_TRANSFER:
            raise ValueError("transfer too large")
        self.scheme = scheme_from_oti(F, T, Al, Z, N)
        self.P = params_init(max(1, self.scheme.block_symbols(0)))
        self.max_esi = 2 * self.P.Kp
        self.device = resolve(device)
        # ingestion slabs: slab i holds the rows of blocks [i*g, (i+1)*g),
        # pinned from the start where the device arm may read them
        self._slab_g = lanes.slab_blocks(self.num_blocks, self.block_symbols(0) * self.scheme.T)
        self._slabs: dict[int, np.ndarray] = {}
        self._pin = self.device.type == "cuda" and _device_may_read(self.P.Kp)

    def set_max_esi(self, max_esi: int) -> bool:
        if max_esi >= (1 << 24) or max_esi < self.P.Kp:
            return False
        self.max_esi = max_esi
        return True

    def add_symbol(self, data, tag: int, io: IOContext) -> int:
        """Ingest one received symbol (nanorq_decoder_add_symbol parity);
        counted as `add_symbols` counts."""
        st = self._add_symbol(data, tag, io)
        stats.count("ingest_symbols")
        stats.count(_STATUS_COUNTER[st])
        return st

    def _add_symbol(self, data, tag: int, io: IOContext) -> int:
        sbn, esi = split_tag(tag)
        if sbn >= self.num_blocks or esi > self.max_esi:
            return SYM_ERR
        payload = np.frombuffer(bytes(data), np.uint8).copy() if not isinstance(data, np.ndarray) else data.astype(np.uint8).copy()
        if len(payload) != self.scheme.T:
            return SYM_ERR  # malformed beats DUP: a bad packet is never "seen"
        b = self._block(sbn)
        if b.nsrc == b.K:
            return SYM_IGN
        if b.got[esi] if esi < b.K else esi in b.rep_seen:
            return SYM_DUP
        if esi < b.K:
            self._source_rows(sbn, b)[esi] = payload
            self._write_symbol(io, sbn, esi, b.K, payload)
            b.got[esi] = True
            b.nsrc += 1
        else:
            b.add_repair(np.array([esi], np.int64), payload[None])
        return SYM_ADDED

    def _source_rows(self, sbn: int, b: _Block) -> np.ndarray:
        """The block's ingestion matrix b.D [K, T]: received source symbols in
        their rows, every other row zero (repair never writes into it).  It
        is a slot of a host slab that `_slab_g` consecutive blocks share
        (sized by `parallel.mesh.slab_blocks` for the pinned allocator's
        power-of-two blocks).  Where the device arm may read the decoder
        (`_device_may_read`, decided at construction on a card) the slab is
        pinned from the start (`parallel.mesh.host_zeros`, out of PyTorch's
        pinned cache, which the next decoder of the size reuses); else it
        is a pageable `parallel.mesh.HostSlab`, which the device arm's
        upload page-locks in place should it read the slab after all
        (`parallel.mesh.assemble`), so a decoder that only the host arms read
        pins nothing.  A slot given back (`reset`) is zeroed, or its slab
        dropped once no block holds a slot of it.  The native host arms read
        its rows in place (`_row_ptrs`); the array keeps the slab alive."""
        if b.D is None:
            g = self._slab_g
            slab = self._slabs.get(sbn // g)
            if slab is None:
                shape = (min(g, self.num_blocks - sbn // g * g), self.block_symbols(0), self.scheme.T)
                slab = lanes.host_zeros(shape, self.device) if self._pin else np.asarray(lanes.HostSlab(shape))
                self._slabs[sbn // g] = slab
            b.D = slab[sbn % g, : b.K]
        return b.D

    def reset(self, sbn: int) -> None:
        """Forget block sbn's symbols.  Its slot is zeroed for the block's
        next symbols, unless no block of its slab holds a slot any more:
        then the slab goes back to the host allocator (PyTorch's pinned
        cache for a slab pinned from the start; a `HostSlab` is unpinned,
        where a card read it, and freed)."""
        b = self._blocks.get(sbn)
        D = None if b is None else b.D
        super().reset(sbn)
        if D is None:
            return
        g = self._slab_g
        i = sbn // g
        blocks = (self._blocks.get(s) for s in range(i * g, min(i * g + g, self.num_blocks)))
        if all(b is None or b.D is None for b in blocks):
            del self._slabs[i]
        else:
            D[:] = 0

    def cleanup(self, sbn: int) -> None:
        self.reset(sbn)
        super().cleanup(sbn)

    def ingest_bytes(self) -> tuple[int, int]:
        """(bytes of the ingestion slabs, bytes they pin on a card now:
        `parallel.mesh.pinned_bytes` of each; on the CPU the first)."""
        held = sum(s.nbytes for s in self._slabs.values())
        if self.device.type != "cuda":
            return held, held
        return held, sum(lanes.pinned_bytes(s) for s in self._slabs.values())

    def add_symbols(self, payloads: np.ndarray, tags, io: IOContext) -> list[int]:
        """Batched ingestion: payloads [n, T] with per-symbol tags.

        Returns the per-symbol status list with add_symbol's exact in-order
        semantics (first occurrence ADDED, later DUP; symbols arriving after
        the block completes IGN), but vectorized: one payload-matrix write
        per block and coalesced write-through I/O instead of n passes.

        Span `add_symbols` > `ingest.status` (tags and statuses),
        `ingest.write` (the write-through), `ingest.slab` (the slab rows),
        `ingest.repair` (the repair rows); counters "ingest_symbols" and
        "ingest_added" / "_dup" / "_ign" / "_err" by status, "ingest_fast"
        (calls the whole-batch fast path served).
        """
        with stats.span("add_symbols"):
            with stats.span("ingest.status"):
                payloads = np.asarray(payloads, np.uint8)
                if payloads.ndim == 1:
                    payloads = payloads[None]
                try:
                    tags_arr = np.asarray(tags, dtype=np.int64)
                except (TypeError, ValueError):
                    tags_arr = np.fromiter((int(t) for t in tags), np.int64, count=len(tags))
                n = tags_arr.shape[0]
                if payloads.shape[0] != n or payloads.shape[1] != self.scheme.T:
                    _count_statuses(np.full(n, SYM_ERR))
                    return [SYM_ERR] * n
                sbns = (tags_arr >> 24) & 0xFF
                esis = tags_arr & 0xFFFFFF
                runs = self._fast_runs(sbns, esis)
                if runs is None:
                    statuses = np.empty(n, np.int64)
                    blocks = np.unique(sbns)
            if runs is not None:
                self._add_symbols_fast(payloads, sbns, esis, io, runs)
                stats.count("ingest_fast")
                stats.count("ingest_symbols", n)
                stats.count("ingest_added", n)
                return [SYM_ADDED] * n
            for sbn in blocks:
                with stats.span("ingest.status"):
                    idxs = np.nonzero(sbns == sbn)[0]
                    if sbn >= self.num_blocks:
                        statuses[idxs] = SYM_ERR
                        continue
                    b = self._block(int(sbn))
                    e = esis[idxs]
                    st = np.full(e.shape, SYM_ADDED, np.int64)
                    st[e > self.max_esi] = SYM_ERR
                    ok = st == SYM_ADDED
                    # duplicates: against already-received and within-batch repeats
                    is_src = e < b.K
                    dup = np.zeros(e.shape, bool)
                    dup[is_src] = b.got[e[is_src]]
                    if b.rep_seen:
                        rep_i = np.nonzero(ok & ~is_src)[0]
                        dup[rep_i] = np.fromiter((int(x) in b.rep_seen for x in e[rep_i]), bool, rep_i.size)
                    first = np.zeros(e.shape, bool)
                    first[np.unique(e, return_index=True)[1]] = True
                    st[ok & (dup | ~first)] = SYM_DUP
                    ok = st == SYM_ADDED
                    # in-order completion: a symbol is IGN if the block was already
                    # complete before it (new source symbols fill gaps as they land)
                    missing = b.K - b.nsrc
                    new_src = ok & is_src
                    filled_before = np.concatenate([[0], np.cumsum(new_src)[:-1]])
                    ign = (st != SYM_ERR) & (filled_before >= missing)
                    st[ign] = SYM_IGN
                    ok = st == SYM_ADDED
                    src = ok & is_src
                    statuses[idxs] = st
                    rep = np.nonzero(ok & ~src)[0]
                    pe = e[src]
                if pe.size:
                    with stats.span("ingest.write"):
                        pidx = idxs[src]
                        if pidx.size > 1 and pidx[-1] - pidx[0] == pidx.size - 1:
                            pl = payloads[pidx[0] : pidx[-1] + 1]  # contiguous: no copy
                        else:
                            pl = payloads[pidx]
                        self._write_symbols_coalesced(io, int(sbn), pe, b.K, pl)
                        b.got[pe] = True
                        b.nsrc += pe.size
                    if b.nsrc < b.K:  # incomplete: keep rows for a later repair
                        with stats.span("ingest.slab"):
                            self._source_rows(int(sbn), b)[pe] = pl
                    # complete: repair is a no-op, the D rows would never be read
                if rep.size:
                    with stats.span("ingest.repair"):
                        b.add_repair(e[rep], payloads[idxs[rep]])
            with stats.span("ingest.status"):
                _count_statuses(statuses)
                return statuses.tolist()

    def _fast_runs(self, sbns, esis):
        """Whether the whole-batch ingestion fast path takes a burst: a
        duplicate-free source-symbol burst into untouched blocks (the common
        0%-loss in-order delivery case), where every status is ADDED by
        construction.  Its object-order runs (order, sorted offsets, run
        starts, the blocks), or None when any precondition fails (the
        general per-block path handles it)."""
        if self.scheme.N != 1 or sbns.size == 0:
            return None
        src = self.scheme.src
        if int(sbns.max()) >= self.num_blocks:
            return None
        Ks = np.where(sbns < src.JL, src.IL, src.IS)
        if (esis >= Ks).any():
            return None
        usbns = np.unique(sbns)
        for s in usbns:
            b = self._blocks.get(int(s))
            if b is not None and (b.nsrc or b.nrep or b.D is not None):
                return None
        T = self.scheme.T
        base = np.where(sbns < src.JL, sbns * src.IL,
                        src.IL * src.JL + (sbns - src.JL) * src.IS) * T
        off = base + esis * T
        d = np.diff(off)
        if (d > 0).all():  # already in object order (the common burst shape)
            order = np.arange(off.size)
            off_s, d_s = off, d
        else:
            order = np.argsort(off, kind="stable")
            off_s = off[order]
            d_s = np.diff(off_s)
        if (d_s == 0).any():
            return None  # within-batch duplicate
        return order, off_s, np.nonzero(d_s != T)[0] + 1, usbns

    def _add_symbols_fast(self, payloads, sbns, esis, io: IOContext, runs) -> None:
        """The fast path's ingestion of a burst `_fast_runs` took: writes
        collapse to one io.write_at per contiguous run.

        The run-coalescing here intentionally parallels
        _write_symbols_coalesced but works on OBJECT offsets across all
        blocks at once — a whole in-order object burst merges into a single
        write, which per-block delegation could not do.
        """
        order, off_s, brk, usbns = runs
        F = self.scheme.F
        with stats.span("ingest.write"):
            for s, e in zip(np.r_[0, brk], np.r_[brk, off_s.size]):
                o0 = int(off_s[s])
                idx = order[s:e]
                if idx[-1] - idx[0] == idx.size - 1 and (idx.size == 1 or bool((np.diff(idx) == 1).all())):
                    chunk = payloads[idx[0] : idx[-1] + 1].reshape(-1)  # in-order: no copy
                else:
                    chunk = payloads[idx].reshape(-1)
                length = min(chunk.size, max(0, F - o0))
                if length > 0:
                    io.write_at(o0, chunk[:length])
        for s in usbns:
            b = self._block(int(s))
            m = sbns == s
            cnt = int(m.sum())
            if cnt == b.K:  # complete: every esi 0..K-1 present exactly once
                b.got[:] = True
                b.nsrc = b.K
            else:  # partial burst: keep rows for a later repair
                pe = esis[m]
                b.got[pe] = True
                b.nsrc = cnt
                with stats.span("ingest.slab"):
                    self._source_rows(int(s), b)[pe] = payloads[m]

    def num_missing(self, sbn: int) -> int:
        b = self._block(sbn)
        return b.K - b.nsrc

    def num_repair(self, sbn: int) -> int:
        return self._block(sbn).nrep

    def _repair_prepare(self, sbn: int):
        """Patched-system inputs for one block: (gaps, isis, overhead) or a
        terminal bool (True: nothing to repair, False: not enough repair)."""
        b = self._block(sbn)
        P = self.P
        gaps = np.nonzero(~b.got)[0].astype(np.int64)
        if gaps.size == 0:
            return True
        if b.nrep < gaps.size:
            return False
        overhead = b.nrep - gaps.size
        pad = P.Kp - b.K

        # patched system: gap LT slots take repair ISIs; overhead rows after
        # (reference patch_precode_matrix, nanorq.c:527-547)
        isis = np.arange(P.Kp + overhead, dtype=np.uint32)
        rep_isis = (b.rep_esis[: b.nrep] + pad).astype(np.uint32)
        isis[gaps] = rep_isis[: gaps.size]
        isis[P.Kp :] = rep_isis[gaps.size :]
        return gaps, isis, overhead

    def _repair_parts(self, items, rows: int) -> tuple[list, list, np.ndarray]:
        """What the patched payload matrices of a run of blocks are built from
        on the device (`parallel.mesh.assemble`): per block its ingestion
        matrix b.D (None: no source symbol arrived), whose gap rows are zero,
        and its repair payloads rep_rows[:gaps + overhead], and the rows
        those go to: the gap rows, then [K', K' + overhead) (reference
        fill_symbol_matrix_gaps, nanorq.c:549-565), block j's offset by j *
        `rows`.  items: [(sbn, gaps, overhead)]."""
        Kp = self.P.Kp
        heads, extra, places = [], [], []
        for j, (sbn, gaps, ov) in enumerate(items):
            b = self._block(sbn)
            heads.append(b.D)
            extra.append(b.rep_rows[: gaps.size + ov])
            places += [j * rows + gaps, np.arange(j * rows + Kp, j * rows + Kp + ov)]
        return heads, extra, np.concatenate(places)

    def _repair_launch_batch(self, items, mesh):
        """Stacked launch for same-(kind, M_pad) WSchedule blocks over the
        lanes of `mesh` (the default path's is `parallel.mesh.local_mesh`):
        the stacked block axis is the split one.  items: [(sbn, gaps,
        overhead, plan)] -> [(sbn, gaps, view)]; the views share one result
        object, which downloads every lane's rows at once.

        Contiguous runs of blocks are dealt to the lanes
        (`parallel.mesh.deal`), the bits / rows / W stacks the same way; each
        lane builds its run's payload stack (`parallel.mesh.shard_assemble`:
        every block's ingestion matrix uploaded from pinned memory as it is,
        its repair rows through one pinned staging copy and one K1 that
        places them) and launches on its stream.  The JAX package pads the
        block count to a multiple of the device count, because its
        `device_put` demands equal shards; here runs may be uneven and a lane
        past the blocks is skipped.  A lane's payload stack holds rows [0,
        live) and one zero row, live = K' + the largest overhead, not M_pad
        rows: every row past `live` is zero, so a gathered row at or past it
        reads the zero row and W's columns there are cut -- the same product
        from half the upload."""
        plans = [p for _, _, _, p in items]
        M_pad, T = plans[0].M_pad, self.scheme.T
        live = min(self.P.Kp + max(ov for _, _, ov, _ in items), M_pad - 1)
        D = lanes.shard_assemble(len(items), mesh, (live + 1, T),
                                 lambda lo, hi: self._repair_parts([it[:3] for it in items[lo:hi]], live + 1))
        # every operand is per block: nothing cached per device to prepare
        if plans[0].Wbits is not None:
            bits, rows = wpath.w_stack_gf2(plans)
            rows = np.minimum(rows, live)[..., None]
            out = D.each(None, lambda _, d, b, r: wpath.w_apply_gf2_batch(b, r, d),
                         lanes.shard_blocks(bits, mesh), lanes.shard_blocks(rows, mesh))
        else:  # column `live` stays: it multiplies the zero row, and the stack goes to K3 as it is
            W = wpath.w_stack_gf256(plans)[:, :, : live + 1]
            out = D.each(None, lambda _, d, w: wpath.w_apply_gf256_batch(w, d), lanes.shard_blocks(W, mesh))
        res = _ShardedResult(out)
        return [(it[0], it[1], _HostView(res, j)) for j, it in enumerate(items)]

    def _repair_launch(self, lane, sbn: int, gaps: np.ndarray, overhead: int, ds):
        """Launch one block's recovery on `lane`; returns a host view of its
        gap rows.  A WSchedule runs one dense-W matmul; a DeviceSchedule the
        structured replay (the program of the schedule's signature, which
        a cold pattern shares with the patterns of its signature met
        before, `ops/program.py`) plus an LT combine of the gap ISIs.  What
        block's patched matrix [M_pad, T] is built on the lane's stream
        (`parallel.mesh.assemble`: the ingestion matrix uploaded from pinned
        memory, the repair rows placed by one K1, every other row zero: the
        structured replay reads all M_pad; span `repair.assemble`); then what
        is cached per device is fetched, on the current stream, which the
        lane's stream waits for, and the recovery launched (span
        `repair.apply`; a DeviceSchedule's > `repair.replay`, its arrays, its
        program and the replay, and `repair.lt`, the gap ISIs' plan and the
        LT combine)."""
        with stats.span("repair.assemble"):
            D_dev = lanes.assemble(lane, (1, ds.M_pad, self.scheme.T),
                                   *self._repair_parts([(sbn, gaps, overhead)], ds.M_pad))[0]
        with stats.span("repair.apply"):
            if isinstance(ds, _cache.WSchedule):
                ds.staged(lane.device)
                with lane.on():
                    out = ds.apply(D_dev)
            else:
                with stats.span("repair.replay"):
                    arr = device_arrays(ds, lane.device)
                    with lane.on():
                        C = program.replay(arr, D_dev)
                with stats.span("repair.lt"):
                    plan = lt_plan(gaps.astype(np.uint32), self.P, lane.device)
                    with lane.on():
                        out = lt_combine(C, plan)
            return _HostView(_HostResult(out[: gaps.size], lane))

    def _repair_finish(self, io: IOContext, sbn: int, gaps: np.ndarray, sym) -> bool:
        b = self._block(sbn)
        if sym is not None:  # None: already written through (_out_row_ptrs)
            recovered = np.asarray(sym)[: gaps.size]
            self._write_symbols_coalesced(io, sbn, gaps, b.K, recovered)
        b.got[gaps] = True
        b.nsrc += gaps.size
        return self.num_missing(sbn) == 0

    def repair_block(self, io: IOContext, sbn: int) -> bool:
        """Recover the block's missing source symbols on the device.  Span
        `repair_block` > `repair.prepare` (the patched system's ISIs, the
        lane), `repair.plan` (`codec.cache.decoder_plan`), `repair.assemble`,
        `repair.apply` (`_repair_launch`), `repair.finish` (the download,
        `fetch`, and the write-out).  Counter `repair_structured_blocks` or
        `repair_dense_blocks`: the kind of the block's plan, a DeviceSchedule
        or a WSchedule."""
        with stats.span("repair_block"):
            with stats.span("repair.prepare"):
                prep = self._repair_prepare(sbn)
                if isinstance(prep, bool):
                    return prep
                lane = lanes.local_mesh(self.device).lanes[0]
            gaps, isis, overhead = prep
            with stats.span("repair.plan"):
                ds = _cache.decoder_plan(self.P, isis, overhead)
            if ds is None:
                stats.count("repair_block_failed")
                return False  # rank deficient: feed more symbols, retry
            stats.count("repair_dense_blocks" if isinstance(ds, _cache.WSchedule) else "repair_structured_blocks")
            sym = self._repair_launch(lane, sbn, gaps, overhead, ds)
            with stats.span("repair.finish"):
                return self._repair_finish(io, sbn, gaps, sym)

    def _row_ptrs(self, sbn: int, gaps: np.ndarray, overhead: int, NB: int) -> np.ndarray:
        """Per-row payload addresses of the patched system's NB rows —
        the zero-copy analog of `_repair_parts` for the native host arm: sources
        point into the ingestion matrix b.D, gap/overhead slots into the
        repair payloads, padding + constraint rows at a shared zero row.
        Every backing buffer is owned by self._blocks[sbn] (alive across
        the native call); the native side only READS through these."""
        b = self._block(sbn)
        T = self.scheme.T
        ptrs = np.full(NB, _zero_row(T).ctypes.data, np.uint64)
        if b.D is not None:
            have = np.nonzero(b.got)[0]
            ptrs[have] = np.uint64(b.D.ctypes.data) + have.astype(np.uint64) * np.uint64(
                b.D.strides[0]
            )
        ng = gaps.size
        rep0 = np.uint64(b.rep_rows.ctypes.data)
        rstride = np.uint64(b.rep_rows.strides[0])
        ptrs[gaps] = rep0 + np.arange(ng, dtype=np.uint64) * rstride
        Kp = self.P.Kp
        ptrs[Kp : Kp + overhead] = rep0 + np.arange(ng, ng + overhead, dtype=np.uint64) * rstride
        return ptrs

    def _out_row_ptrs(self, io: IOContext, sbn: int, gaps: np.ndarray) -> np.ndarray | None:
        """Per-gap output addresses straight into the decode object, or None
        when direct write-through doesn't apply (sub-blocked layout, non-
        buffer IO, or a clamped tail symbol).  Lets the native repair write
        recovered rows once, with no post-repair copy."""
        if self.scheme.N != 1:
            return None
        buf = getattr(io, "buffer", None)
        if buf is None or not io.writable or not buf.flags["C_CONTIGUOUS"] or buf.size < self.scheme.F:
            return None
        T = self.scheme.T
        base = symbol_ranges(self.scheme, sbn, 0, self._block(sbn).K)[0][0]
        offs = base + gaps.astype(np.uint64) * np.uint64(T)
        if gaps.size and int(offs[-1]) + T > self.scheme.F:  # short tail symbol
            return None
        return np.uint64(buf.ctypes.data) + offs

    def _repair_host_batch(self, work, io: IOContext | None = None):
        """CPU arm of the adaptive decode runtime: one native call fusing
        per-pattern system build + solve + substitution + LT gap combine for
        a batch of blocks (native.host_repair_shared — the reference's
        nanorq_repair_block shape, lib/nanorq.c:591-630, with zero device
        traffic and zero payload copies: the native call reads rows in place
        via _row_ptrs and, when the output object is a writable buffer,
        writes recovered rows straight into it via _out_row_ptrs).

        work: [(sbn, gaps, isis, overhead)].  Returns (ok, results) with
        results = [(sbn, gaps, recovered_np | None)] for successful blocks
        (None = already written through to io); rank-deficient blocks count
        as failures (feed more symbols, retry)."""
        P, T = self.P, self.scheme.T
        base = _cache._base_rows(P)
        Kp = P.Kp
        blocks, metas = [], []
        for sbn, gaps, isis, ov in work:
            ng = gaps.size
            rep_isis = np.empty(ng + ov, np.uint32)
            rep_isis[:ng] = isis[gaps]
            rep_isis[ng:] = isis[Kp : Kp + ov]
            orowp = None if io is None else self._out_row_ptrs(io, sbn, gaps)
            blocks.append((gaps, rep_isis, self._row_ptrs(sbn, gaps, ov, Kp + ov + P.S), orowp))
            metas.append((sbn, gaps))
        with stats.timer("host_repair"):
            res = host_repair_shared(P, base, blocks, T)
        if res is None:  # native library unavailable: caller reroutes
            return None
        outs, statuses = res
        stats.count("repair_host_blocks", len(blocks))
        ok, results = True, []
        for (sbn, gaps), (_, _, _, orowp), out, status in zip(metas, blocks, outs, statuses):
            if status == 0:
                results.append((sbn, gaps, None if orowp is not None else out))
            else:
                stats.count("decode_rank_deficient")
                stats.count("repair_block_failed")
                ok = False
        return ok, results

    def _repair_residual_host_batch(self, work, io: IOContext | None = None):
        """Solve-free CPU repair (nanorq_tpu's _repair_residual_host_batch,
        line for line, with the port's res_wrows_flat): X = R (y ^ W D0) run by
        the native host_residual_flat, reading payloads in place and writing
        recovered rows straight into a writable buffer `io`.

        work: [(sbn, gaps, isis, overhead)] -> (ok, [(sbn, gaps, rows | None)]),
        or None when the native factorization is unavailable (the caller
        reroutes to the host arm)."""
        P, T = self.P, self.scheme.T
        scheme = self.scheme
        kc = _cache.res_kcols(P)
        Kp = P.Kp
        nb = len(work)
        with stats.span("res_prep"):
            buf_base = None
            if io is not None and scheme.N == 1:
                buf = getattr(io, "buffer", None)
                if (buf is not None and io.writable and buf.flags["C_CONTIGUOUS"]
                        and buf.size >= scheme.F):
                    buf_base = np.uint64(buf.ctypes.data)
            isi_list, gaps_list = [], []
            for sbn, gaps, isis, ov in work:
                ng = gaps.size
                rep_isis = np.empty(ng + ov, np.uint32)
                rep_isis[:ng] = isis[gaps]
                rep_isis[ng:] = isis[Kp : Kp + ov]
                isi_list.append(rep_isis)
                gaps_list.append(gaps)
            flat = _cache.res_wrows_flat(P, isi_list)
            if flat is None:
                return None
            W_all, _, nrs = flat
            ngaps = np.fromiter((g.size for g in gaps_list), np.int64, nb)
            gaps_all = np.concatenate(gaps_list).astype(np.int32) if nb else np.zeros(0, np.int32)
            gaps_off = np.zeros(nb, np.int64)
            if nb > 1:
                np.cumsum(ngaps[:-1], out=gaps_off[1:])
            d0p_all = np.zeros(nb * kc, np.uint64)
            yp_all = np.empty(int(nrs.sum()), np.uint64)
            orow_all = np.empty(int(ngaps.sum()), np.uint64)
            temps: list = [None] * nb
            yo = oo = 0
            for j, (sbn, gaps, isis, ov) in enumerate(work):
                ng, nr = gaps.size, int(nrs[j])
                b = self._block(sbn)
                if b.D is not None:
                    have = np.nonzero(b.got)[0]
                    d0p_all[j * kc + have] = np.uint64(b.D.ctypes.data) + have.astype(
                        np.uint64) * np.uint64(b.D.strides[0])
                yp_all[yo : yo + nr] = np.uint64(b.rep_rows.ctypes.data) + np.arange(
                    nr, dtype=np.uint64) * np.uint64(b.rep_rows.strides[0])
                yo += nr
                op = None
                if buf_base is not None:
                    base = symbol_ranges(scheme, sbn, 0, b.K)[0][0]
                    offs = base + gaps.astype(np.uint64) * np.uint64(T)
                    if not (ng and int(offs[-1]) + T > scheme.F):  # short tail
                        op = buf_base + offs
                if op is None:
                    temps[j] = np.empty((ng, T), np.uint8)
                    op = np.uint64(temps[j].ctypes.data) + np.arange(ng, dtype=np.uint64) * np.uint64(T)
                orow_all[oo : oo + ng] = op
                oo += ng
        with stats.timer("host_residual"):
            statuses = host_residual_flat(kc, T, nrs, ngaps, gaps_all, gaps_off, W_all, d0p_all,
                                          yp_all, orow_all)
        if statuses is None:
            return None
        stats.count("repair_res_host_blocks", nb)
        ok, results = True, []
        for j, (sbn, gaps, _, _) in enumerate(work):
            if statuses[j] == 0:
                results.append((sbn, gaps, temps[j]))
            else:
                stats.count("decode_rank_deficient")
                stats.count("repair_block_failed")
                ok = False
        return ok, results

    def _repair_residual_batch(self, work):
        """Residual arm (nanorq_tpu's _repair_residual_batch): repair without a
        per-pattern solve.  A received repair symbol is y = w . D over the
        canonical system, so y = W D0 + G X with G = W[:, gaps]; the host
        finds G's left inverse R (native res_rinv) and the device computes
        X = R (y ^ W D0) for a chunk of up to _BATCH_FLUSH blocks at once
        (wpath.res_apply_batch).  Rows and columns are padded to the chunk's
        largest block, not to a power of two: eager CUDA compiles nothing per
        shape, and zero rows are exact no-ops.

        work: [(sbn, gaps, isis, overhead)] -> (ok, [(sbn, gaps, view)]); a
        rank-deficient G fails its block.  Raises RuntimeError when the
        native factorization is unavailable."""
        P, T = self.P, self.scheme.T
        kc = _cache.res_kcols(P)
        metas, Ws, Gs = [], [], []
        with stats.span("res_prep"):
            for sbn, gaps, isis, ov in work:
                W = _cache.res_wrows(P, np.concatenate([isis[gaps], isis[P.Kp : P.Kp + ov]]))
                if W is None:
                    raise RuntimeError(_NO_FACTOR)
                metas.append((sbn, gaps))
                Ws.append(W)
                Gs.append(np.ascontiguousarray(W[:, gaps]))
        with stats.span("res_rinv"):
            rr = res_rinv(Gs)
        if rr is None:
            raise RuntimeError(_NO_FACTOR)
        ok, items = True, []
        for meta, W, R, status in zip(metas, Ws, *rr):
            if status == 0:
                items.append((meta, W, R))
            else:
                stats.count("decode_rank_deficient")
                stats.count("repair_block_failed")
                ok = False
        stats.count("repair_res_blocks", len(items))
        lane, launched = lanes.local_mesh(self.device).lanes[0], []

        def put_W(h, meta, W, R):
            h[: W.shape[0]] = W

        def put_R(h, meta, W, R):
            h[: meta[1].size, : W.shape[0]] = R

        def put_D0(h, meta, W, R):
            b = self._block(meta[0])
            if b.D is not None:
                n = min(b.D.shape[0], kc)
                h[:n] = b.D[:n]

        def put_y(h, meta, W, R):
            h[: W.shape[0]] = self._block(meta[0]).rep_rows[: W.shape[0]]

        for c0 in range(0, len(items), self._BATCH_FLUSH):
            chunk = items[c0 : c0 + self._BATCH_FLUSH]
            nr = max(W.shape[0] for _, W, _ in chunk)
            g = max(m[1].size for m, _, _ in chunk)

            def stack(shape, put, chunk=chunk):
                """A zeroed stack [blocks, *shape] with put(h[j], *item j), in pinned staging."""
                def fill(host):
                    h = host.numpy()
                    h[...] = 0
                    for j, item in enumerate(chunk):
                        put(h[j], *item)
                return lanes.stage(lane, (len(chunk), *shape), fill)

            out = wpath.res_apply_batch(stack((nr, kc), put_W), stack((kc, T), put_D0),
                                        stack((g, nr), put_R), stack((nr, T), put_y))
            res = _HostResult(out, lane)
            launched.extend((m[0], m[1], _HostView(res, j)) for j, (m, _, _) in enumerate(chunk))
        return ok, launched

    # WSchedule blocks accumulate into stacked dispatches of up to this many
    # blocks (pow2-padded shapes bound compile diversity; chunking keeps
    # device work flowing while later solves run)
    _BATCH_FLUSH = 32

    def _repair_pipeline(self, max_workers: int | None = None, mesh=None, backend: str | None = None,
                         io: IOContext | None = None):
        """Route every gap block to an arm and launch it; (ok, launched) as in
        nanorq_tpu (see the module docstring for the backends).  A mesh forces
        the device arm: the host arms are single-node."""
        backend = backend or os.environ.get("NANORQ_DECODE_BACKEND", "auto")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        if mesh is not None:
            lanes.check_mesh(mesh)
        work, ok = [], True
        for sbn in range(self.num_blocks):
            prep = self._repair_prepare(sbn)
            if isinstance(prep, bool):
                ok = ok and prep
            else:
                work.append((sbn, *prep))
        if not work:
            return ok, []
        if mesh is not None or backend == "device" or not native_available():
            dok, launched = self._repair_pipeline_device(work, max_workers, mesh)
            return ok and dok, launched
        if backend == "res":
            rok, launched = self._repair_residual_batch(work)
            return ok and rok, launched

        rhost_work, host_work, dev_work = [], [], []
        if backend == "host":
            host_work = work
        elif backend == "res_host":
            rhost_work = work
        else:  # auto: the port's rule (module docstring)
            queue = {"device": dev_work, "res_host": rhost_work, "host": host_work}
            for item in work:
                hit, plan = _cache.decoder_plan_cached(self.P, item[2], item[3])
                queue[auto_arm(self.P.Kp, hit and plan is not None)].append(item)
        launched = []
        if rhost_work:
            rres = self._repair_residual_host_batch(rhost_work, io)
            if rres is None:  # no native factorization: the patched host solve
                host_work = host_work + rhost_work
            else:
                rok, results = rres
                ok = ok and rok
                launched.extend(results)
        if host_work:
            res = self._repair_host_batch(host_work, io)
            if res is None:  # native vanished mid-flight: everything on the device
                dev_work, launched = work, []
            else:
                hok, results = res
                ok = ok and hok
                launched.extend(results)
        if dev_work:
            dok, dlaunched = self._repair_pipeline_device(dev_work, max_workers)
            ok = ok and dok
            launched.extend(dlaunched)
        return ok, launched

    def _repair_pipeline_device(self, work, max_workers: int | None = None, mesh=None):
        """Device arm: per-pattern plans solved in one worker thread while
        this thread launches each block as its solve lands; WSchedule
        blocks of one (kind, M_pad) are stacked into batches.  Under a mesh
        a batch is split over the lanes, even one of a single block, and
        structured plans launch block by block on the lanes in turn; with no
        mesh, everything runs on the local mesh's one lane (the device's
        current stream, pinned transfers of the live rows).  This thread
        alone launches: the kernels' launch counts are plain state."""
        stats.count("repair_device_blocks", len(work))
        ok, launched, pend = True, [], {}
        on = lanes.local_mesh(self.device) if mesh is None else mesh
        turn = itertools.cycle(on.lanes)

        def flush(key):
            items = pend.pop(key, [])
            if len(items) == 1 and mesh is None:
                s, g, ov, ds = items[0]
                launched.append((s, g, self._repair_launch(on.lanes[0], s, g, ov, ds)))
            elif items:
                launched.extend(self._repair_launch_batch(items, on))

        with ThreadPoolExecutor(max_workers=max_workers or 1) as ex:
            futs = [(s, g, ov, ex.submit(_cache.decoder_plan, self.P, isis, ov))
                    for s, g, isis, ov in work]
            for sbn, gaps, ov, fut in futs:
                ds = fut.result()
                if ds is None:
                    stats.count("repair_block_failed")
                    ok = False
                elif isinstance(ds, _cache.WSchedule):
                    key = (ds.Wbits is not None, ds.M_pad)
                    pend.setdefault(key, []).append((sbn, gaps, ov, ds))
                    if len(pend[key]) >= self._BATCH_FLUSH:
                        flush(key)
                else:
                    launched.append((sbn, gaps, self._repair_launch(next(turn), sbn, gaps, ov, ds)))
            for key in list(pend):
                flush(key)
        return ok, launched

    def repair_all(self, io: IOContext, max_workers: int | None = None, mesh=None,
                   backend: str | None = None) -> bool:
        """Repair every block through the adaptive runtime.

        Cold loss patterns run on the native CPU arm (solve + substitution
        fused, zero device traffic — _repair_host_batch); warm patterns
        replay their cached compiled plans on device, pipelined (SURVEY.md
        §7 hard-part 5): per-pattern host solves run in a worker thread
        while device replays dispatch as each solve lands, W-plan blocks
        stacked into batched dispatches.  Pass a `parallel.mesh.Mesh` to split
        those batches over its lanes (per-block independence needs no
        collectives; forces the device arm).  `backend` overrides the arm:
        "auto" (default, env NANORQ_DECODE_BACKEND) / "res" / "device" /
        "host".

        Returns True iff every block is fully recovered."""
        ok, launched = self._repair_pipeline(max_workers, mesh=mesh, backend=backend, io=io)
        for sbn, gaps, sym in launched:
            ok = self._repair_finish(io, sbn, gaps, sym) and ok
        return ok
