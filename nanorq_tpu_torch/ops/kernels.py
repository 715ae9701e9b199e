"""Wrappers of the payload kernels (`csrc/*.cu`): K1-K3 and the three gather
probes (`csrc/gather_probe.cu`); and of the pitched upload (`copy2d`,
`csrc/copy2d.cu`), counted in `COPIES`.

Each wrapper checks what it is given and raises on anything its kernel does
not take.  On CPU tensors it runs the plain torch version in `ops/gfmat.py`;
on CUDA tensors it launches the kernel on the current stream, or raises --
there is no fallback.  `LAUNCHES[name]` counts kernel launches (CUDA only),
so a run can show that its main path went through the kernels.  An index
that gather_xor cannot take raises on the CPU; on CUDA the kernel sets a
device flag that `take_index_errors` reads; likewise a wrong host count
given to gather_v2 (`take_count_errors`).

Every wrapper takes an optional `out`: when given, the result is XORed into
it in place (the replay accumulates gathers and products into row blocks it
owns) instead of being returned in a fresh tensor.  A fresh output on a card
comes from `ops/program.empty`: where the card is out of memory, its cached
replay programs are evicted and the allocation is made once more.

A launch captured into a CUDA graph (`ops/program.py`) does not run where it
is captured: inside `tape()` the wrappers count and record it on a `Tape`,
and `play(tape)` adds it to LAUNCHES (and to `record_gathers`) wherever a
replay of the graph runs it.
"""

import contextlib

import numpy as np
import torch

from nanorq_tpu_torch.gf256.tables import OCT_EXP, OCT_LOG
from nanorq_tpu_torch.ops import _build, gfmat

LAUNCHES = {"gather_xor": 0, "gf2_matmul": 0, "gf256_matmul": 0,
            "gather_v1": 0, "gather_v2": 0, "gather_db": 0}
COPIES = {"copy2d": 0}  # the DMA copies `copy2d` issued (CUDA only): no kernel, counted apart


def reset_launches() -> None:
    for counts in (LAUNCHES, COPIES):
        for name in counts:
            counts[name] = 0


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _bytes(x: torch.Tensor, name: str, dim: int = 2) -> None:
    _need(isinstance(x, torch.Tensor) and x.dtype == torch.uint8 and x.dim() == dim,
          f"{name}: expected a {dim}-D uint8 tensor, got {getattr(x, 'dtype', type(x))} "
          f"{tuple(getattr(x, 'shape', ()))}")
    _need(x.is_contiguous(), f"{name}: must be contiguous")


def _out(out, shape, *inputs: torch.Tensor):
    """Check an out= tensor: its shape, its device, and that it shares no
    bytes with an input (the kernels read and write through __restrict__)."""
    if out is None:
        return None
    _bytes(out, "out", len(shape))
    _need(tuple(out.shape) == tuple(shape), f"out: shape {tuple(out.shape)} != {tuple(shape)}")
    o0 = out.data_ptr()
    o1 = o0 + out.numel()
    for x in inputs:
        _need(out.device == x.device, "out: on another device than the inputs")
        x0 = x.data_ptr()
        _need(o1 <= x0 or x0 + x.numel() * x.element_size() <= o0, "out: overlaps an input")
    return out


def _plain(res: torch.Tensor, out):
    if out is None:
        return res
    out ^= res
    return out


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _fresh(shape: tuple, dev: torch.device) -> torch.Tensor:
    """An uninitialized uint8 output on the card `dev`, reclaiming the card's
    replay programs where it is out of memory (`ops/program.empty`)."""
    from nanorq_tpu_torch.ops import program  # program imports this module

    return program.empty(shape, torch.uint8, dev)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _device_kind(*xs: torch.Tensor) -> str:
    dev = xs[0].device
    for x in xs[1:]:
        _need(x.device == dev, f"inputs on different devices: {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


# CUDA device -> int32 [1] device flag, set by a gather on an index outside
# [0, S) (_INDEX_ERR), or by gather_v2 given a wrong host count (_COUNT_ERR)
_INDEX_ERR: dict = {}
_COUNT_ERR: dict = {}


def _take(flags: dict, device) -> bool:
    flag = flags.get(torch.device(device))
    if flag is None:
        return False
    bad = bool(flag.item())
    flag.zero_()
    return bad


def take_index_errors(device: torch.device) -> bool:
    """Whether a gather launch on the CUDA `device` met an index outside
    [0, S) since the last call, and clear the flag.  Waits for the device."""
    return _take(_INDEX_ERR, device)


def take_count_errors(device: torch.device) -> bool:
    """Whether a gather_v2 launch on the CUDA `device` was given a count that
    differs from the device's own since the last call, and clear the flag."""
    return _take(_COUNT_ERR, device)


def _flag(flags: dict, dev: torch.device) -> torch.Tensor:
    flag = flags.get(dev)
    if flag is None:
        flag = flags[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return flag


class Tape:
    """The launches one CUDA graph holds, taken while it was captured: per
    kernel the count each replay adds to LAUNCHES, and the gathers' operands
    (as `record_gathers` lists them) each replay shows a recording."""

    __slots__ = ("launches", "gathers")

    def __init__(self):
        self.launches, self.gathers = {}, []


@contextlib.contextmanager
def tape():
    """Inside, launches are captured into a CUDA graph and do not run: they
    are counted and recorded on the Tape yielded, and neither in LAUNCHES nor
    in an outer `record_gathers`."""
    global _RECORD, _RECORD_MAX
    before, outer = dict(LAUNCHES), (_RECORD, _RECORD_MAX)
    tp = Tape()
    _RECORD, _RECORD_MAX = tp.gathers, None
    try:
        yield tp
    finally:
        tp.launches = {name: LAUNCHES[name] - n for name, n in before.items() if LAUNCHES[name] != n}
        LAUNCHES.update(before)
        _RECORD, _RECORD_MAX = outer


def play(tp: Tape) -> None:
    """Count the launches of one replay of the graph `tp` was taken from."""
    for name, n in tp.launches.items():
        LAUNCHES[name] += n
    if _RECORD is not None:
        room = len(tp.gathers) if _RECORD_MAX is None else max(0, _RECORD_MAX - len(_RECORD))
        _RECORD.extend(tp.gathers[:room])


def check_rows(rows, n_out: int) -> None:
    """Refuse output rows (numpy or torch, 1-D) that repeat or lie outside
    [0, n_out): gather_xor's `rows` writes each row once, without atomics."""
    rows = np.asarray(rows.cpu() if isinstance(rows, torch.Tensor) else rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_out):
        raise ValueError(f"rows: an output row lies outside [0, {n_out})")
    if np.unique(rows).size != rows.size:
        raise ValueError("rows: an output row repeats")


_RECORD: list | None = None  # set inside record_gathers()
_RECORD_MAX: int | None = None


@contextlib.contextmanager
def record_gathers(limit: int | None = None):
    """Inside, every gather_xor launch on CUDA also appends its operands to
    the list yielded, as {"src", "idx", "out", "rows", "zero_index",
    "overwrite"} (out: None for a fresh result), so that a tool can time
    each launch of a path again (`tools/gather_launches.py`).  With `limit`, only the first
    `limit` launches: the list holds their tensors alive, and no later's."""
    global _RECORD, _RECORD_MAX
    rec = []
    _RECORD, _RECORD_MAX = rec, limit
    try:
        yield rec
    finally:
        _RECORD = None


def gather_xor(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None, *,
               rows: torch.Tensor | None = None, zero_index: int | None = None,
               check: bool = False, overwrite: bool = False) -> torch.Tensor:
    """K1: out[i] = XOR_k src[idx[i, k]];  src uint8 [S, t], idx int32 [n, w].

    overwrite (needs `out`, no `rows`): the result is written into out, not
    XORed into it (the replay's prologue fills buffers its program owns).

    rows (int32 [n], distinct, needs `out`): result row i is XORed into
    out[rows[i]], and no other row of out is touched; out may then have any
    number of rows.  The callers check their rows once, where they build
    them (`check_rows`); the CPU path checks them on every call.

    Indices must lie in [0, S).  zero_index=S, opt-in, makes index S read
    as a zero row with no row of src behind it.  Any other index outside
    raises IndexError: always on the CPU; on CUDA the kernel flags it (and
    an output row outside out) on the device, and the wrapper raises when
    `check` is set (which waits for the kernel) -- else the flag stays set
    for `take_index_errors`."""
    _bytes(src, "src")
    _need(idx.dtype == torch.int32 and idx.dim() == 2 and idx.is_contiguous(),
          f"idx: expected a contiguous 2-D int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    S, t = src.shape
    n, w = idx.shape
    _need(zero_index is None or zero_index == S, f"zero_index: {zero_index}, must be S={S}")
    inputs = (src, idx)
    if rows is not None:
        _need(out is not None, "rows: names rows of out, and no out was given")
        _need(rows.dtype == torch.int32 and tuple(rows.shape) == (n,) and rows.is_contiguous(),
              f"rows: expected a contiguous int32 [{n}], got {rows.dtype} {tuple(rows.shape)}")
        inputs += (rows,)
    _need(not overwrite or (out is not None and rows is None), "overwrite: needs out and no rows")
    out = _out(out, (n if rows is None else out.shape[0], t), *inputs)
    hi = S if zero_index is None else S + 1
    if _device_kind(*inputs) == "cpu":
        if n and w and (int(idx.min()) < 0 or int(idx.max()) >= hi):
            raise IndexError(f"gather_xor: an index lies outside [0, {hi})")
        if rows is not None:
            check_rows(rows, out.shape[0])
        if overwrite:
            return out.copy_(gfmat.xor_reduce_gather(src, idx, zero_index=zero_index))
        return gfmat.xor_reduce_gather(src, idx, out=out, rows=rows, zero_index=zero_index)
    acc = out is not None and not overwrite
    res = out if out is not None else _fresh((n, t), src.device)
    if n and t:
        lib = _build.load()
        with torch.cuda.device(src.device):
            _launch("gather_xor", lib.nrq_gather_xor, src.data_ptr(), S, t, idx.data_ptr(), n, w,
                    None if rows is None else rows.data_ptr(), res.shape[0], res.data_ptr(), int(acc),
                    int(zero_index is not None), _flag(_INDEX_ERR, src.device).data_ptr(),
                    _stream(src.device))
        if _RECORD is not None and (_RECORD_MAX is None or len(_RECORD) < _RECORD_MAX):
            _RECORD.append({"src": src, "idx": idx, "out": out, "rows": rows, "zero_index": zero_index,
                            "overwrite": overwrite})
        if check and take_index_errors(src.device):
            raise IndexError(f"gather_xor: an index lies outside [0, {hi}) or a row outside out")
    return res


def _batch_args(A: torch.Tensor, X: torch.Tensor, nameA: str):
    """Shapes of a 2-D product or a 3-D batch of them: (dim, nb, mA, pA, k, t)."""
    _need(isinstance(A, torch.Tensor) and A.dim() in (2, 3), f"{nameA}: expected a 2-D or 3-D tensor")
    dim = A.dim()
    _bytes(A, nameA, dim)
    _bytes(X, "X", dim)
    nb = A.shape[0] if dim == 3 else 1
    _need(dim == 2 or X.shape[0] == nb, f"X: {X.shape[0]} blocks for {nb} blocks of {nameA}")
    return dim, nb, A.shape[-2], A.shape[-1], X.shape[-2], X.shape[-1]


def _words(A: torch.Tensor) -> torch.Tensor:
    """A with its last axis padded to a multiple of 16 bytes and its base
    16-byte aligned, as the core's 16-byte tile copies need (a copy only
    when it is not so already)."""
    pad = -A.shape[-1] % 16
    if pad:
        A = torch.nn.functional.pad(A, (0, pad))
    if A.data_ptr() % 16:
        A = A.clone()
    return A


def gf2_matmul(bits: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: out[r] = XOR_{c: bit(r,c)} X[c];  bits uint8 [m, >=ceil(k/8)] packed
    little-endian (bit c of row r = bits[r, c//8] >> (c%8) & 1), X uint8 [k, t].

    Batched: bits [nb, m, pitch] and X [nb, k, t] -> [nb, m, t], the nb
    products in one launch (the kernel's grid z is the block)."""
    dim, nb, m, pitch, k, t = _batch_args(bits, X, "bits")
    _need(pitch * 8 >= k, f"bits: {pitch} bytes per row cannot hold k={k} columns")
    shape = (nb, m, t) if dim == 3 else (m, t)
    out = _out(out, shape, bits, X)
    if _device_kind(bits, X) == "cpu":
        if dim == 2:
            return _plain(gfmat.gf2_matmul(gfmat.unpack_bits(bits)[:, :k], X), out)
        res = X.new_empty(shape)
        for j in range(nb):
            res[j] = gfmat.gf2_matmul(gfmat.unpack_bits(bits[j])[:, :k], X[j])
        return _plain(res, out)
    if k == 0:  # an empty contraction: nothing to launch
        return out if out is not None else _fresh(shape, X.device).zero_()
    acc = out is not None
    res = out if acc else _fresh(shape, X.device)
    if nb and m and t:
        A = _words(bits)
        pa = A.shape[-1]
        lib = _build.load()
        with torch.cuda.device(X.device):
            _launch("gf2_matmul", lib.nrq_gf2_matmul, nb, A.data_ptr(), m, k, pa, m * pa,
                    X.data_ptr(), t, k * t, res.data_ptr(), m * t, int(acc), _stream(X.device))
    return res


_TABLES: dict = {}  # device -> (log uint16-as-int16 [256], exp uint8 [1024])


def _gf_tables(dev: torch.device):
    tabs = _TABLES.get(dev)
    if tabs is None:
        log = OCT_LOG.astype(np.int16)
        log[0] = 512  # sentinel: log[0] + any log lands in exp's zero half
        exp = np.zeros(1024, np.uint8)
        exp[:510] = OCT_EXP[:510]
        tabs = _TABLES[dev] = (torch.from_numpy(log).to(dev), torch.from_numpy(exp).to(dev))
    return tabs


def prepare(device: torch.device) -> None:
    """Create what the wrappers keep per CUDA device (the index flag, K3's
    tables) now, on the current stream.  They are otherwise made at the first
    launch, on whatever stream that runs on: a caller that launches on
    several streams of one device calls this first and has each stream wait
    for the current one."""
    dev = torch.device(device)
    if dev.type == "cuda":
        _flag(_INDEX_ERR, dev)
        _gf_tables(dev)


# K3's two forms: the companion-bit product on K2's four-Russians core, and
# the direct log/exp design; tools/matmul_forms.py times the rule's form at
# every main-path shape.
GF256_M4R, GF256_LOGEXP = 0, 1
GF256_LOGEXP_MIN_T = 1 << 16  # payload width from which log/exp takes over ...
GF256_LOGEXP_MAX_M = 16  # ... for products of at most this many rows


def gf256_form(m: int, t: int) -> int:
    """The rule that picks K3's form for a shape: the four-Russians form,
    except for a wide product (t >= 2**16) of few rows (m <= 16), which goes
    to log/exp -- the encoder's HDPC product over an object (10 rows): the
    four-Russians tables are built per block of 64 rows, and with 10 of them
    the build is not paid back (PERF.md)."""
    if t >= GF256_LOGEXP_MIN_T and m <= GF256_LOGEXP_MAX_M:
        return GF256_LOGEXP
    return GF256_M4R


def gf256_matmul(M: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: out[r] = XOR_c M[r,c] (x) X[c] over GF(256);  M uint8 [m, k], X uint8 [k, t].

    Batched: M [nb, m, k] and X [nb, k, t] -> [nb, m, t], the nb products in
    one launch (the kernel's grid z is the block).  `gf256_form` picks the
    kernel's form for the shape."""
    dim, nb, m, k, kx, t = _batch_args(M, X, "M")
    _need(kx == k, f"X: {kx} rows for a {k}-column M")
    shape = (nb, m, t) if dim == 3 else (m, t)
    out = _out(out, shape, M, X)
    if _device_kind(M, X) == "cpu":
        return _plain(gfmat.gf256_matmul_batch(M, X) if dim == 3 else gfmat.gf256_matmul(M, X), out)
    if k == 0:  # an empty contraction: nothing to launch
        return out if out is not None else _fresh(shape, X.device).zero_()
    acc = out is not None
    res = out if acc else _fresh(shape, X.device)
    if nb and m and t:
        lib = _build.load()
        if gf256_form(m, t) == GF256_M4R:
            A = _words(M)
            pa = A.shape[-1]
            with torch.cuda.device(X.device):
                _launch("gf256_matmul", lib.nrq_gf256_m4r, nb, A.data_ptr(), m, k, pa, m * pa, X.data_ptr(),
                        t, k * t, res.data_ptr(), m * t, int(acc), _stream(X.device))
        else:
            log, exp = _gf_tables(X.device)
            with torch.cuda.device(X.device):
                _launch("gf256_matmul", lib.nrq_gf256_logexp, nb, M.data_ptr(), m, k, m * k, X.data_ptr(),
                        t, k * t, log.data_ptr(), exp.data_ptr(), res.data_ptr(), m * t, int(acc),
                        _stream(X.device))
    return res


# --- the pitched upload (csrc/copy2d.cu) --------------------------------------

_IN_FLIGHT: list = []  # (event, host tensor) of each 2-D copy that its stream may not have passed


def _pitched(x: torch.Tensor, name: str, shape) -> int:
    """Check a 2-D matrix of unit column stride (rows may lie apart); its
    row pitch in bytes."""
    _need(isinstance(x, torch.Tensor) and x.dim() == 2, f"{name}: expected a 2-D tensor")
    _need(tuple(x.shape) == tuple(shape), f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.numel():
        return x.shape[1] * x.element_size()
    _need(x.shape[1] <= 1 or x.stride(1) == 1, f"{name}: its columns must be contiguous")
    _need(x.shape[0] <= 1 or x.stride(0) >= x.shape[1], f"{name}: rows overlap (pitch {x.stride(0)})")
    return max(x.stride(0), x.shape[1]) * x.element_size()


def copy2d(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """dst = src for a host matrix src [rows, w] whose rows need not be
    contiguous (a column range of a wider matrix: unit column stride, row
    pitch >= w), into dst of the same shape and dtype with unit column
    stride.

    On a CUDA dst, src must be pinned: one cudaMemcpy2DAsync on the current
    stream of dst's device reads it where it lies (`csrc/copy2d.cu`), with no
    staging copy, and a failure raises.  PyTorch's pinned allocator records
    an event only for the copies it issues itself, so the wrapper keeps src
    alive until that stream has passed this copy (an event recorded after
    it, held with src in `_IN_FLIGHT`): the block is neither freed nor handed
    out again while the copy reads it.  On a CPU dst: `dst.copy_(src)`, the
    plain version."""
    _need(isinstance(src, torch.Tensor) and src.device.type == "cpu", "src: expected a host tensor")
    _need(isinstance(dst, torch.Tensor) and dst.dtype == src.dtype,
          f"dst: expected {src.dtype}, got {getattr(dst, 'dtype', type(dst))}")
    spitch = _pitched(src, "src", src.shape)
    dpitch = _pitched(dst, "dst", src.shape)
    if dst.device.type == "cpu":
        return dst.copy_(src)
    _need(dst.device.type == "cuda", f"dst: unsupported device {dst.device}")
    _need(src.is_pinned(), "src: a copy to the card reads pinned memory only")
    rows, w = src.shape
    if rows and w:
        stream = torch.cuda.current_stream(dst.device)
        with torch.cuda.device(dst.device):
            rc = _build.load().nrq_copy2d(dst.data_ptr(), dpitch, src.data_ptr(), spitch, w * src.element_size(),
                                          rows, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"copy2d of [{rows}, {w}] failed: cudaError {rc}")
        COPIES["copy2d"] += 1
        done = torch.cuda.Event()
        done.record(stream)
        _IN_FLIGHT[:] = [(e, s) for e, s in _IN_FLIGHT if not e.query()]
        _IN_FLIGHT.append((done, src))
    return dst


# --- gather probes (csrc/gather_probe.cu) -------------------------------------

PROBE_R = 8  # output rows per thread block, the default of every probe wrapper
_PROBE_MAX_R = 32
_PROBE_MAX_SLOTS = 1024  # R * w: row tiles staged per block


# The ring of gather_v1 and gather_v2 (csrc/gather_probe.cu, ring_plan): what
# probe_geometry mirrors, and the card test holds against the library's own.
_RING_STAGES = 3
_RING_STAGE_BYTES = 32 * 1024
_RING_COPY_1, _RING_COPY_W = 4096, 2048
_RING_BLOCKS_PER_SM = 2
_RING_TILES_PER_BLOCK = 4  # from this many tiles a block, whole tiles are dealt; below, single steps
_RING_CONSUMER_WARPS = 8
_RING_PRODUCER_WARPS = {0: 1, 1: 4, 2: 1}  # by wait mode: a cp.async (1) moves 16 bytes only
PROBE_SMEM_MAX = 232448  # 227 KB: the shared memory one block may have on the H100


def _copy_plan(stage: int, w: int, t: int, R: int) -> tuple[int, int]:
    """(bytes of one copy, rows of one step) for stages of `stage` bytes: R
    rows a step where their copies stay at the least size (4 KB at width 1,
    2 KB wider) or above, else fewer rows rather than narrower copies; a
    copy narrower than that only where t is, or where one row's w copies of
    the least size do not fit a stage."""
    least = _RING_COPY_1 if w == 1 else _RING_COPY_W
    cw = stage // (R * w) // 16 * 16
    if cw < least:
        cw = min(least, stage // w // 16 * 16)
    cw = min(cw, t)
    return cw, min(R, stage // (w * cw))


def probe_geometry(n: int, w: int, t: int, R: int = PROBE_R, mode: int = 2, sms: int = 132) -> dict:
    """How gather_v1 (wait `mode`) and gather_v2 (mode 2) cut a launch, on a
    card of `sms` SMs.  A tile is R rows by `copy_bytes` of t, taken in
    `steps_per_tile` steps of `rows_per_step` rows: one ring stage and
    `slots_per_step` copies each.  The launch's `steps` (tile after tile) are
    dealt round the `blocks` thread blocks in runs of `deal`: block b takes
    runs b, b + blocks, ...; a run is a whole tile, or a single step where
    the launch has fewer than four tiles for each block the card holds.

    copy_bytes = stage / (R*w) (in 16-byte units), so that a tile is one
    step; where that falls below the least copy (4 KB at width 1, 2 KB
    wider), the step takes fewer rows rather than narrower copies.  Tiles
    are numbered row block first at width 1 (consecutive tiles walk one row
    block's column chunks) and column chunk first when wider (the resident
    blocks share one column chunk of the source)."""
    cw, rs = _copy_plan(_RING_STAGE_BYTES, w, t, R)
    ns, sps, spt = _RING_STAGES, rs * w, -(-R // rs)
    row_blocks, chunks = -(-n // R), -(-t // cw)
    steps = row_blocks * chunks * spt  # a tail row block leaves some of its tile's steps empty
    cap = _RING_BLOCKS_PER_SM * sms
    deal = spt if row_blocks * chunks >= _RING_TILES_PER_BLOCK * cap else 1
    blocks = min(steps // deal, cap)
    nbar = 2 * ns + (ns * sps if mode == 0 else 0)
    strip = cw if w == 1 else 0  # the zero strip of the width-1 body
    return {"rows_per_step": rs, "copy_bytes": cw, "stages": ns, "slots_per_step": sps,
            "stage_bytes": sps * cw, "steps_per_tile": spt, "row_blocks": row_blocks, "chunks": chunks,
            "steps": steps, "deal": deal, "blocks": blocks,
            "threads": 32 * (_RING_CONSUMER_WARPS + _RING_PRODUCER_WARPS[mode]),
            "smem_bytes": ns * sps * cw + strip + 8 * nbar + 4 * ns * sps,
            "order": "row_block" if w == 1 else "column_chunk"}


def probe_steps(n: int, w: int, t: int, R: int, geom: dict, block: int):
    """The steps thread block `block` takes under `geom`, in order:
    (stage, first row, rows, first byte, bytes) each."""
    rs, cw, spt, deal = geom["rows_per_step"], geom["copy_bytes"], geom["steps_per_tile"], geom["deal"]
    taken = 0
    units = (run * deal + k for run in range(block, geom["steps"] // deal, geom["blocks"]) for k in range(deal))
    for unit in units:
        tile, sub = divmod(unit, spt)
        if geom["order"] == "row_block":
            rb, cc = divmod(tile, geom["chunks"])
        else:
            cc, rb = divmod(tile, geom["row_blocks"])
        rows, r0, col0 = min(R, n - rb * R), sub * rs, cc * cw
        if r0 >= rows:  # a tail row block has fewer steps
            continue
        yield taken % geom["stages"], rb * R + r0, min(rs, rows - r0), col0, min(cw, t - col0)
        taken += 1


# gather_db (csrc/gather_probe.cu, db_plan): what db_geometry mirrors
DB_STAGE_BYTES = 48 * 1024  # two stages, two blocks per SM
DB_SWEEP_STEPS = 8
_DB_STAGES = 2
_DB_BLOCKS_PER_SM = 2
DB_SMEM_MAX = (228 * 1024) // _DB_BLOCKS_PER_SM - 1024  # an SM's 228 KB, 1 KB reserved per block


def db_geometry(n: int, w: int, t: int, R: int = PROBE_R, sms: int = 132, *,
                stage_bytes: int = DB_STAGE_BYTES, sweep_steps: int = DB_SWEEP_STEPS) -> dict:
    """How gather_db cuts a launch, on a card of `sms` SMs.  A block owns one
    t-tile of `copy_bytes` and one sweep: `row_blocks_per_sweep` row blocks
    of R rows in order, each in `steps_per_row_block` steps of at most
    `rows_per_step` rows, through two stages.  Block b takes tile
    b // sweeps and sweep b % sweeps, so one tile's sweeps are neighbours.

    copy_bytes and rows_per_step follow the ring's rule (`_copy_plan`) for
    a 48 KB stage, the rows then evened out over a row block's steps.  A
    sweep is about `sweep_steps` steps; fewer, down to one row block, where
    the launch has fewer row-block tiles than that for each block the card
    holds."""
    cw, rs = _copy_plan(stage_bytes, w, t, R)
    spt = -(-R // rs)
    rs = -(-R // spt)
    row_blocks, tiles = -(-n // R), -(-t // cw)
    per = max(1, min(-(-sweep_steps // spt), row_blocks * tiles // (_DB_BLOCKS_PER_SM * sms)))
    sweeps = -(-row_blocks // per)
    sps = rs * w
    return {"rows_per_step": rs, "copy_bytes": cw, "stages": _DB_STAGES, "slots_per_step": sps,
            "stage_bytes": sps * cw, "steps_per_row_block": spt, "row_blocks": row_blocks, "tiles": tiles,
            "row_blocks_per_sweep": per, "sweeps": sweeps, "blocks": tiles * sweeps,
            "threads": 32 * (_RING_CONSUMER_WARPS + 1),
            "smem_bytes": _DB_STAGES * sps * cw + 8 * 2 * _DB_STAGES + 4 * _DB_STAGES * sps}


def db_steps(n: int, w: int, t: int, R: int, geom: dict, block: int):
    """The steps thread block `block` takes under `geom`, in order:
    (stage, first row, rows, first byte, bytes) each."""
    rs, cw, per = geom["rows_per_step"], geom["copy_bytes"], geom["row_blocks_per_sweep"]
    tile, sweep = divmod(block, geom["sweeps"])
    col0 = tile * cw
    taken = 0
    for rb in range(sweep * per, min((sweep + 1) * per, geom["row_blocks"])):
        end = min((rb + 1) * R, n)
        for row0 in range(rb * R, end, rs):
            yield taken % _DB_STAGES, row0, min(rs, end - row0), col0, min(cw, t - col0)
            taken += 1


def probe_counts(idx: torch.Tensor, sentinel: int, R: int = PROBE_R) -> torch.Tensor:
    """gather_v2's host count: int32 [ceil(n/R)], the slots of each block of R
    rows whose index is not `sentinel` (the probe's cnt)."""
    n = idx.shape[0]
    per_row = (idx != sentinel).sum(1, dtype=torch.int32)
    pad = -n % R
    if pad:
        per_row = torch.cat([per_row, per_row.new_zeros(pad)])
    return per_row.reshape(-1, R).sum(1, dtype=torch.int32)


def _probe_args(name: str, src: torch.Tensor, idx: torch.Tensor, R: int):
    """Check what every probe kernel needs; (S, t, n, w, device kind)."""
    _bytes(src, "src")
    _need(idx.dtype == torch.int32 and idx.dim() == 2 and idx.is_contiguous(),
          f"idx: expected a contiguous 2-D int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    S, t = src.shape
    n, w = idx.shape
    _need(t > 0 and t % 16 == 0,
          f"{name}: t={t} is not a positive multiple of 16 (its bulk copies move 16-byte units; "
          "gather_xor takes any width)")
    _need(w >= 1, f"{name}: w={w}, needs at least one index per row")
    _need(1 <= R <= _PROBE_MAX_R and R * w <= _PROBE_MAX_SLOTS,
          f"{name}: R={R}, w={w} outside 1 <= R <= {_PROBE_MAX_R}, R*w <= {_PROBE_MAX_SLOTS}")
    kind = _device_kind(src, idx)
    _need(src.data_ptr() % 16 == 0, f"{name}: src is not 16-byte aligned")
    if kind == "cpu" and n and (int(idx.min()) < 0 or int(idx.max()) >= S):
        raise IndexError(f"{name}: an index lies outside [0, {S})")
    return S, t, n, w, kind


def _probe_launch(name: str, fn, src: torch.Tensor, res: torch.Tensor, *args, check: bool):
    """Launch fn(*args, stream) unless `res` has no rows; in the checked mode
    raise on a flag the launch set."""
    if res.shape[0]:
        with torch.cuda.device(src.device):
            _launch(name, fn, *args, _stream(src.device))
        if check and take_index_errors(src.device):
            raise IndexError(f"{name}: an index lies outside [0, {src.shape[0]})")
        if check and name == "gather_v2" and take_count_errors(src.device):
            raise ValueError("gather_v2: cnt differs from the device's count of non-sentinel slots")
    return res


def gather_v1(src: torch.Tensor, idx: torch.Tensor, mode: int = 2, *, R: int = PROBE_R,
              check: bool = False) -> torch.Tensor:
    """Probe P1, K1's function through shared memory: out[i] = XOR_k src[idx[i, k]].

    src uint8 [S, t] with t % 16 == 0, idx int32 [n, w].  `mode` picks how the
    block awaits its copies: 0 one mbarrier wait per copy, 1 one wait counted
    in arrivals (cp.async), 2 one wait counted in bytes (bulk copies).
    Indices outside [0, S) raise as in gather_xor."""
    _need(mode in (0, 1, 2), f"gather_v1: mode {mode} is not 0, 1 or 2")
    S, t, n, w, kind = _probe_args("gather_v1", src, idx, R)
    if kind == "cpu":
        return gfmat.xor_reduce_gather(src, idx)
    res = _fresh((n, t), src.device)
    return _probe_launch("gather_v1", _build.load().nrq_gather_v1, src, res, src.data_ptr(), S, t,
                         idx.data_ptr(), n, w, mode, R, res.data_ptr(),
                         _flag(_INDEX_ERR, src.device).data_ptr(), check=check)


def gather_v2(src: torch.Tensor, idx: torch.Tensor, cnt: torch.Tensor, sentinel: int, *,
              R: int = PROBE_R, check: bool = False) -> torch.Tensor:
    """Probe P2: out[i] = XOR over the slots k with idx[i, k] != sentinel of
    src[idx[i, k]]; a sentinel slot is zero whatever src[sentinel] holds.

    cnt int32 [ceil(n/R)] is the host's count of non-sentinel slots per block
    of R rows (`probe_counts`).  A wrong count raises ValueError on the CPU;
    on CUDA the kernel waits on its own count and sets the flag
    `take_count_errors` reads (raised at once when `check` is set)."""
    S, t, n, w, kind = _probe_args("gather_v2", src, idx, R)
    _need(0 <= sentinel < S, f"gather_v2: sentinel {sentinel} outside [0, {S})")
    nblk = -(-n // R)
    _need(cnt.dtype == torch.int32 and tuple(cnt.shape) == (nblk,) and cnt.device == src.device,
          f"cnt: expected int32 [{nblk}] on {src.device}, got {cnt.dtype} {tuple(cnt.shape)} on {cnt.device}")
    if kind == "cpu":
        if not torch.equal(cnt, probe_counts(idx, sentinel, R)):
            raise ValueError("gather_v2: cnt differs from the count of non-sentinel slots")
        return gfmat.xor_reduce_gather_skip(src, idx, sentinel)
    res = _fresh((n, t), src.device)
    return _probe_launch("gather_v2", _build.load().nrq_gather_v2, src, res, src.data_ptr(), S, t,
                         idx.data_ptr(), n, w, cnt.data_ptr(), sentinel, R, res.data_ptr(),
                         _flag(_INDEX_ERR, src.device).data_ptr(),
                         _flag(_COUNT_ERR, src.device).data_ptr(), check=check)


def gather_db(src: torch.Tensor, idx: torch.Tensor, *, R: int = PROBE_R,
              check: bool = False) -> torch.Tensor:
    """Probe P3: gather_v1's function, double-buffered -- each thread block
    owns one t-tile and sweeps a run of its row blocks through two
    shared-memory stages, a producer warp issuing one step's copies while
    the consumer warps reduce the step before (`db_geometry`)."""
    S, t, n, w, kind = _probe_args("gather_db", src, idx, R)
    if kind == "cpu":
        return gfmat.xor_reduce_gather(src, idx)
    res = _fresh((n, t), src.device)
    return _probe_launch("gather_db", _build.load().nrq_gather_db, src, res, src.data_ptr(), S, t,
                         idx.data_ptr(), n, w, R, res.data_ptr(),
                         _flag(_INDEX_ERR, src.device).data_ptr(), check=check)
