"""Schedule and plan caches of the port (counterpart of nanorq_tpu.codec.cache).

The encoder precode system depends only on K', so its solved DeviceSchedule
is cached globally and shared by every block and every Encoder instance —
this is the always-on generalization of the reference's nanorq_precalculate
(lib/nanorq.c:393-401).  Decoder schedules depend on the received-ISI
pattern; they are LRU-cached so steady loss patterns (and benchmark loops)
re-solve nothing.  Serialization helpers let long-lived services persist
solved schedules across restarts (SURVEY.md s5 checkpoint/resume).

The host logic, bounds and env variables are the JAX package's; the W
constructors are the port's (`ops/wpath.py`), and a `WSchedule` stages its
tensors per torch device and applies them with the port's kernels.
"""

import dataclasses
import os
import pickle
from threading import Lock

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import program, wpath
from nanorq_tpu_torch.precode.device_schedule import DeviceSchedule, _pad_rows, compile_device
from nanorq_tpu_torch.precode.matrix import CSRRows, binary_rows, lt_rows_csr
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import Params, params_init
from nanorq_tpu_torch.utils import stats
from nanorq_tpu_torch.utils.lru import ByteLRU

_enc_lock = Lock()
_enc_cache: dict[tuple[int, int], DeviceSchedule] = {}

# decoder plans are per loss pattern and scale with K' (a structured
# K'=50511 plan is tens of MB); the cache is BYTE-budgeted, not
# entry-counted, so steady large-K' streams cannot pin unbounded host RAM
_DEC_BUDGET = int(float(os.environ.get("NANORQ_DEC_CACHE_MB", 256)) * (1 << 20))
_dec_cache = ByteLRU(_DEC_BUDGET, "dec_cache")
_planned_kps: set[int] = set()  # the K' of every device plan decoder_plan built since the last clear


def encoder_schedule(Kp: int, CB: int | None = None) -> DeviceSchedule:
    """Solved encoder-side schedule for K' (loss independent, cached)."""
    key = (Kp, CB)
    with _enc_lock:
        ds = _enc_cache.get(key)
    if ds is not None:
        return ds
    P = params_init(Kp)
    assert P.Kp == Kp
    with stats.span("enc_solve"):
        st = solve_state(P, binary_rows(P))
    if st is None:  # cannot happen for Table 2 K' values
        raise RuntimeError(f"encoder precode solve failed for K'={Kp}")
    ds = compile_device(st, CB=CB)
    with _enc_lock:
        _enc_cache[key] = ds
    return ds


def clear_decoder_cache() -> None:
    """Drop all cached per-pattern decoder schedules AND the per-ISI memos
    (LT rows, canonical w-rows) — benchmarks use this to force fully fresh
    per-pattern work; the reference re-expands tuples and re-inverts inside
    its timed region; production code never needs it.  The canonical
    per-K' solve states stay (they are the decoder-side analog of the
    encoder's loss-independent nanorq_precalculate artifact)."""
    _dec_cache.clear()
    _planned_kps.clear()
    with _lt_lock:
        _lt_cache.clear()
    with _wrow_lock:
        _wrow_cache.clear()


def clear_encoder_cache() -> None:
    with _enc_lock:
        _enc_cache.clear()


_rows_lock = Lock()
_rows_cache: dict[int, list] = {}

# per-(K', ISI) LT row memo: decode patterns re-reference a small window of
# repair ISIs, so the tuple/PRNG expansion — the dominant per-pattern host
# cost at small K' — amortizes to a dict hit.  Rows are ~30 int32s; the cap
# bounds the memo at a few MB.
from collections import OrderedDict as _OrderedDict  # noqa: E402

_lt_lock = Lock()
_lt_cache: "_OrderedDict[tuple[int, int], np.ndarray]" = _OrderedDict()
_LT_CACHE_CAP = int(os.environ.get("NANORQ_LT_ROW_CACHE", 16384))


def _base_rows(P: Params):
    """Cached encoder-system binary rows (CSR) for K'."""
    with _rows_lock:
        base = _rows_cache.get(P.Kp)
    if base is None:
        base = binary_rows(P)
        with _rows_lock:
            _rows_cache[P.Kp] = base
    return base


def _rows_subset(base, idx: np.ndarray):
    """CSRRows view of base rows `idx` (vectorized gather, no tuple math)."""
    idx = np.asarray(idx, np.int64)
    _, flat = base.select_flat(idx)
    ptr = np.zeros(idx.size + 1, np.int64)
    np.cumsum(base.ptr[idx + 1] - base.ptr[idx], out=ptr[1:])
    return CSRRows(flat.astype(np.int32), ptr)


def _lt_rows_cached(P: Params, isis: np.ndarray):
    """LT rows (CSR) for `isis`, memoized per (K', ISI).

    The per-ISI dict amortizes the tuple/PRNG expansion that dominates
    small-K' pattern prep; above a few hundred rows the Python loop costs
    more than the vectorized expansion itself, so large requests bypass it."""
    isis = np.asarray(isis, np.uint32)
    if isis.size > 256:
        return lt_rows_csr(isis, P)
    rows: list = [None] * isis.size
    missing = []
    with _lt_lock:
        for j in range(isis.size):
            key = (P.Kp, int(isis[j]))
            got = _lt_cache.get(key)
            if got is None:
                missing.append(j)
            else:
                _lt_cache.move_to_end(key)
                rows[j] = got
    if missing:
        fresh = lt_rows_csr(isis[np.asarray(missing, np.int64)], P)
        with _lt_lock:
            for mi, j in enumerate(missing):
                rows[j] = fresh[mi]
                _lt_cache[(P.Kp, int(isis[j]))] = rows[j]
            while len(_lt_cache) > _LT_CACHE_CAP:
                _lt_cache.popitem(last=False)
    return CSRRows.from_list(rows)


# --- residual decode arm: canonical factorization artifacts -----------------
#
# The residual arm (codec/api.py _repair_residual_batch) never solves the
# per-pattern patched system.  It needs (a) the CANONICAL solve state for K'
# (loss independent — the decode-side twin of the encoder precalc) and
# (b) canonical combination rows w_r with w_r . D = repair symbol r, one per
# repair ISI, memoized per (K', ISI) because decode patterns draw their
# repair ISIs from a small window above K.

_canon_lock = Lock()
_canon_cache: dict[int, object] = {}

_wrow_lock = Lock()
_wrow_cache: "_OrderedDict[tuple[int, int], np.ndarray]" = _OrderedDict()
_WROW_CACHE_MB = float(os.environ.get("NANORQ_WROW_CACHE_MB", 64))


def res_kcols(P: Params) -> int:
    """Column count of stored canonical w-rows: gap columns and nonzero-
    payload columns of the canonical system all lie below K' (constraint
    rows carry zero payloads), padded to the device row grid."""
    return _pad_rows(P.Kp)


def canonical_state(P: Params):
    """Cached canonical (encoder-system) solve state for K'.

    None when the native solver is unavailable (the residual arm requires
    its factorization artifacts — w_rows needs st.tri_edges/st.vinv)."""
    with _canon_lock:
        st = _canon_cache.get(P.Kp)
    if st is not None:
        return st if st != "unavailable" else None
    with stats.span("canon_solve"):
        st = solve_state(P, _base_rows(P))
    if st is None or getattr(st, "tri_edges", None) is None:
        with _canon_lock:
            _canon_cache[P.Kp] = "unavailable"
        return None
    with _canon_lock:
        _canon_cache[P.Kp] = st
    return st


def _wrows_unique(P: Params, st, uniq: np.ndarray) -> np.ndarray:
    """Canonical combination rows [uniq.size, res_kcols(P)] for distinct repair
    ISIs, through the per-(K', ISI) memo; the missing ones in one w_rows
    call.  The memo stays bounded by NANORQ_WROW_CACHE_MB."""
    kc = res_kcols(P)
    Wu = np.empty((uniq.size, kc), np.uint8)
    missing = []
    with _wrow_lock:
        for j, isi in enumerate(uniq.tolist()):
            got = _wrow_cache.get((P.Kp, isi))
            if got is None:
                missing.append(j)
            else:
                _wrow_cache.move_to_end((P.Kp, isi))
                Wu[j] = got
    if missing:
        midx = np.asarray(missing, np.int64)
        with stats.span("res_wrows"):
            W, _ = wpath.w_rows(st, _lt_rows_cached(P, uniq[midx]), n_cols=_pad_rows(st.M + 1))
        rows = np.ascontiguousarray(W[:, :kc])
        Wu[midx] = rows
        cap = max(1, int(_WROW_CACHE_MB * (1 << 20) / kc))
        with _wrow_lock:
            for mi, j in enumerate(missing):
                _wrow_cache[(P.Kp, int(uniq[j]))] = rows[mi]
            while len(_wrow_cache) > cap:
                _wrow_cache.popitem(last=False)
    return Wu


def res_wrows(P: Params, isis: np.ndarray) -> np.ndarray | None:
    """Canonical combination rows for repair ISIs: [n, res_kcols(P)] uint8,
    row j satisfying  row_j . D_canonical = symbol(isis[j]).  Memoized per
    (K', ISI); None when the native factorization is unavailable."""
    st = canonical_state(P)
    if st is None:
        return None
    uniq, inv = np.unique(np.asarray(isis, np.uint32), return_inverse=True)
    return _wrows_unique(P, st, uniq)[inv]


def res_wrows_flat(P: Params, isi_list: list) -> tuple | None:
    """Stacked canonical combination rows for a BATCH of decode patterns:
    (W_all [sum nr, kc] uint8, row_offs int64 [nb], nrs int64 [nb]).

    One unique-ISI pass serves the whole batch: decode patterns draw their
    repair ISIs from a small window above K', so blocks overwhelmingly
    share rows, and ONE fancy-index gather emits the flat layout the native
    host-residual call consumes.  None when the native factorization is
    unavailable."""
    st = canonical_state(P)
    if st is None:
        return None
    nb = len(isi_list)
    nrs = np.fromiter((i.size for i in isi_list), np.int64, nb)
    flat = np.concatenate(isi_list).astype(np.uint32) if nb else np.zeros(0, np.uint32)
    uniq, inv = np.unique(flat, return_inverse=True)
    row_offs = np.zeros(nb, np.int64)
    if nb > 1:
        np.cumsum(nrs[:-1], out=row_offs[1:])
    return _wrows_unique(P, st, uniq)[inv], row_offs, nrs


def _patched_rows(P: Params, isis: np.ndarray, overhead: int):
    """Binary rows (CSR) for a decode pattern, reusing cached encoder rows.

    Only the slots whose ISI differs from the systematic 0..K'-1 sequence
    (the patched gaps + overhead rows) need fresh LT expansion — typically a
    few percent of K'.  The splice is fully vectorized (one flat-buffer
    scatter), never materializing per-row Python lists.
    """
    from nanorq_tpu_torch.native import splice_rows_native

    base = _base_rows(P)
    Kp, S = P.Kp, P.S
    isis = np.asarray(isis, np.uint32)
    changed = np.nonzero(isis != np.arange(Kp + overhead, dtype=np.uint32))[0]
    changed = np.union1d(changed, np.arange(Kp, Kp + overhead)).astype(np.int64)
    if not changed.size:
        return base
    fresh = _lt_rows_cached(P, isis[changed])

    n = Kp + overhead + S
    src = np.empty(n, np.int64)  # base row per output row; -1 marks changed
    src[:Kp] = np.arange(Kp)
    src[Kp + overhead :] = Kp + np.arange(S)
    src[changed] = -1

    lens = np.empty(n, np.int64)
    keep = src >= 0
    lens[keep] = base.ptr[src[keep] + 1] - base.ptr[src[keep]]
    lens[changed] = fresh.lens()
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    cols = np.empty(int(ptr[-1]), np.int32)

    if not splice_rows_native(n, base.ptr, base.cols, src, fresh.ptr, fresh.cols, ptr, cols):
        # NumPy fallback: repeat/scatter formulation of the same splice
        def within(ls):
            csum = np.zeros(ls.size + 1, np.int64)
            np.cumsum(ls, out=csum[1:])
            return np.arange(int(ls.sum()), dtype=np.int64) - np.repeat(csum[:-1], ls)

        kidx = np.nonzero(keep)[0]
        _, vals = base.select_flat(src[kidx])
        cols[np.repeat(ptr[kidx], lens[kidx]) + within(lens[kidx])] = vals
        cols[np.repeat(ptr[changed], lens[changed]) + within(lens[changed])] = fresh.cols
    return CSRRows(cols, ptr)


class WSchedule:
    """Per-pattern dense combination matrix (ops/wpath.py): the decode
    device work is one GF(2)/GF(256) matmul.  Output row r is the r-th
    requested gap symbol.  Two forms: gathered packed-bit GF(2) for binary
    factorizations, byte GF(256) for HDPC-pivot factorizations (e.g.
    overhead < H patterns at small K)."""

    __slots__ = ("Wbits", "rows", "W", "M_pad", "n_out", "_staged")

    def __init__(self, M_pad: int, n_out: int, Wbits=None, rows=None, W=None):
        m_pad = _pad_rows(max(n_out, 1))

        def mquant(A):  # quantize m so patterns share batch shapes
            if A.shape[0] == m_pad:
                return A
            Ap = np.zeros((m_pad, A.shape[1]), np.uint8)
            Ap[: A.shape[0]] = A
            return Ap

        self.Wbits = None if Wbits is None else mquant(Wbits)
        self.rows = rows
        self.W = None if W is None else mquant(W)
        self.M_pad, self.n_out = M_pad, n_out
        self._staged = {}  # torch.device -> its tensors

    def staged(self, device) -> dict:
        """The tensors on `device`: {"bits", "rows"} (GF(2), rows as an
        [kq, 1] gather) or {"W"} (GF(256), columns cut to M_pad), each
        uploaded into memory that `ops/program.reclaiming` finds."""
        dev = resolve(device)
        t = self._staged.get(dev)
        if t is None:
            def up(a):
                return program.reclaiming(lambda: torch.from_numpy(np.ascontiguousarray(a)).to(dev), dev)

            if self.Wbits is not None:
                t = {"bits": up(self.Wbits), "rows": up(np.asarray(self.rows, np.int32).reshape(-1, 1))}
            else:
                t = {"W": up(self.W[:, : self.M_pad])}
            self._staged[dev] = t
        return t

    def apply(self, D: torch.Tensor) -> torch.Tensor:
        """Run the recovery matmul on D's device; rows [:n_out] are the gaps."""
        t = self.staged(D.device)
        if self.Wbits is not None:
            return wpath.w_apply_gf2(t["bits"], t["rows"], D)
        return wpath.w_apply_gf256(t["W"], D)


# Decode W-path cutover: above these K' the dense matmul's O(K'^2 t) FLOPs
# lose to the structured replay's O(nnz t).  GF(2) (binary factorization)
# measured 5.4x faster at K=10000, break-even ~K'=50000 (where host W prep
# also hits ~140 ms).  GF(256) W pays 64x the bit count but its m is only
# the (tiny) gap count, so it still wins at small K' — which is exactly
# where overhead < H forces HDPC pivots.  (Measured by the JAX package on
# its TPU; not re-measured for the port.)
WPATH_MAX_KP = int(os.environ.get("NANORQ_WPATH_MAX_KP", 16384))
WPATH_GF256_MAX_KP = int(os.environ.get("NANORQ_WPATH_GF256_MAX_KP", 4096))


def _plan_key(P: Params, isis: np.ndarray, overhead: int) -> bytes:
    return b"P|%d|%d|" % (P.Kp, overhead) + np.ascontiguousarray(isis, np.uint32).tobytes()


def decoder_plan_cached(P: Params, isis: np.ndarray, overhead: int):
    """(hit, plan) — a warm-plan probe for the adaptive decode backend: a
    pattern whose device plan is already built+cached should run on the
    device; a cold pattern is cheaper on the host CPU arm."""
    return _dec_cache.get(_plan_key(P, isis, overhead))


def decoder_plan(P: Params, isis: np.ndarray, overhead: int):
    """Best decode plan for a pattern: a WSchedule (dense combination
    matmul) in the dense-win regime, else the structured DeviceSchedule.
    Cached; None on rank deficiency."""
    key = _plan_key(P, isis, overhead)
    hit, cached = _dec_cache.get(key)
    if hit:
        stats.count("dec_schedule_cache_hit")
        return cached
    with stats.span("dec_solve"):
        st = solve_state(P, _patched_rows(P, isis, overhead), overhead)
    plan = None
    if st is not None:
        native = getattr(st, "tri_edges", None) is not None
        use_gf2 = native and not st.hdpc_used and P.Kp <= WPATH_MAX_KP
        use_gf256 = native and st.hdpc_used and P.Kp <= WPATH_GF256_MAX_KP
        if use_gf2 or use_gf256:
            gaps = np.nonzero(isis[: P.Kp] != np.arange(P.Kp, dtype=np.uint32))[0]
            M_pad = _pad_rows(st.M + 1)
            # gap ISIs are systematic rows of the cached base CSR — a
            # vectorized slice, no tuple/PRNG expansion
            out_rows = _rows_subset(_base_rows(P), gaps)
            with stats.span("dec_wrows"):
                if use_gf2:
                    Wbits, rows = wpath.w_rows_gf2(st, out_rows, zero_row=M_pad - 1)
                    plan = WSchedule(M_pad, gaps.size, Wbits=Wbits, rows=rows)
                else:
                    W, _binary = wpath.w_rows(st, out_rows, n_cols=M_pad)
                    plan = WSchedule(M_pad, gaps.size, W=W)
        else:
            plan = compile_device(st, canonical=True)
    if plan is None:
        stats.count("decode_rank_deficient")
    else:
        _planned_kps.add(P.Kp)
    _dec_cache.put(key, plan)
    return plan


def has_device_plans(Kp: int) -> bool:
    """Whether decoder_plan built a device plan of K' since the decoder
    cache was last cleared: whether a pattern of K' can be met warm."""
    return Kp in _planned_kps


def decoder_schedule(P: Params, isis: np.ndarray, overhead: int, CB: int | None = None) -> DeviceSchedule | None:
    """Solve (or fetch) the schedule for a decode-side patched system.

    Returns None on rank deficiency (decode failure — feed more symbols).
    Failures are cached too: retrying the same pattern cannot succeed.
    """
    key = b"%d|%d|%d|" % (P.Kp, overhead, CB or 0) + np.ascontiguousarray(isis, np.uint32).tobytes()
    hit, cached = _dec_cache.get(key)
    if hit:
        stats.count("dec_schedule_cache_hit")
        return cached
    with stats.span("dec_solve"):
        st = solve_state(P, _patched_rows(P, isis, overhead), overhead)
    ds = None if st is None else compile_device(st, CB=CB, canonical=True)
    if ds is None:
        stats.count("decode_rank_deficient")
    _dec_cache.put(key, ds)
    return ds


def save_schedule(ds: DeviceSchedule, path: str) -> None:
    """Persist a solved schedule (checkpoint/resume for long-lived encoders):
    its fields alone, not what a run keeps on it (device tensors, programs)."""
    with open(path, "wb") as f:
        pickle.dump(dataclasses.replace(ds), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_schedule(path: str) -> DeviceSchedule:
    with open(path, "rb") as f:
        ds = pickle.load(f)
    # reject checkpoints from before a schema change (e.g. pre-Wut pickles
    # restore without the field the executor now requires); a real raise,
    # not an assert, so warm_encoder_cache's stale-file recovery still
    # triggers under python -O
    if not (isinstance(ds, DeviceSchedule) and getattr(ds, "wut", None) is not None):
        raise ValueError(f"stale or foreign schedule checkpoint: {path}")
    return ds


def warm_encoder_cache(Kp: int, cache_dir: str | None = None, CB: int | None = None) -> DeviceSchedule:
    """Disk-backed variant of encoder_schedule for cold-start latency.

    CB defaults to None (adaptive chunk size) so warm-started processes share
    cache entries with the normal encoder_schedule path.
    """
    if cache_dir is None:
        return encoder_schedule(Kp, CB)
    path = os.path.join(cache_dir, f"enc_{Kp}_{'auto' if CB is None else CB}.sched")
    key = (Kp, CB)
    with _enc_lock:
        hit = _enc_cache.get(key)
    if hit is not None:
        if not os.path.exists(path):  # in memory but not checkpointed yet
            os.makedirs(cache_dir, exist_ok=True)
            save_schedule(hit, path)
        return hit
    if os.path.exists(path):
        try:
            ds = load_schedule(path)
        except Exception:
            os.unlink(path)  # stale schema: re-solve and overwrite below
        else:
            with _enc_lock:
                _enc_cache[key] = ds
            return ds
    ds = encoder_schedule(Kp, CB)
    os.makedirs(cache_dir, exist_ok=True)
    save_schedule(ds, path)
    return ds
