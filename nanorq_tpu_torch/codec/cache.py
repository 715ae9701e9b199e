"""Decode plans and their device staging for the port.

`decoder_plan` is `nanorq_tpu.codec.cache.decoder_plan` with the W constructors
taken from the port (the JAX package's live in a module that imports jax):
the same solve, the same cut-overs, the same `WSchedule`/`DeviceSchedule`
objects, cached in the port's own `_dec_cache`, which `decoder_plan_cached`
probes.  `res_wrows`/`res_wrows_flat` are the residual arm's canonical
combination rows, computed as the JAX package computes them but with the
port's `w_rows`, and memoized in the port's own bounded memo.  `stage`
uploads a `WSchedule`'s numpy fields as tensors; the class has `__slots__`,
so the staged tensors live in a bounded cache of the port's own, keyed by the
schedule object and device.
"""

from collections import OrderedDict
from threading import Lock

import numpy as np
import torch

from nanorq_tpu.codec import cache as _cache
from nanorq_tpu.codec.cache import WSchedule
from nanorq_tpu.precode.device_schedule import _pad_rows, compile_device
from nanorq_tpu.precode.solver import solve_state
from nanorq_tpu.rfc.params import Params
from nanorq_tpu.utils import stats
from nanorq_tpu.utils.lru import ByteLRU
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import wpath

_dec_cache = ByteLRU(256 << 20, "torch_dec_cache")
_staged = ByteLRU(256 << 20, "torch_w_staged")
# canonical w-row per (K', ISI), least recently used first; bounded to
# NANORQ_WROW_CACHE_MB as nanorq_tpu.codec.cache bounds its own
_wrow_lock = Lock()
_wrow_cache: OrderedDict = OrderedDict()


def clear_decoder_cache() -> None:
    """Drop cached decode plans, staged tensors and canonical w-rows (and the
    shared per-ISI host memos of nanorq_tpu.codec.cache)."""
    _dec_cache.clear()
    _staged.clear()
    with _wrow_lock:
        _wrow_cache.clear()
    _cache.clear_decoder_cache()


def decoder_plan_cached(P: Params, isis: np.ndarray, overhead: int):
    """(hit, plan): whether `decoder_plan` already holds this pattern's plan
    -- the auto backend's warm-plan probe."""
    return _dec_cache.get(_cache._plan_key(P, isis, overhead))


def _wrows_unique(P: Params, st, uniq: np.ndarray) -> np.ndarray:
    """Canonical combination rows [uniq.size, res_kcols(P)] for distinct repair
    ISIs, through the memo; the missing ones in one w_rows call."""
    kc = _cache.res_kcols(P)
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
        with stats.timer("res_wrows"):
            W, _ = wpath.w_rows(st, _cache._lt_rows_cached(P, uniq[midx]), n_cols=_pad_rows(st.M + 1))
        rows = np.ascontiguousarray(W[:, :kc])
        Wu[midx] = rows
        cap = max(1, int(_cache._WROW_CACHE_MB * (1 << 20) / kc))
        with _wrow_lock:
            for mi, j in enumerate(missing):
                _wrow_cache[(P.Kp, int(uniq[j]))] = rows[mi]
            while len(_wrow_cache) > cap:
                _wrow_cache.popitem(last=False)
    return Wu


def res_wrows(P: Params, isis: np.ndarray) -> np.ndarray | None:
    """Canonical combination rows for repair ISIs: [n, res_kcols(P)] uint8,
    row j satisfying  row_j . D_canonical = symbol(isis[j])
    (nanorq_tpu.codec.cache.res_wrows).  None when the native factorization
    is unavailable."""
    st = _cache.canonical_state(P)
    if st is None:
        return None
    uniq, inv = np.unique(np.asarray(isis, np.uint32), return_inverse=True)
    return _wrows_unique(P, st, uniq)[inv]


def res_wrows_flat(P: Params, isi_list: list) -> tuple | None:
    """Stacked canonical rows for a batch of patterns: (W_all [sum nr, kc],
    row_offs int64 [nb], nrs int64 [nb]) (nanorq_tpu.codec.cache.res_wrows_flat).
    None when the native factorization is unavailable."""
    st = _cache.canonical_state(P)
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


def decoder_plan(P: Params, isis: np.ndarray, overhead: int):
    """Best decode plan for a pattern: a WSchedule in the dense-W regime
    (GF(2) when the factorization is binary, GF(256) when HDPC pivots were
    taken, each up to its K' cut-over), else the structured DeviceSchedule.
    Cached; None on rank deficiency."""
    key = _cache._plan_key(P, isis, overhead)
    hit, cached = _dec_cache.get(key)
    if hit:
        stats.count("dec_schedule_cache_hit")
        return cached
    with stats.timer("dec_solve"):
        st = solve_state(P, _cache._patched_rows(P, isis, overhead), overhead)
    plan = None
    if st is not None:
        native = getattr(st, "tri_edges", None) is not None
        use_gf2 = native and not st.hdpc_used and P.Kp <= _cache.WPATH_MAX_KP
        use_gf256 = native and st.hdpc_used and P.Kp <= _cache.WPATH_GF256_MAX_KP
        if use_gf2 or use_gf256:
            gaps = np.nonzero(isis[: P.Kp] != np.arange(P.Kp, dtype=np.uint32))[0]
            M_pad = _pad_rows(st.M + 1)
            out_rows = _cache._rows_subset(_cache._base_rows(P), gaps)
            with stats.timer("dec_wrows"):
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
    _dec_cache.put(key, plan)
    return plan


def stage(ws: WSchedule, device) -> dict:
    """A WSchedule's tensors on `device`: {"bits", "rows"} (GF(2), rows as
    an [kq, 1] gather) or {"W"} (GF(256), columns cut to M_pad)."""
    dev = resolve(device)
    key = (id(ws), str(dev))
    hit, val = _staged.get(key)
    if hit and val[0] is ws:
        return val[1]
    if ws.Wbits is not None:
        t = {
            "bits": torch.from_numpy(np.ascontiguousarray(ws.Wbits)).to(dev),
            "rows": torch.from_numpy(np.ascontiguousarray(ws.rows, np.int32).reshape(-1, 1)).to(dev),
        }
    else:
        t = {"W": torch.from_numpy(np.ascontiguousarray(ws.W[:, : ws.M_pad])).to(dev)}
    # the entry holds the schedule itself, so its id cannot be reused while
    # the entry lives
    _staged.put(key, (ws, t))
    return t


def apply(ws: WSchedule, D: torch.Tensor) -> torch.Tensor:
    """Run the recovery matmul on D's device; rows [:n_out] are the gaps."""
    t = stage(ws, D.device)
    if ws.Wbits is not None:
        return wpath.w_apply_gf2(t["bits"], t["rows"], D)
    return wpath.w_apply_gf256(t["W"], D)
