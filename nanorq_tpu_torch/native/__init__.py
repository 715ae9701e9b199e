"""Native host runtime: C++ schedule solver with ctypes binding.

Builds lazily (g++ -O3) into nanorq_tpu_torch/native/_build/ and falls back to the
pure-Python solver when no compiler is available.  The native path returns
the same SolveState the Python solver produces (minus the op-stream oracle),
so the device compiler is backend-agnostic.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "solver.cc")

_lock = threading.Lock()
_lib = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _sanitize_mode() -> str:
    """NANORQ_NATIVE_SANITIZE=address,undefined builds the native library
    with -fsanitize (the analog of the reference's ubsan Makefile target).
    Sanitized builds of this copy run under the same LD_PRELOAD as
    `make ubsan-native` uses for the JAX package's.  Sanitized builds live in their own
    subdirectory so they never shadow the production blob."""
    return os.environ.get("NANORQ_NATIVE_SANITIZE", "").strip()


def _build_dirs(srchash: str):
    """Candidate build directories, preferred first: the in-package dir
    (fast, shared across users of a writable checkout), then a per-user
    cache keyed on source hash (read-only / system installs — the package
    dir under site-packages is often not writable)."""
    san = _sanitize_mode()
    sub = "_build" if not san else os.path.join("_build", "san-" + san.replace(",", "-"))
    yield os.path.join(_HERE, sub)
    cache_root = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    yield os.path.join(cache_root, "nanorq_tpu_torch", ("san-" if san else "") + srchash[:16])


def _lib_path(build_dir: str) -> str:
    return os.path.join(build_dir, "libnanorq_host.so")


def _build(build_dir: str, srchash: str) -> bool:
    lib_path = _lib_path(build_dir)
    try:
        os.makedirs(build_dir, exist_ok=True)
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            "-pthread", "-o", lib_path + ".tmp", _SRC,
        ]
        san = _sanitize_mode()
        if san:
            # -g for symbolized reports; recovery off so any finding fails
            # the test run loudly.  ASan's runtime stays dynamic in a
            # shared lib — run python under LD_PRELOAD=libasan.so
            # (`make ubsan-native` does).
            cmd[1:1] = ["-g", f"-fsanitize={san}", "-fno-sanitize-recover=all"]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            return False
        os.replace(lib_path + ".tmp", lib_path)
        # stamp written after a successful build: the rebuild decision is
        # keyed on source *content*, never mtimes (git does not preserve
        # mtimes, and a stale -march=native blob from another host could
        # SIGILL)
        stamp = lib_path + ".srchash"
        with open(stamp + ".tmp", "w") as f:
            f.write(srchash)
        os.replace(stamp + ".tmp", stamp)
        return True
    except OSError:
        return False  # unwritable location: the caller tries the next one


def _fresh(build_dir: str, srchash: str) -> bool:
    lib_path = _lib_path(build_dir)
    stamp = lib_path + ".srchash"
    if not os.path.exists(lib_path) or not os.path.exists(stamp):
        return False
    with open(stamp) as f:
        return f.read().strip() == srchash


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            srchash = _src_hash()
            lib_file = None
            for bd in _build_dirs(srchash):
                if _fresh(bd, srchash) or _build(bd, srchash):
                    lib_file = _lib_path(bd)
                    break
            if lib_file is None:
                warnings.warn(
                    "nanorq_tpu_torch: native host solver build failed (no g++ or no "
                    "writable build dir); falling back to the pure-Python solver "
                    "— per-pattern decode solves will be 10-50x slower",
                    RuntimeWarning,
                    stacklevel=2,
                )
                return None
            lib = ctypes.CDLL(lib_file)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.nrq_solve.restype = ctypes.c_void_p
            lib.nrq_solve.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, u8p,
            ]
            for name in ("nrq_status", "nrq_hdpc_used", "nrq_i", "nrq_u"):
                getattr(lib, name).restype = ctypes.c_int32
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            for name in ("nrq_piv_rows", "nrq_piv_cols", "nrq_u_cols", "nrq_order",
                         "nrq_tri_ek", "nrq_tri_ep", "nrq_ut_ek", "nrq_ut_uc"):
                getattr(lib, name).restype = i32p
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            for name in ("nrq_n_tri_edges", "nrq_n_ut_edges"):
                getattr(lib, name).restype = ctypes.c_int64
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            for name in ("nrq_uschur", "nrq_vinv"):
                getattr(lib, name).restype = u8p
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.nrq_free.restype = None
            lib.nrq_free.argtypes = [ctypes.c_void_p]
            lib.nrq_tinv_chunks.restype = None
            lib.nrq_tinv_chunks.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32]
            lib.nrq_tinv_conj_chunks.restype = None
            lib.nrq_tinv_conj_chunks.argtypes = [u8p, i32p, ctypes.c_int32, ctypes.c_int32]
            lib.nrq_heavy_closure.restype = None
            lib.nrq_heavy_closure.argtypes = [
                ctypes.c_int64, i32p, i32p, ctypes.c_int32, ctypes.c_int32, u8p,
            ]
            lib.nrq_heavy_zone_order.restype = ctypes.c_int32
            lib.nrq_heavy_zone_order.argtypes = [
                ctypes.c_int64, i32p, i32p, ctypes.c_int32, ctypes.c_int32, u8p, i32p,
            ]
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.nrq_splice_rows.restype = None
            lib.nrq_splice_rows.argtypes = [
                ctypes.c_int32, i64p, i32p, i64p, i64p, i32p, i64p, i32p,
            ]
            u64p = ctypes.POINTER(ctypes.c_uint64)
            lib.nrq_host_repair.restype = None
            lib.nrq_host_repair.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                i32p, i64p, i32p, i64p, i32p, u8p,
                i64p, u64p, i32p, i64p, i32p, i64p, i32p, u64p, i32p,
                ctypes.c_int32,
            ]
            lib.nrq_res_rinv.restype = None
            lib.nrq_res_rinv.argtypes = [
                ctypes.c_int32, i32p, i32p, i64p, u8p, i64p, u8p, i32p,
                ctypes.c_int32,
            ]
            lib.nrq_host_residual.restype = None
            lib.nrq_host_residual.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                i32p, i32p, i64p, i32p,
                i64p, u8p, i64p, u64p, i64p, u64p, i64p, u64p, i32p,
                ctypes.c_int32,
            ]
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.nrq_lt_init.restype = None
            lib.nrq_lt_init.argtypes = [u32p, u32p, u32p, u32p, u32p, ctypes.c_int32]
            lib.nrq_lt_row.restype = ctypes.c_int32
            lib.nrq_lt_row.argtypes = [
                ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, i32p,
            ]
            lib.nrq_host_repair2.restype = None
            lib.nrq_host_repair2.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                i64p, i32p, u8p, i32p,
                i64p, u32p, i64p, u64p, i32p, i64p, i32p, i64p, u64p, i32p,
                ctypes.c_int32,
            ]
            u16p = ctypes.POINTER(ctypes.c_uint16)
            lib.nrq_tri_plan.restype = ctypes.c_void_p
            lib.nrq_tri_plan.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, i32p, i32p,
                i32p, ctypes.c_int32, i32p, ctypes.c_int32,
                ctypes.c_double, ctypes.c_double, ctypes.c_int32, i32p, ctypes.c_int32,
            ]
            lib.nrq_tri_fill.restype = ctypes.c_void_p
            lib.nrq_tri_fill.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, i32p, i32p,
                i32p, ctypes.c_int32, i32p,
            ]
            lib.nrq_tp_counts.restype = i32p
            lib.nrq_tp_counts.argtypes = [ctypes.c_void_p]
            for name in ("nrq_tp_status", "nrq_tp_nseg", "nrq_tp_nranges"):
                getattr(lib, name).restype = ctypes.c_int32
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            for name in ("nrq_tp_posmap", "nrq_tp_seg_meta", "nrq_tp_range_meta"):
                getattr(lib, name).restype = i32p
                getattr(lib, name).argtypes = [ctypes.c_void_p]
            lib.nrq_tp_tinv.restype = u8p
            lib.nrq_tp_tinv.argtypes = [ctypes.c_void_p]
            lib.nrq_tp_ix.restype = u16p
            lib.nrq_tp_ix.argtypes = [ctypes.c_void_p]
            lib.nrq_tp_ix_len.restype = ctypes.c_int64
            lib.nrq_tp_ix_len.argtypes = [ctypes.c_void_p]
            lib.nrq_tp_free.restype = None
            lib.nrq_tp_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def _as_i32(arr):
    return np.ascontiguousarray(arr, dtype=np.int32)


def solve_native(P, rows_cols, overhead: int = 0):
    """Run the native solver; returns a SolveState or None (rank-deficient).

    Raises RuntimeError if the native library is unavailable.
    """
    from nanorq_tpu_torch.precode.matrix import CSRRows, hdpc_full_rows
    from nanorq_tpu_torch.precode.solver import SolveState, _BIG

    lib = get_lib()
    if lib is None:
        raise RuntimeError("native solver unavailable")
    if not isinstance(rows_cols, CSRRows):
        rows_cols = CSRRows.from_list(rows_cols)
    NB = len(rows_cols)
    row_ptr = _as_i32(rows_cols.ptr)
    row_cols = _as_i32(rows_cols.cols)
    hdpc = np.ascontiguousarray(hdpc_full_rows(P), dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    h = lib.nrq_solve(
        NB, P.L, P.W, P.S, P.H,
        row_ptr.ctypes.data_as(i32p), row_cols.ctypes.data_as(i32p),
        hdpc.ctypes.data_as(u8p),
    )
    try:
        if lib.nrq_status(h) != 0:
            return None
        i = lib.nrq_i(h)
        u = lib.nrq_u(h)
        M = NB + P.H

        def grab_i32(fn, n):
            return np.ctypeslib.as_array(fn(h), shape=(n,)).copy()

        piv_rows = grab_i32(lib.nrq_piv_rows, i)
        piv_cols = grab_i32(lib.nrq_piv_cols, i)
        u_cols = grab_i32(lib.nrq_u_cols, u).astype(np.int64)
        order_sel = grab_i32(lib.nrq_order, M).astype(np.int64)
        uschur = np.ctypeslib.as_array(lib.nrq_uschur(h), shape=(u, u)).copy()
        vinv = np.ctypeslib.as_array(lib.nrq_vinv(h), shape=(u, u)).copy()
        hdpc_used = bool(lib.nrq_hdpc_used(h))
        nte = int(lib.nrq_n_tri_edges(h))
        nue = int(lib.nrq_n_ut_edges(h))
        tri_edges = (grab_i32(lib.nrq_tri_ek, nte), grab_i32(lib.nrq_tri_ep, nte))
        ut_edges = (grab_i32(lib.nrq_ut_ek, nue), grab_i32(lib.nrq_ut_uc, nue))
    finally:
        lib.nrq_free(h)

    ucol_of = np.full(P.L, -1, np.int64)
    ucol_of[u_cols] = np.arange(u)
    pos_of_row = np.full(NB, _BIG, np.int64)
    pos_of_row[piv_rows] = np.arange(i)
    pivpos_of_col = np.full(P.L, -1, np.int64)
    pivpos_of_col[piv_cols] = np.arange(i)

    st = SolveState(
        P=P, overhead=overhead, NB=NB, M=M, rows_cols=rows_cols,
        piv_rows=piv_rows, piv_cols=piv_cols, u_cols=u_cols, order=order_sel,
        pos_of_row=pos_of_row, pivpos_of_col=pivpos_of_col, ucol_of=ucol_of,
        hdpc_used=hdpc_used, U_schur=None, ops=(),
    )
    st.uschur_sel = uschur  # [u, u] pre-extracted (device compiler shortcut)
    st.vinv = vinv
    # pre-extracted compiler edges (tri deps / inactive entries of pivot
    # rows) — compile_device skips its NumPy CSR re-scan when present
    st.tri_edges = tri_edges
    st.ut_edges = ut_edges
    return st


def splice_rows_native(n, base_ptr, base_cols, src, fresh_ptr, fresh_cols, out_ptr, out_cols) -> bool:
    """Fill out_cols by splicing base/fresh CSR rows (see nrq_splice_rows).
    Returns False when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    import ctypes as ct

    i32p = ct.POINTER(ct.c_int32)
    i64p = ct.POINTER(ct.c_int64)
    lib.nrq_splice_rows(
        int(n),
        base_ptr.ctypes.data_as(i64p), base_cols.ctypes.data_as(i32p),
        src.ctypes.data_as(i64p),
        fresh_ptr.ctypes.data_as(i64p), fresh_cols.ctypes.data_as(i32p),
        out_ptr.ctypes.data_as(i64p), out_cols.ctypes.data_as(i32p),
    )
    return True


def heavy_zone_order_native(n: int, dep_k, dep_pos, thresh: int):
    """(heavy bool [n], zone_rank int32 [n]) for the canonical decode
    layout: heavy = degree > thresh forward-closed over deps; zone_rank =
    each closed position's rank in the (level, degree-desc) topological
    zone order, -1 for light.  None when the library is missing.  dep_k
    must be ascending (the solver's tri_ek export order)."""
    lib = get_lib()
    if lib is None:
        return None
    import ctypes

    dep_k = _as_i32(dep_k)
    dep_pos = _as_i32(dep_pos)
    heavy = np.zeros(n, np.uint8)
    rank = np.empty(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.nrq_heavy_zone_order(
        dep_k.size, dep_k.ctypes.data_as(i32p), dep_pos.ctypes.data_as(i32p),
        n, thresh, heavy.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rank.ctypes.data_as(i32p),
    )
    return heavy.astype(bool), rank


def tri_plan_native(Lpad, CB, dep_k, dep_pos, cand, wgrid,
                    range_penalty, seg_penalty, max_ranges, seg_lens):
    """Native triangle replay planner (see solver.cc nrq_tri_plan).

    Returns (posmap int32 [Lpad], tinv uint8 [nchunks, CB, CB/8]
    bit-packed little-endian, segments: list of (q0, nq, ranges)) where
    ranges is a list of (a, b, ix uint16 [nq, b-a, w]); or None when the
    library is missing.  Requires CB % 64 == 0 (packed-row word width).
    Raises ValueError if a row degree exceeds the width grid (cannot happen
    for valid Table 2 K' — see ADVICE r2 on WIDTH_GRID clamping).
    """
    lib = get_lib()
    if lib is None:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    dep_k = _as_i32(dep_k)
    dep_pos = _as_i32(dep_pos)
    cand = _as_i32(cand)
    wgrid = _as_i32(wgrid)
    seg_lens = _as_i32(seg_lens)
    h = lib.nrq_tri_plan(
        Lpad, CB, dep_k.size,
        dep_k.ctypes.data_as(i32p), dep_pos.ctypes.data_as(i32p),
        cand.ctypes.data_as(i32p), cand.size,
        wgrid.ctypes.data_as(i32p), wgrid.size,
        float(range_penalty), float(seg_penalty), int(max_ranges),
        seg_lens.ctypes.data_as(i32p), seg_lens.size,
    )
    try:
        if lib.nrq_tp_status(h):
            raise ValueError("tri_plan: row degree exceeds the gather width grid")
        nchunks = Lpad // CB
        posmap = np.ctypeslib.as_array(lib.nrq_tp_posmap(h), shape=(Lpad,)).copy()
        tinv = np.ctypeslib.as_array(lib.nrq_tp_tinv(h), shape=(nchunks, CB, CB // 8)).copy()
        nseg = lib.nrq_tp_nseg(h)
        seg_meta = np.ctypeslib.as_array(lib.nrq_tp_seg_meta(h), shape=(nseg, 3)).copy()
        nr = lib.nrq_tp_nranges(h)
        range_meta = (
            np.ctypeslib.as_array(lib.nrq_tp_range_meta(h), shape=(nr, 3)).copy()
            if nr else np.zeros((0, 3), np.int32)
        )
        ix_len = int(lib.nrq_tp_ix_len(h))
        ix_flat = (
            np.ctypeslib.as_array(lib.nrq_tp_ix(h), shape=(ix_len,)).copy()
            if ix_len else np.zeros(0, np.uint16)
        )
    finally:
        lib.nrq_tp_free(h)
    segments = []
    ri = 0
    off = 0
    for q0, nq, nranges in seg_meta:
        ranges = []
        for _ in range(nranges):
            a, b, w = range_meta[ri]
            ri += 1
            n = int(nq) * int(b - a) * int(w)
            ranges.append((int(a), int(b), ix_flat[off : off + n].reshape(nq, b - a, w)))
            off += n
        segments.append((int(q0), int(nq), ranges))
    return posmap, tinv, segments


def tri_fill_native(Lpad, CB, dep_k, dep_pos, layout_tri):
    """Fixed-layout triangle fill (nrq_tri_fill): the canonical-decode hot
    path.  layout_tri = [(q0, q1, [(a, b, w), ...])] from the frozen layout.

    Returns (fit, posmap, tinv, segments, counts) — segments is None when
    fit is False (the pattern pokes above the layout; counts let the caller
    grow the envelope) — or None when the library is missing / Lpad exceeds
    the uint16 index space.
    """
    lib = get_lib()
    if lib is None or CB % 64 or Lpad >= 65536:
        return None
    seg_meta = np.asarray(
        [(q0, q1 - q0, len(bounds)) for q0, q1, bounds in layout_tri], np.int32
    ).reshape(-1, 3)
    range_meta = np.asarray(
        [rw for _, _, bounds in layout_tri for rw in bounds], np.int32
    ).reshape(-1, 3)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dep_k = _as_i32(dep_k)
    dep_pos = _as_i32(dep_pos)
    sm = np.ascontiguousarray(seg_meta)
    rm = np.ascontiguousarray(range_meta)
    h = lib.nrq_tri_fill(
        Lpad, CB, dep_k.size,
        dep_k.ctypes.data_as(i32p), dep_pos.ctypes.data_as(i32p),
        sm.ctypes.data_as(i32p), sm.shape[0], rm.ctypes.data_as(i32p),
    )
    try:
        nchunks = Lpad // CB
        counts = np.ctypeslib.as_array(lib.nrq_tp_counts(h), shape=(Lpad,)).copy()
        posmap = np.ctypeslib.as_array(lib.nrq_tp_posmap(h), shape=(Lpad,)).copy()
        tinv = np.ctypeslib.as_array(lib.nrq_tp_tinv(h), shape=(nchunks, CB, CB // 8)).copy()
        if lib.nrq_tp_status(h):
            return False, posmap, tinv, None, counts
        ix_len = int(lib.nrq_tp_ix_len(h))
        ix_flat = (
            np.ctypeslib.as_array(lib.nrq_tp_ix(h), shape=(ix_len,)).copy()
            if ix_len else np.zeros(0, np.uint16)
        )
    finally:
        lib.nrq_tp_free(h)
    segments = []
    off = 0
    for (q0, nq, _), (_, _, bounds) in zip(seg_meta, layout_tri):
        ranges = []
        for a, b, w in bounds:
            n = int(nq) * int(b - a) * int(w)
            ranges.append((int(a), int(b), ix_flat[off : off + n].reshape(nq, b - a, w)))
            off += n
        segments.append((int(q0), int(nq), ranges))
    return True, posmap, tinv, segments, counts


def host_repair(P, items, T: int, nthreads: int = 0):
    """Batched host-side block repair (nrq_host_repair): the adaptive
    runtime's CPU arm — solve + substitution + LT gap combine fused in one
    native call, no device traffic.

    items: [(rows_csr, row_ptrs, gap_csr)] per block, same K':
      rows_csr — CSRRows of the patched binary system (cache._patched_rows)
      row_ptrs — np.uint64 [NB] per-ROW payload addresses (each T readable
                 bytes; rows are only read).  The CALLER must keep every
                 backing buffer alive across the call.
      gap_csr  — CSRRows of the gap ESIs' LT rows (cache._rows_subset)

    Returns (outs, statuses): outs[b] is np.uint8 [ngaps, T] (valid iff
    statuses[b] == 0); statuses: 0 ok, 1 rank-deficient (decode failure —
    feed more symbols and retry).  HDPC-pivot factorizations (overhead < H)
    are handled natively via the GF(256) nibble-LUT axpy.  nthreads > 1
    fans blocks over that many native threads (0 = env NANORQ_HOST_THREADS,
    default 1).  None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    from nanorq_tpu_torch.precode.matrix import hdpc_full_rows

    if not nthreads:
        nthreads = int(os.environ.get("NANORQ_HOST_THREADS", "1"))
    nb = len(items)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    hdpc = np.ascontiguousarray(hdpc_full_rows(P), dtype=np.uint8)
    NBs = np.fromiter((len(r) for r, _, _ in items), np.int32, nb)
    rp = [np.ascontiguousarray(r.ptr, np.int32) for r, _, _ in items]
    rc = [np.ascontiguousarray(r.cols, np.int32) for r, _, _ in items]
    gp = [np.ascontiguousarray(g.ptr, np.int32) for _, _, g in items]
    gc = [np.ascontiguousarray(g.cols, np.int32) for _, _, g in items]
    dp = [np.ascontiguousarray(p, np.uint64) for _, p, _ in items]
    row_ptr_all = np.concatenate(rp)
    row_cols_all = np.concatenate(rc) if any(a.size for a in rc) else np.zeros(1, np.int32)
    gap_ptr_all = np.concatenate(gp)
    gap_cols_all = np.concatenate(gc) if any(a.size for a in gc) else np.zeros(1, np.int32)
    rowp_all = np.concatenate(dp)

    def offs(parts):
        o = np.zeros(nb, np.int64)
        o[1:] = np.cumsum([p.size for p in parts[:-1]])
        return o

    rp_off, rc_off = offs(rp), offs(rc)
    gp_off, gc_off = offs(gp), offs(gc)
    dp_off = offs(dp)

    ngaps = np.fromiter((len(g) for _, _, g in items), np.int32, nb)
    outs = [np.empty((int(n), T), np.uint8) for n in ngaps]
    out_ptrs = np.fromiter((o.ctypes.data for o in outs), np.uint64, nb)
    statuses = np.empty(nb, np.int32)

    lib.nrq_host_repair(
        nb, P.L, P.W, P.S, P.H, T,
        NBs.ctypes.data_as(i32p),
        rp_off.ctypes.data_as(i64p), row_ptr_all.ctypes.data_as(i32p),
        rc_off.ctypes.data_as(i64p), row_cols_all.ctypes.data_as(i32p),
        hdpc.ctypes.data_as(u8p),
        dp_off.ctypes.data_as(i64p), rowp_all.ctypes.data_as(u64p),
        ngaps.ctypes.data_as(i32p),
        gp_off.ctypes.data_as(i64p), gap_ptr_all.ctypes.data_as(i32p),
        gc_off.ctypes.data_as(i64p), gap_cols_all.ctypes.data_as(i32p),
        out_ptrs.ctypes.data_as(u64p),
        statuses.ctypes.data_as(i32p),
        nthreads,
    )
    return outs, statuses


_lt_tables_set = False
_lt_tables_keep = None  # keeps the table arrays alive across the C call


def _ensure_lt_tables(lib) -> None:
    """One-time injection of the RFC 6330 normative tables into the native
    library (nrq_lt_init) so its LT row generator matches rfc/tuples.py."""
    global _lt_tables_set, _lt_tables_keep
    if _lt_tables_set:
        return
    from nanorq_tpu_torch.rfc.tables import DEGREE_DIST, V0, V1, V2, V3

    u32p = ctypes.POINTER(ctypes.c_uint32)
    arrs = [np.ascontiguousarray(a, np.uint32) for a in (V0, V1, V2, V3, DEGREE_DIST)]
    _lt_tables_keep = arrs
    lib.nrq_lt_init(*(a.ctypes.data_as(u32p) for a in arrs), len(arrs[4]))
    _lt_tables_set = True


def host_repair_shared(P, base, blocks, T: int, nthreads: int = 0):
    """Batched host-side block repair with NATIVE per-pattern prep
    (nrq_host_repair2): each block's patched binary system is assembled in
    C++ from the K'-shared base CSR plus (gaps, repair ISIs) — no per-block
    Python row construction (the reference's patch_precode_matrix shape,
    nanorq.c:527-547, fused into the repair call).

    base — CSRRows of the loss-independent encoder system rows for K'
           (cache._base_rows: Kp LT rows + S LDPC rows)
    blocks — [(gaps, rep_isis, row_ptrs, out_rowp)] per block, same K':
      gaps     int [ng] missing source ESIs, ascending
      rep_isis uint32 [ng + ov] repair ISIs (gap slots then overhead rows)
      row_ptrs np.uint64 [Kp+ov+S] per-ROW payload addresses (caller keeps
               every backing buffer alive across the call; rows only read)
      out_rowp np.uint64 [ng] per-ROW output addresses (each T writable
               bytes — e.g. straight into the decode output object), or
               None to have a temp [ng, T] allocated here

    Returns (outs, statuses): outs[b] is the temp array (None where the
    caller supplied out_rowp — rows were written through the pointers,
    valid iff statuses[b] == 0).  None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from nanorq_tpu_torch.precode.matrix import hdpc_full_rows

    _ensure_lt_tables(lib)
    if not nthreads:
        nthreads = int(os.environ.get("NANORQ_HOST_THREADS", "1"))
    nb = len(blocks)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    hdpc = np.ascontiguousarray(hdpc_full_rows(P), dtype=np.uint8)
    base_ptr = np.ascontiguousarray(base.ptr, np.int64)
    base_cols = np.ascontiguousarray(base.cols, np.int32)

    ngaps = np.fromiter((g.size for g, _, _, _ in blocks), np.int32, nb)
    novs = np.fromiter((r.size - g.size for g, r, _, _ in blocks), np.int32, nb)

    def cat(parts, dtype):
        out = np.concatenate([np.ascontiguousarray(p, dtype) for p in parts]) \
            if any(p.size for p in parts) else np.zeros(1, dtype)
        offs = np.zeros(nb, np.int64)
        offs[1:] = np.cumsum([p.size for p in parts[:-1]])
        return out, offs

    outs: list = [None] * nb
    orows = []
    for j, (g, _, _, op) in enumerate(blocks):
        if op is None:
            outs[j] = np.empty((g.size, T), np.uint8)
            op = np.uint64(outs[j].ctypes.data) + np.arange(g.size, dtype=np.uint64) * np.uint64(T)
        orows.append(op)

    gaps_all, gaps_off = cat([g for g, _, _, _ in blocks], np.int32)
    risis_all, ri_off = cat([r for _, r, _, _ in blocks], np.uint32)
    rowp_all, dp_off = cat([p for _, _, p, _ in blocks], np.uint64)
    orow_all, op_off = cat(orows, np.uint64)
    statuses = np.empty(nb, np.int32)

    lib.nrq_host_repair2(
        nb, P.L, P.W, P.S, P.H, T,
        P.Kp, P.P1, P.P, P.J,
        base_ptr.ctypes.data_as(i64p), base_cols.ctypes.data_as(i32p),
        hdpc.ctypes.data_as(u8p),
        novs.ctypes.data_as(i32p),
        ri_off.ctypes.data_as(i64p), risis_all.ctypes.data_as(u32p),
        dp_off.ctypes.data_as(i64p), rowp_all.ctypes.data_as(u64p),
        ngaps.ctypes.data_as(i32p),
        gaps_off.ctypes.data_as(i64p), gaps_all.ctypes.data_as(i32p),
        op_off.ctypes.data_as(i64p), orow_all.ctypes.data_as(u64p),
        statuses.ctypes.data_as(i32p),
        nthreads,
    )
    return outs, statuses


def host_residual(kc: int, blocks, T: int, nthreads: int = 0):
    """Batched solve-free host repair (nrq_host_residual): X = R (y ^ W D0)
    against the canonical factorization — see codec/api.py
    _repair_residual_host_batch.  The gap-system left inverse R is computed
    natively per block.

    blocks: [(gaps, W, d0_ptrs, y_ptrs, out_rowp)] per block, same K':
      gaps     int [g] missing source ESIs, ascending
      W        uint8 [nr, kc] canonical combination rows (cache.res_wrows)
      d0_ptrs  np.uint64 [kc] per-COLUMN payload addresses (0 = zero row)
      y_ptrs   np.uint64 [nr] repair payload addresses
      out_rowp np.uint64 [g] per-ROW output addresses, or None for a temp
    (The caller keeps every backing buffer alive across the call.)

    Returns (outs, statuses): outs[b] is the temp [g, T] (None where the
    caller supplied out_rowp), valid iff statuses[b] == 0 (1 = rank-
    deficient).  None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not nthreads:
        nthreads = int(os.environ.get("NANORQ_HOST_THREADS", "1"))
    nb = len(blocks)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    ngaps = np.fromiter((g.size for g, _, _, _, _ in blocks), np.int32, nb)
    nrs = np.fromiter((w.shape[0] for _, w, _, _, _ in blocks), np.int32, nb)

    def cat(parts, dtype):
        out = np.concatenate([np.ascontiguousarray(p, dtype).reshape(-1) for p in parts]) \
            if any(p.size for p in parts) else np.zeros(1, dtype)
        offs = np.zeros(nb, np.int64)
        offs[1:] = np.cumsum([p.size for p in parts[:-1]])
        return out, offs

    outs: list = [None] * nb
    orows = []
    for j, (g, _, _, _, op) in enumerate(blocks):
        if op is None:
            outs[j] = np.empty((g.size, T), np.uint8)
            op = np.uint64(outs[j].ctypes.data) + np.arange(g.size, dtype=np.uint64) * np.uint64(T)
        orows.append(op)

    gaps_all, gaps_off = cat([g for g, _, _, _, _ in blocks], np.int32)
    W_all, w_off = cat([w for _, w, _, _, _ in blocks], np.uint8)
    d0p_all, dp_off = cat([d for _, _, d, _, _ in blocks], np.uint64)
    yp_all, yp_off = cat([y for _, _, _, y, _ in blocks], np.uint64)
    orow_all, op_off = cat(orows, np.uint64)
    statuses = np.empty(nb, np.int32)

    lib.nrq_host_residual(
        nb, T, kc,
        nrs.ctypes.data_as(i32p),
        ngaps.ctypes.data_as(i32p),
        gaps_off.ctypes.data_as(i64p), gaps_all.ctypes.data_as(i32p),
        w_off.ctypes.data_as(i64p), W_all.ctypes.data_as(u8p),
        dp_off.ctypes.data_as(i64p), d0p_all.ctypes.data_as(u64p),
        yp_off.ctypes.data_as(i64p), yp_all.ctypes.data_as(u64p),
        op_off.ctypes.data_as(i64p), orow_all.ctypes.data_as(u64p),
        statuses.ctypes.data_as(i32p),
        nthreads,
    )
    return outs, statuses


def host_residual_flat(kc: int, T: int, nrs, ngaps, gaps_all, gaps_off,
                       W_all, d0p_all, yp_all, orow_all, nthreads: int = 0):
    """Pre-flattened variant of host_residual: the caller supplies the
    concatenated layouts directly (W_all [sum nr, kc] row-stacked, d0p_all
    [nb*kc], yp_all [sum nr], orow_all [sum g], offsets derived from
    nrs/ngaps here) so no per-block arrays or concat copies are built.
    Returns statuses int32 [nb] (0 ok, 1 rank-deficient), or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not nthreads:
        nthreads = int(os.environ.get("NANORQ_HOST_THREADS", "1"))
    nb = len(nrs)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    nrs = np.ascontiguousarray(nrs, np.int32)
    ngaps = np.ascontiguousarray(ngaps, np.int32)

    def offs_of(sizes):
        o = np.zeros(nb, np.int64)
        if nb > 1:
            np.cumsum(sizes[:-1].astype(np.int64), out=o[1:])
        return o

    yp_off = offs_of(nrs)
    w_off = yp_off * kc
    gaps_off = np.ascontiguousarray(gaps_off, np.int64)
    op_off = offs_of(ngaps)
    dp_off = np.arange(nb, dtype=np.int64) * kc
    statuses = np.empty(nb, np.int32)

    lib.nrq_host_residual(
        nb, T, kc,
        nrs.ctypes.data_as(i32p),
        ngaps.ctypes.data_as(i32p),
        gaps_off.ctypes.data_as(i64p), gaps_all.ctypes.data_as(i32p),
        w_off.ctypes.data_as(i64p), W_all.ctypes.data_as(u8p),
        dp_off.ctypes.data_as(i64p), d0p_all.ctypes.data_as(u64p),
        yp_off.ctypes.data_as(i64p), yp_all.ctypes.data_as(u64p),
        op_off.ctypes.data_as(i64p), orow_all.ctypes.data_as(u64p),
        statuses.ctypes.data_as(i32p),
        nthreads,
    )
    return statuses


def lt_row_native(X: int, P) -> np.ndarray | None:
    """Testing probe: the native LT row generator's column indices for ISI X
    (None when the native library is unavailable)."""
    lib = get_lib()
    if lib is None:
        return None
    _ensure_lt_tables(lib)
    out = np.empty(40, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    n = lib.nrq_lt_row(int(X), P.W, P.P1, P.P, P.J, out.ctypes.data_as(i32p))
    return out[:n]


def res_rinv(Gs: list, nthreads: int = 0):
    """Batched GF(256) left inverses for the residual decode arm
    (nrq_res_rinv): for each G [nr_b, g_b] find R [g_b, nr_b] with
    R G = I (supported on g_b independent rows of G).

    Returns (Rs, statuses) — Rs[b] valid iff statuses[b] == 0 (1 =
    rank-deficient: the same decode failure the patched solve would
    surface; feed more symbols and retry).  None if the native library is
    unavailable (the caller reroutes to another arm).
    """
    lib = get_lib()
    if lib is None:
        return None
    if not nthreads:
        nthreads = int(os.environ.get("NANORQ_HOST_THREADS", "1"))
    nb = len(Gs)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    nrs = np.fromiter((G.shape[0] for G in Gs), np.int32, nb)
    gs = np.fromiter((G.shape[1] for G in Gs), np.int32, nb)
    sizes = (nrs.astype(np.int64) * gs)
    g_off = np.zeros(nb, np.int64)
    g_off[1:] = np.cumsum(sizes[:-1])
    G_all = np.concatenate([np.ascontiguousarray(G, np.uint8).reshape(-1) for G in Gs]) \
        if int(sizes.sum()) else np.zeros(1, np.uint8)
    R_all = np.empty(max(int(sizes.sum()), 1), np.uint8)
    statuses = np.empty(nb, np.int32)
    lib.nrq_res_rinv(
        nb, nrs.ctypes.data_as(i32p), gs.ctypes.data_as(i32p),
        g_off.ctypes.data_as(i64p), G_all.ctypes.data_as(u8p),
        g_off.ctypes.data_as(i64p), R_all.ctypes.data_as(u8p),
        statuses.ctypes.data_as(i32p), nthreads,
    )
    Rs = [
        R_all[int(o) : int(o) + int(n)].reshape(int(g), int(r))
        for o, n, g, r in zip(g_off, sizes, gs, nrs)
    ]
    return Rs, statuses
