"""Compile a SolveState into the structured TPU replay program.

Instead of streaming ~3L..40L elementary row ops (whose dependency depth is
O(L) — hopeless on a wide machine), the device executes six batched stages
derived from the block factorization of A^{-1}:

  1. t1   = T^-1 y            block forward substitution: scan over CB-row
                              chunks; each step = sparse XOR-gather of
                              earlier-chunk deps + dense GF(2) matmul with
                              the precomputed chunk-inverse (MXU)
  2. zsel = y_sel ^ B_sel t1  sparse bucketed XOR-gather for binary rows,
                              dense GF(256) matmul (companion bit-planes,
                              MXU) for the <=H HDPC rows
  3. x_u  = Vinv zsel         dense GF(256) matmul with the precomputed
                              inverse of the u x u Schur pivot block
  4. x_a  = t1 ^ Wut x_u      ONE dense GF(2) MXU matmul: Wut = T^-1 U_t is
                              precomputed on the host (binary even when HDPC
                              pivots were taken — the triangle is GF(2)), so
                              x_a = T^-1 (y ^ U_t x_u) = t1 ^ Wut x_u needs
                              neither a second trisolve nor the U_t gather
  5. C    = concat(x_a, x_u)[out_sel]

Stages 2-4 replace the reference's dense GE + backsolve replay entirely: the
host already knows the elimination's *net effect* (Vinv, Wut), so the device
never replays pivoting and solves the triangle exactly once.  Sequential
depth is ceil(L/CB) + 4 instead of O(L).

All shapes are canonically padded (triangle to ceil(L/CB)*CB, u and bucket
widths to quantized sizes) so decode schedules for the same K' hit the same
compiled XLA program across loss patterns.

Reference analog being replaced: precode_matrix_intermediate + apply_sched
(lib/precode.c:23-32, 379-389).
"""

import os
from dataclasses import dataclass

import numpy as np

from nanorq_tpu_torch.gf256.bitplane import gf2_matmul_bytes, gf256_matmul_bytes
from nanorq_tpu_torch.gf256.numpy_ops import gf_inv_matrix
from nanorq_tpu_torch.precode.matrix import hdpc_full_rows
from nanorq_tpu_torch.precode.solver import SolveState

_WIDTHS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# Triangle staircase-gather planning knobs (see compile_device): candidate
# prefix boundaries, quantized gather widths, and the DP's modeled cost of
# one more gather launch / one more segment (slots-equivalent).  Module
# scope so tools/bsweep-style probes can retune against hardware.  All env
# knobs are snapshotted at import time (setting them later has no effect).
CAND_GRID = tuple(sorted(set(
    list(range(0, 16)) + list(range(16, 33, 2))
    + [40, 48, 56, 64, 80, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768, 896]
)))
# power-of-two gather widths only: denser grids (3, 5, 6, ...) fill slots
# better but measured *slower* per slot in the DMA gather kernel; pow2-wide
# scratch tiles win end to end (A/B at K=50000: 27.96 vs 28.32 ms full).
# "hybrid64" (the default) keeps pow2 below 64 (where the small-width
# slowdown was measured) and adds 64-multiples above, where the heavy-row
# ranges quantize 130-200-degree rows up to 256 — on-chip A/B at K=50000
# B=1 (tools/replay_stage_prof.py): slots 546928 -> 494960 (-9.5%), fill
# 50% -> 56%, trisolve 9.37 -> 7.84 ms, full replay 19.15 -> 18.73 ms.
_WQ_GRIDS = {
    "dense": (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64,
              80, 96, 128, 160, 192, 256, 320, 384, 512, 768, 1024, 2048, 4096),
    "hybrid64": (1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 160, 192, 224, 256, 320, 384,
                 448, 512, 640, 768, 1024, 2048, 4096),
    "pow2": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096),
}
WIDTH_GRID = _WQ_GRIDS.get(os.environ.get("NANORQ_TRI_WQ", "hybrid64"),
                           _WQ_GRIDS["hybrid64"])
TRI_RANGE_PENALTY = int(os.environ.get("NANORQ_TRI_RP", 768))
TRI_SEG_PENALTY_CHUNKS = int(os.environ.get("NANORQ_TRI_SP", 8))  # x CB
TRI_MAX_RANGES = int(os.environ.get("NANORQ_TRI_MR", 6))
# segment-length grid shared by both planners: dense short lengths,
# quantized long ones (a full 64-wide window was the compile-time hot spot)
SEG_LENS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 20, 24, 32, 40, 48, 64)


def _idx(a: np.ndarray, bound: int) -> np.ndarray:
    """Index array dtype for device upload: uint16 when every value (and the
    sentinel `bound`) fits, else int32.  Halves schedule upload bytes — the
    per-loss-pattern decode tensors ride a ~20 MB/s link on the test rig."""
    return np.asarray(a, np.uint16 if bound < 65536 else np.int32)


def _quant(n: int, grid=_WIDTHS) -> int:
    for w in grid:
        if n <= w:
            return w
    return int(grid[-1] * (1 + (n - 1) // grid[-1]))


def _pad_rows(n: int) -> int:
    return max(8, _quant(n))


def default_cb(L: int) -> int:
    """Measured-on-v5e chunk size: mid-size triangles amortize per-chunk
    overhead with bigger chunks; at large L the chunk-inverse matmul
    dominates and smaller chunks win (staircase gathers keep the dep
    traffic nearly CB-independent)."""
    return 256 if L <= 2048 else (512 if L <= 16384 else 256)


def _invert_tri_chunks(T: np.ndarray) -> None:
    """In-place GF(2) inversion of [n, CB, CB] unit-lower-triangular blocks:
    Tinv[r] = e_r ^ XOR_{c<r, T[r,c]=1} Tinv[c].  Native when available."""
    try:
        from nanorq_tpu_torch.native import get_lib

        lib = get_lib()
    except Exception:
        lib = None
    n, CB, _ = T.shape
    if lib is not None:
        import ctypes

        Tc = np.ascontiguousarray(T)
        lib.nrq_tinv_chunks(Tc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, CB)
        T[:] = Tc
        return
    for q in range(n):
        Tq = T[q]
        inv = np.eye(CB, dtype=np.uint8)
        for r in range(CB):
            below = np.nonzero(Tq[r, :r])[0]
            for c in below:
                inv[r] ^= inv[c]
        T[q] = inv


def _invert_conj_tri_chunks(T: np.ndarray, order: np.ndarray) -> None:
    """Invert [n, CB, CB] unit-lower-triangular chunks and conjugate each by
    its intra-chunk permutation (new position -> old position), in place:
    T[q] <- P_q T[q]^-1 P_q^T.  Fused native path when available."""
    n, CB, _ = T.shape
    try:
        from nanorq_tpu_torch.native import get_lib

        lib = get_lib()
    except Exception:
        lib = None
    if lib is not None:
        import ctypes

        Tc = np.ascontiguousarray(T)
        oc = np.ascontiguousarray(order, dtype=np.int32)
        lib.nrq_tinv_conj_chunks(
            Tc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            oc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, CB,
        )
        T[:] = Tc
        return
    _invert_tri_chunks(T)
    rows = T[np.arange(n)[:, None], order]
    T[:] = np.take_along_axis(rows, order[:, None, :], axis=2)


@dataclass
class GatherPlan:
    """Scatter-free sparse XOR-apply: out[r] ^= XOR of src[deps[r]].

    Row-aligned full-coverage passes handle the common small-degree rows
    (result rows line up with the output, so application is elementwise XOR
    — dynamic row-scatters cost ~30x an aligned XOR on TPU).  The few wide
    rows go through quantized-width overflow gathers placed by a width-1
    gather (`sel`), since each output row receives at most one result.
    """

    n_rows: int
    passes: list[np.ndarray]  # int32 [n_rows, w_p], sentinel-padded
    # overflow width classes: (idx [nb, w], sel [n_rows]); each output row
    # receives at most one overflow result, so placement is a width-1 gather
    # (sel sentinel nb -> appended zero row), never a scatter or matmul
    overflow: list[tuple[np.ndarray, np.ndarray]]

    @property
    def empty(self) -> bool:
        return not self.passes and not self.overflow


def _gather_plan(n_rows, slots, deps, sentinel, w_small: int = 8) -> GatherPlan:
    """Build a GatherPlan from per-slot dep lists (slots index [0, n_rows))."""
    slots = np.asarray(slots, np.int64)
    lens = np.fromiter((len(d) for d in deps), np.int64, len(deps))
    erows = np.repeat(slots, lens)
    edeps = np.concatenate(deps) if len(deps) else np.zeros(0, np.int64)
    return _gather_plan_flat(n_rows, erows, np.asarray(edeps, np.int64), sentinel, w_small)


def _gather_plan_flat(n_rows, erows, edeps, sentinel, w_small: int = 8, classes=None):
    """Vectorized GatherPlan construction from flat (row, dep) edge arrays.

    `classes`: optional frozen overflow layout [(w, nb), ...] (see
    compile_device's canonical-layout cache).  When given, the plan emits
    EXACTLY one w_small pass plus one overflow entry per class — shapes are
    layout-determined, never data-determined — and returns None when the
    pattern does not fit (a row degree above every class width, or more
    rows in a band than its nb), signalling the caller to grow the layout.
    """
    if erows.size == 0 and classes is None:
        return GatherPlan(n_rows=n_rows, passes=[], overflow=[])
    order = np.argsort(erows, kind="stable")
    erows = erows[order]
    edeps = edeps[order]
    counts = np.bincount(erows, minlength=n_rows).astype(np.int64)
    starts = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    colpos = np.arange(erows.size, dtype=np.int64) - starts[erows]
    cmax = int(counts.max(initial=0))

    passes: list[np.ndarray] = []
    overflow = []
    p = np.full((n_rows, w_small), sentinel, np.int32)
    sel = counts[erows] <= w_small
    p[erows[sel], colpos[sel]] = edeps[sel]
    if sel.any() or classes is not None:
        passes.append(_idx(p, sentinel))

    if classes is not None:
        if cmax > max((w for w, _ in classes), default=w_small):
            return None
        lo = w_small
        for w, nb in classes:
            pick = np.nonzero((counts > lo) & (counts <= w))[0]
            if pick.size > nb:
                return None
            rmap = np.full(n_rows, -1, np.int64)
            rmap[pick] = np.arange(pick.size)
            m = rmap[erows] >= 0
            ix = np.full((nb, w), sentinel, np.int32)
            ix[rmap[erows[m]], colpos[m]] = edeps[m]
            selv = np.full(n_rows, nb, np.int32)
            selv[pick] = np.arange(pick.size)
            overflow.append((_idx(ix, sentinel), _idx(selv, nb)))
            lo = w
        return GatherPlan(n_rows=n_rows, passes=passes, overflow=overflow)

    lo = w_small
    widths = [x for x in _WIDTHS if x > w_small]
    if cmax > _WIDTHS[-1]:
        widths.append(_quant(cmax))  # beyond the grid: extended final class
    for w in widths:
        if lo >= cmax:
            break
        w = _quant(cmax) if w >= cmax else w  # last class: grid-quantized width
        pick = np.nonzero((counts > lo) & (counts <= w))[0]
        if pick.size:
            nb = _pad_rows(pick.size)
            rmap = np.full(n_rows, -1, np.int64)
            rmap[pick] = np.arange(pick.size)
            m = rmap[erows] >= 0
            ix = np.full((nb, w), sentinel, np.int32)
            ix[rmap[erows[m]], colpos[m]] = edeps[m]
            selv = np.full(n_rows, nb, np.int32)  # sentinel: zero row of red_ext
            selv[pick] = np.arange(pick.size)
            overflow.append((_idx(ix, sentinel), _idx(selv, nb)))
        lo = w
    return GatherPlan(n_rows=n_rows, passes=passes, overflow=overflow)


@dataclass
class TriSegment:
    """A run of triangle chunks sharing one uniform dep-shape profile.

    Rows within each chunk are permuted so cross-chunk degree is
    non-increasing (the chunk inverse is conjugated by the same permutation),
    which lets the dep application run as a few prefix-range gathers
    `acc[a:b] ^= XOR z[idx]` with staircase-tight widths — no bucket+select
    indirection and near-zero sentinel padding.
    """

    q0: int  # first chunk index
    # uint8 [nq, CB, CB/8] chunk inverses (degree-sorted basis), bit-packed
    # little-endian along the last axis (np.packbits layout) — uploaded as-is
    tinv: np.ndarray
    # prefix dep ranges: (a, b, idx int32 [nq, b-a, w]); rows [a, b) of each
    # chunk XOR the gathered rows of z (sentinel Lpad -> zero row)
    ranges: list[tuple[int, int, np.ndarray]]


@dataclass
class DeviceSchedule:
    """Structured replay program (all NumPy; converted to jnp at run time)."""

    L: int
    M: int  # logical rows of D used (= L + overhead)
    M_pad: int  # padded D rows the executor expects (>= M + 1, row M_pad-1 zero)
    i: int
    u: int
    CB: int
    Lpad: int  # ceil(L/CB)*CB: padded triangle size
    u_pad: int
    piv_rows: np.ndarray  # int32 [Lpad], D-row per triangle position (pad: zero row)
    # triangle chunks grouped into segments of uniform per-chunk shape, each
    # a lax.scan on device (compile time O(#segments), not O(L)).  Chunks
    # with many wide rows (the LDPC-heavy peel tail) get their own segment
    # with wider pass/overflow classes so clean chunks pay nothing for them.
    tri: list  # [TriSegment]
    sel_rows: np.ndarray  # int32 [u_pad] D-rows of dense pivot rows (pad: zero row)
    bsel: GatherPlan  # binary sel-row deps into t1 (n_rows=u_pad)
    hd_sel: np.ndarray | None  # int32 [u_pad] HDPC-row index per zsel row (sentinel H_pad)
    mhd: np.ndarray | None  # uint8 [H_pad, Lpad]: Ahd[:, piv_cols], zero-padded rows
    vinv: np.ndarray  # uint8 [u_pad, u_pad] inverse of the Schur pivot block
    # Wut = T^-1 U_t bit-packed little-endian along u: uint8 [Lpad, u_pad/8].
    # Fuses the former stage-4 U_t gather + stage-5 second trisolve into one
    # GF(2) matmul (x_a = t1 ^ Wut x_u) — host-precomputed, so the device
    # triangle runs once per replay instead of twice.
    wut: np.ndarray
    out_sel: np.ndarray  # int32 [L] into concat(x_active[Lpad], x_u[u_pad])
    # Compiled against the per-K' canonical layout (the decode path): its
    # device arrays keep every padded shape, so that the patterns of one
    # signature share one replay program (ops/replay.device_arrays).  Set on
    # the instance by compile_device, not a field: the fields are the JAX
    # package's, and a copy by dataclasses.replace runs on its own extents.
    canonical = False

    @property
    def nchunks(self) -> int:
        return self.Lpad // self.CB


def compile_device(st: SolveState, CB: int | None = None, canonical: bool = False) -> DeviceSchedule:
    """Compile a SolveState into the device replay program.

    canonical=True (the decode path) compiles against the per-K' frozen
    layout so every loss pattern of one K' shares ONE jitted XLA program;
    the encoder (canonical=False) keeps its own DP-optimal layout — it is
    compiled once per K' and replayed forever.
    """
    P = st.P
    L, i, u, M = P.L, st.i, st.u, st.M
    if CB is None:
        CB = default_cb(L)
    Lpad = -(-L // CB) * CB
    u_pad = max(32, _quant(max(u, 1)))  # >= 32: int8 sublane-tile floor
    M_pad = _pad_rows(M + 1)
    zero_row = M_pad - 1  # executor guarantees D[M_pad-1] == 0

    # --- triangle: per-position deps at pivot columns with smaller position.
    # Built from flat edge arrays (the per-pivot Python loop was the
    # compile-time hot spot at K' = 56403).  The native solver pre-extracts
    # both edge lists during its own CSR scan; the NumPy path below re-scans.
    ut_edges = getattr(st, "ut_edges", None)
    if getattr(st, "tri_edges", None) is not None and ut_edges is not None:
        dep_k, dep_pos = st.tri_edges
    else:
        if i:
            from nanorq_tpu_torch.precode.matrix import CSRRows

            rc = st.rows_cols if isinstance(st.rows_cols, CSRRows) else CSRRows.from_list(st.rows_cols)
            kk, cols_flat = rc.select_flat(st.piv_rows)
        else:
            cols_flat = np.zeros(0, np.int64)
            kk = np.zeros(0, np.int64)
        pos = st.pivpos_of_col[cols_flat]
        dm = (pos >= 0) & (pos < kk)
        dep_k, dep_pos = kk[dm], pos[dm]

    if canonical:
        key = (P.Kp, CB, u_pad, M_pad, bool(st.hdpc_used))
        # Heavy-position reorder: positions whose cross-position dep degree
        # exceeds the light/heavy gap (LT-derived rows stay ~<=30; late-peel
        # rows jump to ~180), forward-closed over dependents, move to a
        # FIXED zone at the end of an extended triangle.  Light-zone degree
        # profiles are then low-variance across loss patterns and the heavy
        # zone is positionally pinned — which is what lets one frozen layout
        # (= one compiled XLA program) fit every pattern of a K'.
        closed, zrank = _heavy_zone_order(i, dep_k, dep_pos)
        nheavy = int(closed.sum())
        with _layout_lock:
            stt = _layout_cache.get(key)
            if stt is not None and nheavy > stt.hpad:
                stt = None  # zone overflowed: rebuild with a bigger one
            if stt is None:
                # zone capacity ~1.5x the first-seen closed population,
                # rounded to whole chunks (the extended triangle must keep
                # Lpad % CB == 0 for every caller-supplied CB, not just the
                # default_cb values that happen to divide _quant outputs)
                hp = _quant(nheavy + max(256, nheavy // 2)) if nheavy else 0
                hp = -(-hp // CB) * CB
                stt = _layout_cache[key] = _LayoutState((Lpad + hp) // CB, CB, hp)
            _layout_cache.move_to_end(key)
            while len(_layout_cache) > _LAYOUT_CAPACITY:
                _layout_cache.popitem(last=False)
            # snapshot: fills and bsel classes must come from ONE layout
            # version even if a concurrent pattern re-freezes meanwhile
            lay0 = stt.layout
        Lpad += stt.hpad  # extended triangle; [nlight, Lpad-hpad) is padding
        if nheavy:
            perm = np.empty(i, np.int64)
            light_idx = np.nonzero(~closed)[0]
            perm[light_idx] = np.arange(light_idx.size)
            ci = np.nonzero(closed)[0]
            perm[ci] = (Lpad - stt.hpad) + zrank[ci].astype(np.int64)
            dep_k2, dep_pos2 = perm[dep_k], perm[dep_pos]
        else:
            perm = np.arange(max(i, 1), dtype=np.int64)[:i]
            dep_k2, dep_pos2 = dep_k, dep_pos

        def _native_fill(lay):
            """(fit, posmap, tinv_packed, [TriSegment]|None, counts) or None."""
            try:
                from nanorq_tpu_torch.native import tri_fill_native
            except (ImportError, OSError):
                return None
            res = tri_fill_native(Lpad, CB, dep_k2, dep_pos2, lay.tri)
            if res is None:
                return None
            fit, pm, tinvp, segs, counts = res
            tri_segs = None
            if fit:
                tri_segs = [
                    TriSegment(q0=q0, tinv=tinvp[q0 : q0 + nq], ranges=rngs)
                    for q0, nq, rngs in segs
                ]
            return fit, pm, tinvp, tri_segs, counts

        # hot path: fill the frozen layout natively (sort + chunk inverses +
        # validate + scatter in C++); the NumPy pipeline is the fallback and
        # the warm-up/freeze path (which need only the posmap + degree
        # profile up front — two bincounts and an argsort, not the full
        # sorted-edge machinery)
        sorted_edges = None
        tri = None
        nat = _native_fill(lay0) if lay0 is not None else None
        if nat is not None:
            _fit, posmap, _tinvp, tri, counts = nat
            degs = counts.astype(np.int64).reshape(-1, CB)
        else:
            ext = dep_pos2 < (dep_k2 // CB) * CB
            deg_pos = np.bincount(dep_k2[ext], minlength=Lpad)
            order_in_chunk = np.argsort(-deg_pos.reshape(-1, CB), axis=1, kind="stable")
            rank = np.empty((Lpad // CB, CB), np.int64)
            np.put_along_axis(rank, order_in_chunk,
                              np.broadcast_to(np.arange(CB), (Lpad // CB, CB)), axis=1)
            posmap = (np.arange(Lpad) // CB) * CB + rank.reshape(-1)
            degs = np.sort(deg_pos.reshape(-1, CB), axis=1)[:, ::-1].astype(np.int64)
        posfull = posmap[perm] if i else np.zeros(0, np.int64)
    else:
        posmap, tri = _tri_plan(Lpad, CB, dep_k, dep_pos)
        posfull = posmap[:i]

    # everything downstream that references triangle positions moves to the
    # sorted (and, canonically, heavy-reordered) basis: y rows, stage-2
    # deps, HDPC columns, U_t rows, output
    piv_rows = np.full(Lpad, zero_row, np.int32)
    if i:
        piv_rows[posfull] = st.piv_rows

    # --- zsel: dense pivot rows ---
    order_sel = st.order[i : i + u]
    sel_rows = np.full(u_pad, zero_row, np.int32)
    sel_rows[:u] = order_sel.astype(np.int32)
    b_slots, b_deps = [], []
    hd_sel = np.nonzero(order_sel >= st.NB)[0]
    for s in range(u):
        r = int(order_sel[s])
        if r < st.NB:
            cols = st.rows_cols[r]
            pos = st.pivpos_of_col[cols]
            b_slots.append(s)
            b_deps.append(np.sort(posfull[pos[pos >= 0]]).astype(np.int64))
    b_lens = np.fromiter((len(d) for d in b_deps), np.int64, len(b_deps))
    b_erows = np.repeat(np.asarray(b_slots, np.int64), b_lens)
    b_edeps = (np.concatenate(b_deps) if b_deps else np.zeros(0, np.int64)).astype(np.int64)

    if not canonical:
        bsel = _gather_plan_flat(u_pad, b_erows, b_edeps, sentinel=Lpad)
    else:
        from nanorq_tpu_torch.utils import stats

        b_counts = np.zeros(u_pad, np.int64)
        if b_lens.size:
            b_counts[np.asarray(b_slots, np.int64)] = b_lens

        def np_fill(lay):
            nonlocal sorted_edges
            if sorted_edges is None:
                sorted_edges = _tri_sorted_edges(Lpad, CB, dep_k2, dep_pos2)
            (_pm, tb_, ec_, el_, ed_, cp_, dg_, nz_) = sorted_edges
            return _tri_fill_frozen(lay, Lpad, CB, ec_, el_, ed_, cp_, dg_, nz_, tb_)

        def fill_into(lay):
            res = _native_fill(lay)
            if res is not None:
                t = res[3]  # None on misfit
            else:
                t = np_fill(lay)
            if t is None:
                return None, None
            b = _gather_plan_flat(u_pad, b_erows, b_edeps, sentinel=Lpad,
                                  classes=lay.bsel_classes)
            return (None, None) if b is None else (t, b)

        # `stt` was resolved (or created, with its hpad) in the triangle
        # branch above; keep using that object even if a concurrent pattern
        # replaced the cache entry — its shapes match this computation.
        # lay0 is the layout snapshot the triangle fill ran against: the
        # bsel classes MUST come from the same version (a concurrent
        # re-freeze between the unlocked fill and here would otherwise mix
        # shapes from two layout versions into one never-reusable program).
        with _layout_lock:
            stt.accumulate(degs, b_counts)  # every pattern feeds the envelope
            if lay0 is not None:
                bsel = None
                if tri is None and nat is None:  # native unavailable: NumPy try
                    tri = np_fill(lay0)
                if tri is not None:
                    bsel = _gather_plan_flat(u_pad, b_erows, b_edeps, sentinel=Lpad,
                                             classes=lay0.bsel_classes)
                if tri is not None and bsel is not None:
                    stats.count("replay_layout_hit")
                else:  # profile outgrew the frozen shapes: re-freeze on the
                    # accumulated union (monotone; converges in a few events)
                    stt.freeze(Lpad, CB)
                    tri, bsel = fill_into(stt.layout)
                    assert tri is not None and bsel is not None  # envelope covers it
                    stats.count("replay_layout_grown")
            elif stt.seen >= _FREEZE_AFTER:
                stt.freeze(Lpad, CB)  # DP over the accumulated max profile
                tri, bsel = fill_into(stt.layout)
                assert tri is not None and bsel is not None  # envelope covers it
                stats.count("replay_layout_frozen")
            else:
                # warm-up: per-pattern DP plan (native), own program
                posmap_dp, tri = _tri_plan(Lpad, CB, dep_k2, dep_pos2)
                assert np.array_equal(posmap_dp, posmap)  # same stable sort
                bsel = _gather_plan_flat(u_pad, b_erows, b_edeps, sentinel=Lpad)
                stats.count("replay_layout_warmup")
    mhd = None
    hd_sel_vec = None
    if st.hdpc_used:
        Ahd = hdpc_full_rows(P)
        H_pad = 32  # Table 2 H is 10..16; pad to the int8 sublane-tile floor
        mhd = np.zeros((H_pad, Lpad), np.uint8)
        if i:
            mhd[: P.H, posfull] = Ahd[:, st.piv_cols]
        hd_sel_vec = np.full(u_pad, H_pad, np.int32)
        for s in hd_sel:
            hd_sel_vec[s] = int(order_sel[s]) - st.NB

    # --- Vinv: inverse of the Schur pivot block, padded with identity
    # (identity padding commutes with block-diagonal inversion) ---
    Vinv = np.eye(u_pad, dtype=np.uint8)
    if getattr(st, "vinv", None) is not None:  # native solver pre-inverted
        Vinv[:u, :u] = st.vinv
    elif u:
        inv = gf_inv_matrix(st.U_schur[order_sel])
        assert inv is not None  # solver succeeded => pivot block invertible
        Vinv[:u, :u] = inv

    # --- Wut = T^-1 U_t (U_t: triangle rows' original inactive-column
    # entries), solved on host over the tri dep edges, bit-packed along u ---
    if ut_edges is not None:
        ut_k, ut_uc = ut_edges
    else:
        ucf = st.ucol_of[cols_flat]
        um = ucf >= 0
        ut_k, ut_uc = kk[um], ucf[um]
    wut = _wut_solve(Lpad, u_pad, i, dep_k, dep_pos, ut_k, ut_uc, posfull)

    # --- output gather ---
    out_sel = np.zeros(L, np.int32)
    out_sel[st.piv_cols] = posfull.astype(np.int32)
    out_sel[st.u_cols] = Lpad + np.arange(u)

    ds = DeviceSchedule(
        L=L, M=M, M_pad=M_pad, i=i, u=u, CB=CB, Lpad=Lpad, u_pad=u_pad,
        piv_rows=_idx(piv_rows, M_pad - 1), tri=tri,
        sel_rows=_idx(sel_rows, M_pad - 1), bsel=bsel,
        hd_sel=None if hd_sel_vec is None else _idx(hd_sel_vec, 32), mhd=mhd,
        vinv=Vinv, wut=wut, out_sel=_idx(out_sel, Lpad + u),
    )
    ds.canonical = canonical
    return ds


def _wut_solve(Lpad, u_pad, i, dep_k, dep_pos, ut_k, ut_uc, posmap) -> np.ndarray:
    """Wut = T^-1 U_t over GF(2): uint8 [Lpad, u_pad//8], little-bit-packed
    along u, rows in the device (degree-sorted) basis.  Native forward
    substitution when available; vectorized-by-level NumPy otherwise."""
    WW = max(1, -(-u_pad // 64))
    x = np.zeros((max(i, 1), WW), np.uint64)
    if i and (ut_k.size or dep_k.size):
        try:
            from nanorq_tpu_torch.native import get_lib

            lib = get_lib()
        except Exception:
            lib = None
        if lib is not None:
            import ctypes

            i32p = ctypes.POINTER(ctypes.c_int32)
            u64p = ctypes.POINTER(ctypes.c_uint64)
            if not hasattr(lib, "_wut_bound"):
                lib.nrq_wut_solve.restype = None
                lib.nrq_wut_solve.argtypes = [
                    ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int64, i32p, i32p, ctypes.c_int64, i32p, i32p,
                    u64p,
                ]
                lib._wut_bound = True

            def pc(a):
                return np.ascontiguousarray(a, np.int32).ctypes.data_as(i32p)

            lib.nrq_wut_solve(
                i, WW, dep_k.size, pc(dep_k), pc(dep_pos),
                ut_k.size, pc(ut_k), pc(ut_uc), x.ctypes.data_as(u64p),
            )
        else:
            xb = np.zeros((max(i, 1), WW * 64), np.uint8)
            xb[np.asarray(ut_k, np.int64), np.asarray(ut_uc, np.int64)] = 1
            order = np.argsort(dep_k, kind="stable")
            ek = np.asarray(dep_k, np.int64)[order]
            ep = np.asarray(dep_pos, np.int64)[order]
            # levelized substitution: rows whose deps are all resolved XOR in
            # one vectorized pass (depth = longest dep chain, fine on the
            # CPU-test K sizes this fallback serves)
            pending = np.ones(ek.size, bool)
            resolved = np.zeros(i, bool)
            indeg = np.bincount(ek, minlength=i)
            resolved[indeg == 0] = True
            while pending.any():
                ready = pending & resolved[ep]
                if not ready.any():  # cycle impossible in a triangle
                    raise AssertionError("unresolvable tri deps")
                np.bitwise_xor.at(xb, ek[ready], xb[ep[ready]])
                pending &= ~ready
                resolved |= np.bincount(ek[pending], minlength=i) == 0
            x = np.ascontiguousarray(
                np.packbits(xb, axis=-1, bitorder="little").view(np.uint64)
            ).reshape(max(i, 1), WW)
    xbytes = x.view(np.uint8).reshape(max(i, 1), WW * 8)
    wut = np.zeros((Lpad, u_pad // 8), np.uint8)
    if i:
        wut[posmap[:i]] = xbytes[:i, : u_pad // 8]
    return wut


def _tri_plan(Lpad: int, CB: int, dep_k: np.ndarray, dep_pos: np.ndarray):
    """Plan the triangle replay: (posmap, [TriSegment]).  Native (C++) when
    available — this is the decode host-prep hot path — else NumPy."""
    try:
        from nanorq_tpu_torch.native import tri_plan_native

        if CB % 64:
            raise ImportError  # packed planner needs whole words per row
        if Lpad >= 65536:
            # the native planner stores indices + sentinel as uint16; an
            # extended canonical triangle at the largest K' can exceed that
            raise ImportError
        res = tri_plan_native(
            Lpad, CB, dep_k, dep_pos, [c for c in CAND_GRID if c < CB] + [CB],
            WIDTH_GRID, TRI_RANGE_PENALTY, TRI_SEG_PENALTY_CHUNKS * CB,
            TRI_MAX_RANGES, SEG_LENS,
        )
    except (ImportError, OSError):
        res = None
    if res is None:
        return _tri_plan_py(Lpad, CB, dep_k, dep_pos)
    posmap, tinv, segments = res
    tri = [
        TriSegment(q0=q0, tinv=tinv[q0 : q0 + nq], ranges=ranges)
        for q0, nq, ranges in segments
    ]
    return posmap, tri


def _tri_sorted_edges(Lpad: int, CB: int, dep_k: np.ndarray, dep_pos: np.ndarray):
    """Shared planner preamble: degree-sort positions within chunks, build
    the conjugated chunk inverses and the sorted cross-chunk edge arrays.

    Returns (posmap, tinv_bits [nchunks, CB, CB], echunk_s, elocal_s,
    edep_s, colpos, degs [nchunks, CB] non-increasing per row, nnz_row).
    """
    nchunks = Lpad // CB
    qq = dep_k // CB
    inck = dep_pos >= qq * CB  # dep within the same chunk -> folded into Tinv

    # --- degree-sorted position permutation: within each chunk, order pivot
    # positions by non-increasing cross-chunk degree.  Any intra-chunk order
    # is valid (in-chunk deps are folded into the chunk inverse, which is
    # conjugated below); sorting makes each chunk's dep application a short
    # staircase of prefix ranges with tight widths — measured 26-32% slot
    # fill in the previous pass/overflow scheme at K'=50511.
    ext = ~inck
    deg = np.bincount(dep_k[ext], minlength=Lpad).astype(np.int64)
    order_in_chunk = np.argsort(-deg.reshape(nchunks, CB), axis=1, kind="stable")  # [q, rank] -> old local
    rank = np.empty((nchunks, CB), np.int64)
    np.put_along_axis(rank, order_in_chunk, np.broadcast_to(np.arange(CB), (nchunks, CB)), axis=1)
    posmap = (np.arange(Lpad) // CB) * CB + rank.reshape(-1)  # old pos -> new pos

    # chunk inverses conjugated into the sorted basis:
    # z' = P z, acc' = P acc  =>  Tinv' = P Tinv P^T
    tinv_bits = np.zeros((nchunks, CB, CB), np.uint8)
    tinv_bits[:, np.arange(CB), np.arange(CB)] = 1
    tinv_bits[qq[inck], dep_k[inck] % CB, dep_pos[inck] - qq[inck] * CB] = 1
    _invert_conj_tri_chunks(tinv_bits, order_in_chunk)

    # cross-chunk dep edges in the sorted basis, ordered by receiving row
    erow_g = posmap[dep_k[ext]]
    edep_g = posmap[dep_pos[ext]]
    order_e = np.argsort(erow_g, kind="stable")
    key, edep_s = erow_g[order_e], edep_g[order_e]
    counts = np.bincount(key, minlength=Lpad)
    starts = np.zeros(Lpad + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    colpos = np.arange(key.size, dtype=np.int64) - starts[key]
    echunk_s = key // CB
    elocal_s = key % CB
    degs = counts.reshape(nchunks, CB)
    nnz_row = np.count_nonzero(degs, axis=1)
    return posmap, tinv_bits, echunk_s, elocal_s, edep_s, colpos, degs, nnz_row


def _plan_bounds_from_degs(Lpad: int, CB: int, degs: np.ndarray):
    """The planner's DP over a degree profile alone: [(q0, q1, bounds)].

    The cost model needs only the per-position (sorted, non-increasing)
    cross-chunk degree matrix [nchunks, CB] — not the edges — so the same
    DP plans a single pattern (``_tri_plan_py``) or an accumulated MAX
    profile over several patterns (the frozen canonical decode layout).
    """
    nchunks = Lpad // CB

    # Cost-optimal plan (outer DP over chunk segments, inner DP over prefix
    # boundaries): modeled cost = gathered slots (range length x quantized
    # width) + a fixed per-gather-launch penalty + a per-segment penalty.
    # Boundaries/widths come from fixed grids so decode schedules of one K'
    # keep hitting the same compiled program across loss patterns.
    _CAND = [c for c in CAND_GRID if c < CB] + [CB]
    _WQ = WIDTH_GRID
    RANGE_PENALTY = TRI_RANGE_PENALTY  # slots-equivalent cost of one more gather launch per chunk
    SEG_PENALTY = TRI_SEG_PENALTY_CHUNKS * CB  # modeled fixed cost of one more segment
    MAX_RANGES = TRI_MAX_RANGES

    # Batched per-(a, b) inner cost: for all window starts a of one endpoint
    # b in a few NumPy ops (a scalar Python DP here was the compile-time hot
    # spot at K' = 50511).  inner_ranges backtracks the chosen segments'
    # bounds with the same vectorized transition matrix.
    nc = len(_CAND)
    CANDa = np.asarray(_CAND, np.float64)
    WQA = np.asarray(_WQ, np.int64)
    degs_cand = np.zeros((nchunks, nc), np.int64)
    in_cb = [ci for ci, c in enumerate(_CAND) if c < CB]
    degs_cand[:, in_cb] = degs[:, [_CAND[ci] for ci in in_cb]]
    nnz_row = np.count_nonzero(degs, axis=1)  # rows are non-increasing
    tri_mask = np.triu(np.ones((nc, nc), bool), 1)  # ii < j
    # effective gathered rows of a range: the gather kernel pads its row
    # count to the R it runs at (8 / 16 / 32) — model that, or the DP picks
    # tiny ranges whose padding wastes more DMAs than they save
    rlen = CANDa[None, :] - CANDa[:, None]  # [ii, j]
    pad_len = np.where(rlen <= 8, 8.0, np.where(rlen <= 16, 16.0, np.ceil(rlen / 32.0) * 32.0)).astype(np.float32)

    def window_costs(b: int, avals: np.ndarray) -> np.ndarray:
        """inner_ranges(a, b)[0] for each window start a in `avals` (desc)."""
        a0 = int(avals.min())
        run_rev = np.maximum.accumulate(degs_cand[a0:b][::-1], axis=0)  # [k] = max of last k+1 rows
        nnz_rev = np.maximum.accumulate(nnz_row[a0:b][::-1])
        k = b - 1 - avals
        run = run_rev[k]  # [na, nc]
        lastnz = nnz_rev[k]  # [na]
        wq = np.where(run > 0, WQA[np.minimum(np.searchsorted(WQA, run), len(WQA) - 1)], 0)
        # transition matrix M[a, ii, j] = pen[ii] + wq[ii] * padded_len(ii, j)
        M = (wq.astype(np.float32)[:, :, None] * pad_len[None]
             + np.where(wq > 0, np.float32(RANGE_PENALTY), np.float32(0))[:, :, None])
        M[:, ~tri_mask] = np.inf
        na = avals.size
        dpv = np.full((na, nc), np.inf, np.float32)
        dpv[:, 0] = 0.0
        best = np.full(na, np.inf, np.float32)
        term_ok = CANDa[None, :] >= lastnz[:, None]
        for _ in range(MAX_RANGES):
            dpv = (dpv[:, :, None] + M).min(axis=1)
            best = np.minimum(best, np.where(term_ok, dpv, np.inf).min(axis=1))
        return (b - avals) * best.astype(np.float64)  # scalar model scales by nq

    def inner_ranges(a: int, b: int) -> tuple[float, list]:
        """Min-cost prefix ranges covering chunks [a, b), with backtracking
        (same DP as window_costs, single window + argmin backpointers)."""
        run = degs_cand[a:b].max(0)  # [nc]
        lastnz = int(nnz_row[a:b].max())
        # out-of-grid degrees would silently clamp and mis-shape ix below
        assert int(run.max(initial=0)) <= int(WQA[-1]), "row degree exceeds WIDTH_GRID"
        wq = np.where(run > 0, WQA[np.minimum(np.searchsorted(WQA, run), len(WQA) - 1)], 0)
        pen = np.where(wq > 0, float(RANGE_PENALTY), 0.0)
        dpv = np.full(nc, np.inf)
        dpv[0] = 0.0
        term_ok = CANDa >= lastnz
        best, best_gj = np.inf, None
        bks = []
        for g in range(MAX_RANGES):
            trans = (dpv + pen)[:, None] + wq[:, None] * pad_len
            trans = np.where(tri_mask, trans, np.inf)
            bk = np.argmin(trans, axis=0)
            dpv = trans[bk, np.arange(nc)]
            bks.append(bk)
            cand = np.where(term_ok, dpv, np.inf)
            j = int(np.argmin(cand))
            if cand[j] < best:
                best, best_gj = float(cand[j]), (g, j)
        if best_gj is None:  # no deps at all
            return 0.0, []
        bounds = []
        g, j = best_gj
        while g >= 0 and j > 0:
            ii = int(bks[g][j])
            if wq[ii]:
                bounds.append((int(_CAND[ii]), int(_CAND[j]), int(wq[ii])))
            j = ii
            g -= 1
        bounds.reverse()
        return (b - a) * best, bounds

    INF = float("inf")
    dp = [INF] * (nchunks + 1)
    back = [-1] * (nchunks + 1)
    dp[0] = 0.0
    seg_lens = np.asarray(SEG_LENS)
    for b in range(1, nchunks + 1):
        offs = seg_lens[seg_lens <= b]
        avals = b - offs
        costs = window_costs(b, avals)
        for a, c in zip(avals, costs):
            v = dp[a] + c + SEG_PENALTY
            if v < dp[b]:
                dp[b] = v
                back[b] = int(a)
    merged = []
    b = nchunks
    while b > 0:
        a = back[b]
        merged.append((a, b, inner_ranges(a, b)[1]))
        b = a
    merged.reverse()
    return merged


def _fill_segments(merged, Lpad, CB, echunk_s, elocal_s, edep_s, colpos, tinv_bits):
    """Build TriSegments by scattering the sorted edges into the planned
    (q0, q1, bounds) layout (every edge is covered by construction)."""
    tri = []
    for q0, q1, bounds in merged:
        nq = q1 - q0
        if nq <= 0:
            continue
        in_seg = (echunk_s >= q0) & (echunk_s < q1)
        ec = echunk_s[in_seg] - q0
        el = elocal_s[in_seg]
        ed = edep_s[in_seg]
        cp = colpos[in_seg]
        ranges = []
        for a, b2, w in bounds:
            m = (el >= a) & (el < b2)
            ix = np.full((nq, b2 - a, w), Lpad, np.int32)
            ix[ec[m], el[m] - a, cp[m]] = ed[m]
            ranges.append((a, b2, _idx(ix, Lpad)))
        packed = np.packbits(tinv_bits[q0:q1], axis=-1, bitorder="little")
        tri.append(TriSegment(q0=q0, tinv=packed, ranges=ranges))
    return tri


def _tri_plan_py(Lpad: int, CB: int, dep_k: np.ndarray, dep_pos: np.ndarray):
    """NumPy fallback planner (same cost model as nrq_tri_plan; plans may
    differ in tie-breaks — any plan over the same dep edges is correct)."""
    (posmap, tinv_bits, echunk_s, elocal_s, edep_s, colpos, degs, _nnz) = (
        _tri_sorted_edges(Lpad, CB, dep_k, dep_pos)
    )
    merged = _plan_bounds_from_degs(Lpad, CB, degs)
    tri = _fill_segments(merged, Lpad, CB, echunk_s, elocal_s, edep_s, colpos, tinv_bits)
    return posmap, tri


# ---------------------------------------------------------------------------
# Canonical (frozen) decode layouts: one compiled XLA program per K'.
#
# The DP planner optimizes each pattern's layout individually, but its
# segment boundaries / range widths are data-dependent, so every loss
# pattern used to compile a FRESH replay program (tens of seconds on TPU).
# Instead, per (K', CB, u_pad, M_pad, hdpc) key, the first _FREEZE_AFTER
# structured decode patterns plan as before while their degree profiles
# accumulate (elementwise max); the layout is then frozen by running the
# planner DP on the ACCUMULATED profile, and every later pattern is
# *filled into* the frozen shapes — one jitted program from then on.  A
# pattern that does not fit (a staircase poking above the union envelope —
# rare after three-pattern accumulation and pow2 width quantization) grows
# the layout monotonically and re-freezes: one recompile per growth event,
# converging quickly.  Replay cost vs the per-pattern optimum is the slot
# padding of a near-identical staircase: a few percent.
# ---------------------------------------------------------------------------

from collections import OrderedDict as _OrderedDict
from threading import Lock as _Lock

_FREEZE_AFTER = int(os.environ.get("NANORQ_LAYOUT_FREEZE_AFTER", 3))
_BSEL_BANDS = tuple(w for w in _WIDTHS if w > 8)
# light/heavy degree gap: LT-derived triangle rows stay <= ~30 deps; the
# late-peel accumulation rows jump to ~180.  48 sits in the gap at every
# observed K', so the classification itself is pattern-stable.
_HEAVY_THRESH = int(os.environ.get("NANORQ_HEAVY_THRESH", 48))


def _heavy_zone_order(n: int, dep_k: np.ndarray, dep_pos: np.ndarray):
    """(heavy bool [n], zone_rank int32 [n]): positions with dep degree >
    _HEAVY_THRESH, forward-closed (a position depending on a heavy position
    is heavy too, so the heavy set can move behind every light position with
    all deps still backward), plus each closed position's rank in the
    (dependency level, degree descending) topological zone order — which
    starts the zone with the degree-sorted true-heavy block so the zone's
    positional degree profile concentrates across loss patterns."""
    if n == 0 or dep_k.size == 0:
        return np.zeros(n, bool), np.full(n, -1, np.int32)
    try:
        from nanorq_tpu_torch.native import heavy_zone_order_native

        out = heavy_zone_order_native(n, dep_k, dep_pos, _HEAVY_THRESH)
        if out is not None:
            return out
    except (ImportError, OSError):
        pass
    deg = np.bincount(dep_k, minlength=n)
    heavy = deg > _HEAVY_THRESH
    while True:  # levelized propagation (CPU-fallback sizes only)
        new = heavy[dep_pos] & ~heavy[dep_k]
        if not new.any():
            break
        heavy[dep_k[new]] = True
    # greedy max-degree-first topological order of the closed subgraph
    # (mirrors nrq_heavy_zone_order; fallback sizes are small)
    import heapq

    hh = np.nonzero(heavy[dep_k] & heavy[dep_pos])[0]
    adj: dict[int, list[int]] = {}
    indeg = np.zeros(n, np.int64)
    for e in hh:
        adj.setdefault(int(dep_pos[e]), []).append(int(dep_k[e]))
        indeg[dep_k[e]] += 1
    rank = np.full(n, -1, np.int32)
    heap = [(-int(deg[k]), int(k)) for k in np.nonzero(heavy)[0] if indeg[k] == 0]
    heapq.heapify(heap)
    r = 0
    while heap:
        _, k = heapq.heappop(heap)
        rank[k] = r
        r += 1
        for d in adj.get(k, ()):
            indeg[d] -= 1
            if indeg[d] == 0:
                heapq.heappush(heap, (-int(deg[d]), d))
    return heavy, rank


class _FrozenLayout:
    __slots__ = ("tri", "bsel_classes")

    def __init__(self, tri, bsel_classes):
        self.tri = tri  # [(q0, q1, [(a, b, w), ...]), ...] contiguous ranges from 0
        self.bsel_classes = bsel_classes  # [(w, nb), ...] ascending w


class _LayoutState:
    """Per-key accumulator: warm-up profile maxima, then the frozen layout."""

    __slots__ = ("seen", "degs_max", "band_max", "bmax", "layout", "hpad")

    def __init__(self, nchunks, CB, hpad=0):
        self.seen = 0
        self.degs_max = np.zeros((nchunks, CB), np.int64)
        self.band_max = np.zeros(len(_BSEL_BANDS), np.int64)
        self.bmax = 0  # largest bsel row degree seen (may exceed the grid)
        self.layout: _FrozenLayout | None = None
        self.hpad = hpad  # heavy-zone positions at the end of the triangle

    def accumulate(self, degs, b_counts):
        np.maximum(self.degs_max, degs, out=self.degs_max)
        over = b_counts[b_counts > 8]
        if over.size:
            self.bmax = max(self.bmax, int(over.max()))
            hist = np.bincount(
                np.minimum(np.searchsorted(np.asarray(_BSEL_BANDS), over),
                           len(_BSEL_BANDS) - 1),
                minlength=len(_BSEL_BANDS),
            )
            np.maximum(self.band_max, hist, out=self.band_max)
        self.seen += 1

    def freeze(self, Lpad, CB):
        """(Re)build the frozen layout from the accumulated max profile.

        The profile is INFLATED before the DP: +25% (min +4) on every
        nonzero degree, so widths land one quantization step above the
        union envelope.  Measured at K'=50511, a tight-to-the-union layout
        mis-fit ~20-25% of later 6%-loss patterns (degree creep of a few
        units right at a pow2 width boundary — worst in the heavy zone,
        where topological rank jitter moves ~180-degree rows across
        positions), and every misfit costs a re-freeze + XLA recompile.
        The inflated widths cost a few percent of gathered slots; the
        re-freeze rate drops to ~zero."""
        d = self.degs_max
        infl = d + np.where(d > 0, np.maximum(4, d >> 2), 0)
        if self.hpad:
            # heavy zone: topological-rank jitter moves ~180-degree rows
            # across chunks between patterns, so per-chunk profiles are
            # meaningless there — freeze the zone to its column-wise max
            # envelope (rows are sorted non-increasing, so the column max
            # is a valid sorted profile).  The zone is a few chunks; the
            # extra slots are cheap against a re-freeze + recompile.
            hq = (Lpad - self.hpad) // CB
            infl[hq:] = infl[hq:].max(axis=0, keepdims=True)
        merged = _plan_bounds_from_degs(Lpad, CB, infl)
        # slack, in rising cost order: +4 positional dilation at internal
        # boundaries (knee drift), +16 coverage, and a width-2 SPILL range
        # overlapping the whole covered prefix (degree creep of +1/+2 right
        # at a pow2 width boundary).  Ranges apply additively on device
        # (acc[a:b] ^= gather), so overlap is free; the fill splits a row's
        # deps across its covering ranges by cumulative width.
        slacked = []
        for q0, q1, bounds in merged:
            nb, prev = [], 0
            for i2, (a, b, w) in enumerate(bounds):
                last = i2 == len(bounds) - 1
                b2 = min(CB, max(b + (16 if last else 4), prev))
                if b2 > prev:
                    nb.append((prev, b2, w))
                    prev = b2
            if nb:
                # spill across the WHOLE chunk at width 2: coverage is then
                # always CB, so a pattern whose sorted nonzero tail reaches
                # past the union envelope's prefix (observed jumps of +70
                # positions at K'=50511, always degree 1-2 out there) still
                # fits; only a >2-degree creep at an uncovered position —
                # unobserved over hundreds of patterns — re-freezes
                nb.append((0, CB, 2))
            slacked.append((q0, q1, nb))
        classes = [
            (int(w), _pad_rows(int(n) + max(2, int(n) >> 2)))
            for w, n in zip(_BSEL_BANDS, self.band_max)
            if n > 0
        ]
        if self.bmax > _BSEL_BANDS[-1] and classes:
            # a row degree beyond the band grid: widen the last class so the
            # histogram's clamped top band can actually hold its rows
            w, n = classes[-1]
            classes[-1] = (_quant(self.bmax), n)
        self.layout = _FrozenLayout(slacked, classes)


_layout_lock = _Lock()
_layout_cache: "_OrderedDict[tuple, _LayoutState]" = _OrderedDict()
_LAYOUT_CAPACITY = 16  # LRU bound: each state holds ~MB-scale profile arrays


def clear_layout_cache() -> None:
    with _layout_lock:
        _layout_cache.clear()


def save_layout_cache(path: str) -> None:
    """Persist the per-K' frozen decode layouts (plain data: bounds, class
    lists, accumulated profiles).  A restarted decoder that loads them skips
    the warm-up/freeze walk AND compiles the same XLA programs — so with a
    persistent compilation cache a cold process replays decode patterns with
    zero compiles (SURVEY.md §5 checkpoint/resume, the decoder-side analog
    of warm_encoder_cache)."""
    import pickle

    with _layout_lock:
        blob = {
            key: {
                "seen": stt.seen,
                "degs_max": stt.degs_max,
                "band_max": stt.band_max,
                "bmax": stt.bmax,
                "hpad": stt.hpad,
                "layout": None if stt.layout is None
                else (stt.layout.tri, stt.layout.bsel_classes),
            }
            for key, stt in _layout_cache.items()
        }
    with open(path, "wb") as f:
        pickle.dump(blob, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_layout_cache(path: str) -> int:
    """Load layouts saved by save_layout_cache; returns the entry count."""
    import pickle

    with open(path, "rb") as f:
        blob = pickle.load(f)
    with _layout_lock:
        for key, d in blob.items():
            CB = key[1]
            stt = _LayoutState(d["degs_max"].shape[0], CB, d["hpad"])
            stt.seen = d["seen"]
            stt.degs_max = d["degs_max"]
            stt.band_max = d["band_max"]
            stt.bmax = d["bmax"]
            if d["layout"] is not None:
                stt.layout = _FrozenLayout(*d["layout"])
            _layout_cache[key] = stt
            _layout_cache.move_to_end(key)
        while len(_layout_cache) > _LAYOUT_CAPACITY:
            _layout_cache.popitem(last=False)
    return len(blob)


def _tri_fill_frozen(layout, Lpad, CB, echunk_s, elocal_s, edep_s, colpos,
                     degs, nnz_row, tinv_bits):
    """Fill a pattern's sorted triangle edges into a frozen layout.

    Ranges may OVERLAP (the spill range): a row's deps are split across its
    covering ranges by cumulative width — the device applies every range
    additively, so where a dep lands is irrelevant.  Returns [TriSegment]
    or None when the pattern does not fit (a sorted row degree above the
    TOTAL width covering its position, or a nonzero row beyond the covered
    prefix).
    """
    segs = []
    for q0, q1, bounds in layout.tri:
        nq = q1 - q0
        cover = max((b for _, b, _ in bounds), default=0)
        d = degs[q0:q1]
        if int(nnz_row[q0:q1].max(initial=0)) > cover:
            return None
        tw = np.zeros(CB, np.int64)  # total width covering each position
        offs = []
        for a, b, w in bounds:
            offs.append(tw.copy())  # cumulative width of earlier ranges
            tw[a:b] += w
        if (d > tw[None, :]).any():
            return None
        # edges arrive sorted by receiving row, hence by chunk: the
        # segment's edges are one contiguous slice (no 28x full-edge masks)
        in_seg = slice(*np.searchsorted(echunk_s, (q0, q1)))
        ec = echunk_s[in_seg] - q0
        el = elocal_s[in_seg]
        ed = edep_s[in_seg]
        cp = colpos[in_seg]
        ranges = []
        dt = np.uint16 if Lpad < 65536 else np.int32  # final upload dtype:
        for (a, b, w), off in zip(bounds, offs):      # no _idx re-copy pass
            o = off[el]
            m = (el >= a) & (el < b) & (cp >= o) & (cp < o + w)
            ix = np.full((nq, b - a, w), Lpad, dt)
            ix[ec[m], el[m] - a, cp[m] - o[m]] = ed[m]
            ranges.append((a, b, ix))
        packed = np.packbits(tinv_bits[q0:q1], axis=-1, bitorder="little")
        segs.append(TriSegment(q0=q0, tinv=packed, ranges=ranges))
    return segs


def _select_rows_np(red: np.ndarray, sel: np.ndarray) -> np.ndarray:
    red_ext = np.vstack([red, np.zeros((1, red.shape[1]), np.uint8)])
    return red_ext[sel]


def _apply_plan_np(src_ext: np.ndarray, plan: GatherPlan, base: np.ndarray) -> np.ndarray:
    """base [n_rows, t] ^= plan applied to src_ext (sentinel row is zero)."""
    out = base
    for p in plan.passes:
        out = out ^ np.bitwise_xor.reduce(src_ext[p], axis=1)
    for idx, sel in plan.overflow:
        red = np.bitwise_xor.reduce(src_ext[idx], axis=1)  # [nb, t]
        out = out ^ _select_rows_np(red, sel)
    return out


def _trisolve_np(ds: DeviceSchedule, y: np.ndarray) -> np.ndarray:
    """y [Lpad, t] -> z = T^-1 y, z buffer [Lpad+1, t] (last row zero)."""
    t = y.shape[1]
    z = np.zeros((ds.Lpad + 1, t), np.uint8)
    for seg in ds.tri:
        for qi in range(seg.tinv.shape[0]):
            base = (seg.q0 + qi) * ds.CB
            acc = y[base : base + ds.CB].copy()
            for a, b, ix in seg.ranges:
                acc[a:b] ^= np.bitwise_xor.reduce(z[ix[qi]], axis=1)
            tinv_q = np.unpackbits(seg.tinv[qi], axis=-1, bitorder="little")
            z[base : base + ds.CB] = gf2_matmul_bytes(tinv_q, acc)
    return z


def replay_structured_numpy(D: np.ndarray, ds: DeviceSchedule) -> np.ndarray:
    """Apply the structured program to D [>=M_pad rows, t]; returns C [L, t].

    D must have its rows beyond ds.M zeroed (in particular row M_pad-1).
    """
    assert D.shape[0] >= ds.M_pad
    t = D.shape[1]
    y = D[ds.piv_rows]  # [Lpad, t]

    z = _trisolve_np(ds, y)  # stage 1

    zsel = _apply_plan_np(z, ds.bsel, D[ds.sel_rows])  # stage 2 sparse
    if ds.mhd is not None:  # stage 2 dense (HDPC)
        hvals = gf256_matmul_bytes(ds.mhd, z[: ds.Lpad])
        zsel = zsel ^ _select_rows_np(hvals, ds.hd_sel)

    xu = gf256_matmul_bytes(ds.vinv, zsel)  # stage 3

    # stage 4: x_a = t1 ^ Wut x_u (host-precomputed Wut = T^-1 U_t)
    wut_bits = np.unpackbits(ds.wut, axis=-1, bitorder="little")
    xa = z[: ds.Lpad] ^ gf2_matmul_bytes(wut_bits, xu)

    allrows = np.vstack([xa, xu])
    return allrows[ds.out_sel]  # stage 5
