"""Host-side Gaussian elimination with inactivation over matrix indices.

This is the TPU-first re-design of the reference's precode_matrix_invert
(lib/precode.c:99-377).  It runs once per (K', received-ISI set), touches no
payload bytes, and produces:

- a linearized elementary-op program (Schedule) used as the correctness
  oracle and host fallback, and
- via precode.device_schedule, the *structured* artifacts for the TPU
  replayer (block-triangular solve + dense GF matmuls), which is how the
  payload work actually runs on device.

Structure of the solve:

  1. peel:      greedy selection of degree-1/2 rows over the active window,
                inactivating the second column of weight-2 rows
                (reference precond/choose/swap_cols/update_nnz)
  2. S1a:       forward substitution among the i triangle rows
  3. S1b:       elimination of triangle columns from the remaining binary rows
  4. dense:     GF(2) elimination of the u-wide inactive block over binary
                rows; on rank shortfall, HDPC rows are admitted and the
                elimination continues over GF(256)
  5. backsolve: record-only ops zeroing the inactive block above the diagonal
                (sparse original entries for triangle rows)

The linear program uses the reference's 4-segment replay order
S1a|S1b|dense, reversed(S1a), backsolve, S1a — the undo/redo trick keeps
triangle backsolve ops sparse (see lib/precode.c:23-32).

Row-id convention (shared with the codec's D layout, which *differs* from the
reference's): rows [0, Kp+overhead) are LT rows in ISI order (source symbol
esi sits at row esi), then S LDPC rows, then H HDPC rows at the bottom.

Unlike the reference we never permute rows/columns physically; positions live
in small index arrays and the output permutation is a single gather.  Any
full-rank system yields the *same* intermediate symbols C regardless of pivot
choices, so wire output stays bit-exact with RFC 6330 / the reference.
"""

from dataclasses import dataclass

import numpy as np

from nanorq_tpu_torch.gf256.tables import GF_MUL, OCT_INV
from nanorq_tpu_torch.precode.matrix import binary_rows, hdpc_full_rows
from nanorq_tpu_torch.precode.schedule import Schedule
from nanorq_tpu_torch.rfc.params import Params

_BIG = np.iinfo(np.int32).max


class _Ops:
    """Chunked op recorder; avoids per-op Python overhead."""

    def __init__(self) -> None:
        self.chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def emit(self, i, j, alpha=1, beta=1) -> None:
        i = np.atleast_1d(np.asarray(i, np.int32))
        n = i.shape[0]
        if n == 0:
            return
        j = np.broadcast_to(np.asarray(j, np.int32), (n,))
        a = np.broadcast_to(np.asarray(alpha, np.uint8), (n,))
        b = np.broadcast_to(np.asarray(beta, np.uint8), (n,))
        self.chunks.append((i, j.copy(), a.copy(), b.copy()))

    def cat(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if not self.chunks:
            z = np.zeros(0, np.int32)
            return z, z.copy(), np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        return (
            np.concatenate([c[0] for c in self.chunks]),
            np.concatenate([c[1] for c in self.chunks]),
            np.concatenate([c[2] for c in self.chunks]),
            np.concatenate([c[3] for c in self.chunks]),
        )


def _apply_grouped_xor(U: np.ndarray, tgts: np.ndarray, vals: np.ndarray) -> None:
    """U[tgts[k]] ^= vals[k] with duplicate targets allowed (XOR-accumulate)."""
    order = np.argsort(tgts, kind="stable")
    tgts, vals = tgts[order], vals[order]
    uniq, starts = np.unique(tgts, return_index=True)
    red = np.bitwise_xor.reduceat(vals, starts, axis=0)
    U[uniq] ^= red


@dataclass
class SolveState:
    """Everything downstream consumers (op stream / device compile) need."""

    P: Params
    overhead: int
    NB: int  # number of binary rows (LT + LDPC)
    M: int  # total rows = NB + H
    rows_cols: object  # CSRRows (or list of arrays): binary-row column sets
    piv_rows: np.ndarray  # int32 [i]  D-row of triangle pivot position k
    piv_cols: np.ndarray  # int32 [i]  pivot column of position k
    u_cols: np.ndarray  # int64 [u]  inactive columns in dense order
    order: np.ndarray  # int64 [M]  row at each position after dense pivoting
    pos_of_row: np.ndarray  # int64 [NB] triangle position or _BIG
    pivpos_of_col: np.ndarray  # int64 [L] pivot position of a column or -1
    ucol_of: np.ndarray  # int64 [L] dense column index of a column or -1
    hdpc_used: bool  # False when the pure-GF(2) path completed
    U_schur: np.ndarray | None  # [M, u] Schur-complement state pre dense-elim
    ops: tuple  # (s1a, s1b, rest, back) _Ops recorders

    @property
    def i(self) -> int:
        return int(self.piv_rows.shape[0])

    @property
    def u(self) -> int:
        return int(self.P.L - self.i)


def _solve_core(P: Params, rows_cols, overhead: int = 0) -> SolveState | None:
    from nanorq_tpu_torch.precode.matrix import CSRRows

    L, W, H, S = P.L, P.W, P.H, P.S
    NB = P.Kp + overhead + S
    M = NB + H
    assert len(rows_cols) == NB
    if not isinstance(rows_cols, CSRRows):
        rows_cols = CSRRows.from_list(rows_cols)

    # ---- adjacency (CSR over columns, binary rows only) ----
    lens = rows_cols.lens()
    flat_cols = rows_cols.cols.astype(np.int64)
    flat_rows = np.repeat(np.arange(NB, dtype=np.int32), lens)
    csr_order = np.argsort(flat_cols, kind="stable")
    adj_rows = flat_rows[csr_order]
    col_ptr = np.searchsorted(flat_cols[csr_order], np.arange(L + 1))

    def adj(c: int) -> np.ndarray:
        return adj_rows[col_ptr[c] : col_ptr[c + 1]]

    # ---- phase 1: peel (reference precond, lib/precode.c:176-203) ----
    nnzV = np.bincount(flat_rows[flat_cols < W], minlength=NB).astype(np.int64)
    col_active = np.zeros(L, bool)
    col_active[:W] = True
    row_used = np.zeros(NB, bool)
    pivot_rows: list[int] = []
    pivot_cols: list[int] = []
    inactivated: list[int] = []
    bucket1 = list(np.nonzero(nnzV == 1)[0])
    bucket2 = list(np.nonzero(nnzV == 2)[0])
    n_active = W

    def remove_col(c: int) -> None:
        nonlocal n_active
        col_active[c] = False
        n_active -= 1
        nbrs = adj(c)
        nnzV[nbrs] -= 1
        nn = nnzV[nbrs]
        for r in nbrs[nn == 1]:
            bucket1.append(int(r))
        for r in nbrs[nn == 2]:
            bucket2.append(int(r))

    while n_active > 0:
        r = -1
        for want, bucket in ((1, bucket1), (2, bucket2)):
            while bucket:
                cand = bucket.pop()
                if not row_used[cand] and nnzV[cand] == want:
                    r = int(cand)
                    break
            if r >= 0:
                break
        if r < 0:
            break
        rc = rows_cols[r]
        ac = rc[col_active[rc]]
        row_used[r] = True
        pivot_rows.append(r)
        pivot_cols.append(int(ac[0]))
        remove_col(int(ac[0]))
        if ac.shape[0] == 2:
            inactivated.append(int(ac[1]))
            remove_col(int(ac[1]))

    i = len(pivot_rows)
    u = L - i
    piv_rows = np.array(pivot_rows, np.int32)
    piv_cols = np.array(pivot_cols, np.int32)

    # inactive column order: leftover active, peel-inactivated, then PI cols
    u_cols = np.concatenate(
        [
            np.nonzero(col_active[:W])[0],
            np.array(inactivated, np.int64),
            np.arange(W, L, dtype=np.int64),
        ]
    ).astype(np.int64)
    assert u_cols.shape[0] == u
    ucol_of = np.full(L, -1, np.int64)
    ucol_of[u_cols] = np.arange(u)
    pos_of_row = np.full(NB, _BIG, np.int64)
    pos_of_row[piv_rows] = np.arange(i)
    pivpos_of_col = np.full(L, -1, np.int64)
    pivpos_of_col[piv_cols] = np.arange(i)

    # ---- U: dense inactive block [M, u] ----
    U = np.zeros((M, u), np.uint8)
    umask = ucol_of[flat_cols] >= 0
    U[flat_rows[umask], ucol_of[flat_cols[umask]]] = 1

    s1a, s1b, rest, back = _Ops(), _Ops(), _Ops(), _Ops()

    # ---- S1a: triangle forward substitution (fwd_GE(0, i)) ----
    for k in range(i):
        nbrs = adj(int(piv_cols[k]))
        tpos = pos_of_row[nbrs]
        tgts = nbrs[(tpos > k) & (tpos < i)]
        if tgts.size:
            U[tgts] ^= U[piv_rows[k]][None, :]
            s1a.emit(tgts, piv_rows[k])

    # ---- S1b: eliminate triangle cols from non-pivot binary rows ----
    pk = pivpos_of_col[flat_cols]
    sel = (pk >= 0) & (pos_of_row[flat_rows] == _BIG)
    pr, pkk = flat_rows[sel], pk[sel]
    korder = np.argsort(pkk, kind="stable")
    pr, pkk = pr[korder], pkk[korder]
    if pr.size:
        _apply_grouped_xor(U, pr, U[piv_rows[pkk]])
        s1b.emit(pr, piv_rows[pkk])

    # Schur-complement snapshot for the device compiler: binary rows after
    # S1b (pre dense elimination); HDPC rows patched in below if admitted.
    U_schur = U.copy()

    # ---- dense solve over the u block ----
    order = np.concatenate(
        [
            piv_rows.astype(np.int64),
            np.nonzero(~row_used)[0].astype(np.int64),
            NB + np.arange(H, dtype=np.int64),
        ]
    )
    assert order.shape[0] == M

    rank = i
    hdpc_used = False
    if M - H >= L:  # enough binary rows: try pure-GF(2) solve first
        for p in range(i, L):
            jc = p - i
            window = order[p : M - H]
            nz = np.nonzero(U[window, jc])[0]
            if nz.size == 0:
                break
            q = p + int(nz[0])
            order[p], order[q] = order[q], order[p]
            piv = order[p]
            rest_rows = order[p + 1 : M - H]
            tgts = rest_rows[U[rest_rows, jc] != 0]
            if tgts.size:
                U[tgts] ^= U[piv][None, :]
                rest.emit(tgts, piv)
            rank = p + 1

    if rank < L:
        # admit HDPC rows: fill their inactive block and eliminate their
        # dependence on triangle pivots (reference fill_HDPC)
        hdpc_used = True
        Ahd = hdpc_full_rows(P)
        hrows = NB + np.arange(H)
        U[hrows] = Ahd[:, u_cols]
        if i:
            betas_all = Ahd[:, piv_cols]  # [H, i]
            hh, kk = np.nonzero(betas_all)
            korder = np.argsort(kk, kind="stable")
            hh, kk = hh[korder], kk[korder]
            for lo in range(0, hh.size, 65536):
                sl = slice(lo, lo + 65536)
                vals = GF_MUL[betas_all[hh[sl], kk[sl]][:, None], U[piv_rows[kk[sl]]]]
                _apply_grouped_xor(U, hrows[hh[sl]], vals)
            rest.emit(hrows[hh], piv_rows[kk], beta=betas_all[hh, kk])
        U_schur[hrows] = U[hrows]

        # GF(256) elimination over all rows, restarting from position i
        for p in range(i, L):
            jc = p - i
            window = order[p:M]
            nz = np.nonzero(U[window, jc])[0]
            if nz.size == 0:
                return None  # rank deficient: decode failure, caller retries
            q = p + int(nz[0])
            order[p], order[q] = order[q], order[p]
            piv = order[p]
            b = int(U[piv, jc])
            if b > 1:
                inv = int(OCT_INV[b])
                U[piv] = GF_MUL[inv, U[piv]]
                rest.emit(piv, piv, alpha=inv, beta=0)
            rest_rows = order[p + 1 : M]
            betas = U[rest_rows, jc]
            nzr = np.nonzero(betas)[0]
            if nzr.size:
                tgts = rest_rows[nzr]
                U[tgts] ^= GF_MUL[betas[nzr][:, None], U[piv][None, :]]
                rest.emit(tgts, piv, beta=betas[nzr])

    # ---- backsolve (record-only; reference precode_matrix_backsolve) ----
    Uu = U[order[i:L]]  # [u, u], unit upper triangular
    for p in range(L - 1, i - 1, -1):
        jc = p - i
        src = order[p]
        c = int(u_cols[jc])
        nbrs = adj(c)
        tri = nbrs[pos_of_row[nbrs] < i]
        back.emit(tri, src)
        above = order[i:p]
        betas = Uu[: p - i, jc]
        nzr = np.nonzero(betas)[0]
        if nzr.size:
            back.emit(above[nzr], src, beta=betas[nzr])

    return SolveState(
        P=P,
        overhead=overhead,
        NB=NB,
        M=M,
        rows_cols=rows_cols,
        piv_rows=piv_rows,
        piv_cols=piv_cols,
        u_cols=u_cols,
        order=order,
        pos_of_row=pos_of_row,
        pivpos_of_col=pivpos_of_col,
        ucol_of=ucol_of,
        hdpc_used=hdpc_used,
        U_schur=U_schur,
        ops=(s1a, s1b, rest, back),
    )


def state_to_schedule(st: SolveState) -> Schedule:
    """Linearize the recorded ops: S1a|S1b|dense, reversed(S1a), back, S1a."""
    s1a, s1b, rest, back = st.ops
    a_i, a_j, a_a, a_b = s1a.cat()
    b_i, b_j, b_a, b_b = s1b.cat()
    r_i, r_j, r_a, r_b = rest.cat()
    k_i, k_j, k_a, k_b = back.cat()
    op_i = np.concatenate([a_i, b_i, r_i, a_i[::-1], k_i, a_i])
    op_j = np.concatenate([a_j, b_j, r_j, a_j[::-1], k_j, a_j])
    op_a = np.concatenate([a_a, b_a, r_a, a_a[::-1], k_a, a_a])
    op_b = np.concatenate([a_b, b_b, r_b, a_b[::-1], k_b, a_b])

    L = st.P.L
    i = st.i
    gather = np.zeros(L, np.int32)
    gather[st.piv_cols] = st.piv_rows
    gather[st.u_cols] = st.order[i:L]

    return Schedule(
        L=L,
        n_rows=st.M,
        i=i,
        u=st.u,
        op_i=op_i.astype(np.int32),
        op_j=op_j.astype(np.int32),
        op_alpha=op_a.astype(np.uint8),
        op_beta=op_b.astype(np.uint8),
        gather=gather,
        seg_lens=(len(a_i), len(b_i), len(r_i), len(k_i)),
    )


def solve_state(P: Params, rows_cols: list[np.ndarray], overhead: int = 0) -> SolveState | None:
    """Index-solve via the native C++ solver when available, else Python.

    The two produce equivalent (not identical) states — pivot choices may
    differ, but any full-rank elimination yields the same intermediate
    symbols, so replay output is bit-identical either way.
    """
    try:
        from nanorq_tpu_torch.native import native_available, solve_native
    except (ImportError, OSError):  # no compiler / broken toolchain
        return _solve_core(P, rows_cols, overhead)
    if native_available():
        return solve_native(P, rows_cols, overhead)
    return _solve_core(P, rows_cols, overhead)


def solve(P: Params, rows_cols: list[np.ndarray], overhead: int = 0) -> Schedule | None:
    """Invert the precode system, returning the linear-op Schedule or None.

    `rows_cols` are the binary rows (LT then LDPC) as produced by
    precode.matrix.binary_rows — Kp+overhead+S column-index arrays.
    """
    st = _solve_core(P, rows_cols, overhead)
    return None if st is None else state_to_schedule(st)


def solve_encoder(P: Params) -> Schedule | None:
    """Schedule for the loss-independent encoder system (isis = 0..K'-1)."""
    return solve(P, binary_rows(P))
