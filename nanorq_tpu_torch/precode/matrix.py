"""RFC 6330 s5.3.3.3 precode constraint-matrix assembly.

The L x L (plus overhead) matrix A has, in row order:
- S LDPC rows: circulant LDPC1 band over cols [0, B), an S x S identity at
  cols [B, W), and two LDPC2 ones per row in the PI cols [W, L)
- H HDPC rows: dense GF(256) alpha-recurrence rows over cols [0, Kp+S) plus
  an H x H identity at cols [Kp+S, L)
- Kp (+ overhead) LT rows: tuple-expanded neighbor sets

Binary rows are produced as per-row column-index arrays (the host solver's
sparse form); HDPC is a dense uint8 block.  Parity: reference
lib/precode.c:34-97 (LDPC1/identity/LDPC2/G_ENC/make_HDPC).

The HDPC construction is vectorized: the reference's per-column recurrence
HDPC[:, c] = alpha * HDPC[:, c+1] (+) onehots(b1(c), b2(c)) has closed form
  HDPC[r, c] = alpha^{r + n-1-c}  (+)  alpha^{-c} (x) suffixXOR_{c'>=c}( alpha^{c'} (x) hit[r, c'] )
which is two table gathers and one XOR-scan.
"""

import numpy as np

from nanorq_tpu_torch.gf256.tables import GF_MUL, OCT_EXP
from nanorq_tpu_torch.rfc.params import Params
from nanorq_tpu_torch.rfc.rand import rnd_get
from nanorq_tpu_torch.rfc.tuples import lt_indices


class CSRRows:
    """A list of per-row column-index sets backed by one flat CSR buffer.

    Replaces list-of-arrays row sets on the solve hot path: building,
    concatenating, and iterating ~K' small NumPy arrays dominated decode
    host-prep time at large K'.  Supports the list protocol (len, index,
    slice, iterate) so oracle/test code is unaffected.
    """

    __slots__ = ("cols", "ptr")

    def __init__(self, cols: np.ndarray, ptr: np.ndarray):
        self.cols = cols  # int32 [nnz], row-major
        self.ptr = ptr  # int64 [n+1]

    @classmethod
    def from_list(cls, rows: list) -> "CSRRows":
        n = len(rows)
        lens = np.fromiter((len(r) for r in rows), np.int64, n)
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=ptr[1:])
        cols = np.concatenate(rows).astype(np.int32) if n and ptr[-1] else np.zeros(0, np.int32)
        return cls(cols, ptr)

    def __len__(self) -> int:
        return self.ptr.size - 1

    def __getitem__(self, r):
        if isinstance(r, slice):
            return [self[i] for i in range(*r.indices(len(self)))]
        return self.cols[self.ptr[r] : self.ptr[r + 1]]

    def __iter__(self):
        return (self[r] for r in range(len(self)))

    def lens(self) -> np.ndarray:
        return np.diff(self.ptr)

    def select_flat(self, rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Flattened column sets of `rows`: (kk, cols) where kk[e] is the
        index into `rows` and cols[e] the column, ordered row-major."""
        rows = np.asarray(rows, np.int64)
        ln = self.ptr[rows + 1] - self.ptr[rows]
        total = int(ln.sum())
        kk = np.repeat(np.arange(rows.size, dtype=np.int64), ln)
        csum = np.zeros(rows.size + 1, np.int64)
        np.cumsum(ln, out=csum[1:])
        within = np.arange(total, dtype=np.int64) - np.repeat(csum[:-1], ln)
        return kk, self.cols[np.repeat(self.ptr[rows], ln) + within].astype(np.int64)


def make_hdpc(P: Params) -> np.ndarray:
    """Dense HDPC block [H, Kp+S] (reference lib/precode.c:60-83)."""
    H, n = P.H, P.Kp + P.S
    r = np.arange(H, dtype=np.int64)
    c = np.arange(n, dtype=np.int64)
    M = OCT_EXP[(r[:, None] + (n - 1 - c)[None, :]) % 255].copy()
    if n >= 2:
        cc = np.arange(n - 1, dtype=np.int64)
        y = (cc + 1).astype(np.uint32)
        b1 = rnd_get(y, 6, H).astype(np.int64)
        b2 = (b1 + rnd_get(y, 7, H - 1).astype(np.int64) + 1) % H
        alpha_c = OCT_EXP[cc % 255]
        hitw = np.zeros((H, n - 1), np.uint8)
        hitw[b1, cc] ^= alpha_c  # b1 != b2 by construction, no collisions
        hitw[b2, cc] ^= alpha_c
        s = np.bitwise_xor.accumulate(hitw[:, ::-1], axis=1)[:, ::-1]
        inv_ac = OCT_EXP[(255 - (cc % 255)) % 255]
        M[:, : n - 1] ^= GF_MUL[s, inv_ac[None, :]]
    return M


_hdpc_cache: dict[int, np.ndarray] = {}


def hdpc_full_rows(P: Params) -> np.ndarray:
    """HDPC rows of A over all L columns: [make_hdpc | I_H], uint8 [H, L].

    Cached per K' (loss-pattern independent, ~17 ms at K'=50511 — it sat on
    the per-pattern decode host-prep path).  Treat the result as read-only.
    """
    A = _hdpc_cache.get(P.Kp)
    if A is None:
        A = np.zeros((P.H, P.L), np.uint8)
        A[:, : P.Kp + P.S] = make_hdpc(P)
        A[np.arange(P.H), P.Kp + P.S + np.arange(P.H)] = 1
        A.setflags(write=False)
        _hdpc_cache[P.Kp] = A
    return A


def ldpc_row_cols(P: Params) -> list[np.ndarray]:
    """Column index sets of the S LDPC rows (rows 0..S-1 of A)."""
    S, B, W, Pp = P.S, P.B, P.W, P.P
    cols = np.arange(B, dtype=np.int64)
    sub = cols // S
    r1 = cols % S
    r2 = (cols + sub + 1) % S
    r3 = (cols + 2 * (sub + 1)) % S
    rows = [[] for _ in range(S)]
    all_rows = np.concatenate([r1, r2, r3])
    all_cols = np.concatenate([cols, cols, cols])
    order = np.argsort(all_rows, kind="stable")
    all_rows, all_cols = all_rows[order], all_cols[order]
    bounds = np.searchsorted(all_rows, np.arange(S + 1))
    out = []
    for i in range(S):
        ldpc1 = all_cols[bounds[i] : bounds[i + 1]]
        extra = np.array([B + i, W + (i % Pp), W + ((i + 1) % Pp)], dtype=np.int64)
        out.append(np.concatenate([ldpc1, extra]).astype(np.int32))
    return out


def lt_row_cols(isis: np.ndarray, P: Params) -> list[np.ndarray]:
    """Column index sets of LT rows for the given ISIs (G_ENC, precode.c:85)."""
    idx, valid = lt_indices(np.asarray(isis, dtype=np.uint32), P)
    return [idx[i][valid[i]].astype(np.int32) for i in range(idx.shape[0])]


def lt_rows_csr(isis: np.ndarray, P: Params) -> CSRRows:
    """LT rows for the given ISIs as CSR (vectorized lt_row_cols)."""
    idx, valid = lt_indices(np.asarray(isis, dtype=np.uint32), P)
    lens = valid.sum(1)
    ptr = np.zeros(idx.shape[0] + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    return CSRRows(idx[valid].astype(np.int32), ptr)  # nonzero order is row-major


def ldpc_rows_csr(P: Params) -> CSRRows:
    """The S LDPC rows as CSR (vectorized ldpc_row_cols)."""
    S, B, W, Pp = P.S, P.B, P.W, P.P
    cols = np.arange(B, dtype=np.int64)
    sub = cols // S
    i = np.arange(S, dtype=np.int64)
    all_rows = np.concatenate([cols % S, (cols + sub + 1) % S, (cols + 2 * (sub + 1)) % S,
                               i, i, i])
    all_cols = np.concatenate([cols, cols, cols,
                               B + i, W + (i % Pp), W + ((i + 1) % Pp)])
    order = np.argsort(all_rows, kind="stable")
    ptr = np.zeros(S + 1, np.int64)
    np.cumsum(np.bincount(all_rows, minlength=S), out=ptr[1:])
    return CSRRows(all_cols[order].astype(np.int32), ptr)


def binary_rows(P: Params, isis: np.ndarray | None = None, overhead: int = 0) -> CSRRows:
    """All binary (non-HDPC) rows of A in solver row order.

    Returns a CSRRows (list-compatible) of Kp + overhead + S column-index
    sets: LT rows for `isis` (default arange(Kp + overhead), the encoder
    case) followed by the S LDPC rows.  The HDPC rows live in a separate
    dense block; the solver composes [LT.. | LDPC.. | HDPC..] as its
    row-position space.
    """
    if isis is None:
        isis = np.arange(P.Kp + overhead, dtype=np.uint32)
    assert len(isis) == P.Kp + overhead
    lt = lt_rows_csr(isis, P)
    ldpc = ldpc_rows_csr(P)
    return CSRRows(
        np.concatenate([lt.cols, ldpc.cols]),
        np.concatenate([lt.ptr, lt.ptr[-1] + ldpc.ptr[1:]]),
    )


def dense_A(P: Params, isis: np.ndarray | None = None, overhead: int = 0) -> np.ndarray:
    """Materialize A densely in *reference row order* (LDPC, HDPC, LT rows).

    Test/oracle use only (small K): rows 0..S-1 LDPC, S..S+H-1 HDPC,
    S+H.. LT.  Matches lib/precode.c:90-97 + patched overhead rows.
    """
    rows = P.L + overhead
    A = np.zeros((rows, P.L), np.uint8)
    br = binary_rows(P, isis, overhead)
    lt, ldpc = br[: P.Kp + overhead], br[P.Kp + overhead :]
    for i, cols in enumerate(ldpc):
        A[i, cols] = 1
    A[P.S : P.S + P.H] = hdpc_full_rows(P)
    for i, cols in enumerate(lt):
        A[P.S + P.H + i, cols] = 1
    return A
