"""Host-side (NumPy) GF(256) linear algebra.

This is the oblas-equivalent used by the host schedule solver and by tests as
an independent reference for the TPU kernels.  Parity: oblas oaxpy/oscal call
sites at reference lib/precode.c:7-20 and lib/wrkmat.c:79-112.
"""

import numpy as np

from nanorq_tpu_torch.gf256.tables import GF_MUL, OCT_INV


def gf_mul(a, b):
    """Elementwise GF(256) product (broadcasts)."""
    return GF_MUL[np.asarray(a, np.uint8), np.asarray(b, np.uint8)]


def gf_inv(a):
    return OCT_INV[np.asarray(a, np.uint8)]


def gf_axpy(D: np.ndarray, i: int, j: int, beta: int) -> None:
    """row_i ^= beta (x) row_j, in place (oblas oaxpy)."""
    if beta == 1:
        np.bitwise_xor(D[i], D[j], out=D[i])
    else:
        np.bitwise_xor(D[i], GF_MUL[beta, D[j]], out=D[i])


def gf_scal(D: np.ndarray, i: int, beta: int) -> None:
    """row_i = beta (x) row_i, in place (oblas oscal)."""
    D[i] = GF_MUL[beta, D[i]]


def gf_matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Dense GF(256) matrix product (small sizes; test/cross-check use only)."""
    out = np.zeros((A.shape[0], B.shape[1]), dtype=np.uint8)
    for k in range(A.shape[1]):
        col = A[:, k]
        nz = np.nonzero(col)[0]
        if nz.size:
            out[nz] ^= GF_MUL[col[nz][:, None], B[k][None, :]]
    return out


def gf_matvec(A: np.ndarray, x: np.ndarray) -> np.ndarray:
    return gf_matmul(A, x[:, None])[:, 0]


def gf_inv_matrix(A: np.ndarray) -> np.ndarray | None:
    """Inverse of a square GF(256) matrix, or None if singular."""
    n = A.shape[0]
    return gf_solve_dense(A, np.eye(n, dtype=np.uint8))


def gf_solve_dense(A: np.ndarray, D: np.ndarray) -> np.ndarray | None:
    """Solve A X = D over GF(256) by plain Gaussian elimination.

    A is [m, n] with m >= n, D is [m, t].  Returns X [n, t] or None if A is
    rank-deficient.  Slow; used only as the independent correctness oracle
    for the schedule solver on small K.
    """
    A = A.astype(np.uint8).copy()
    D = D.astype(np.uint8).copy()
    m, n = A.shape
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, m):
            if A[r, col]:
                piv = r
                break
        if piv is None:
            return None
        if piv != row:
            A[[row, piv]] = A[[piv, row]]
            D[[row, piv]] = D[[piv, row]]
        b = A[row, col]
        if b != 1:
            binv = OCT_INV[b]
            A[row] = GF_MUL[binv, A[row]]
            D[row] = GF_MUL[binv, D[row]]
        mask = A[:, col].copy()
        mask[row] = 0
        nz = np.nonzero(mask)[0]
        if nz.size:
            A[nz] ^= GF_MUL[mask[nz][:, None], A[row][None, :]]
            D[nz] ^= GF_MUL[mask[nz][:, None], D[row][None, :]]
        row += 1
    return D[:n]
