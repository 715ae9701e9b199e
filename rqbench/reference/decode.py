"""A plain RFC 6330 decoder: the yardstick that a receiver's recovered
source symbols are held to, where the block is small enough to solve.

Written from the RFC's text on numpy and plain torch, and independent of
the program: it imports nothing of it, and takes its tables, tuples and
constraint rows from the plain encoder (`rfc6330.py`).  Given a block's
parameters (`rfc6330.params(K)`) and the received (ESI, payload) pairs,
`decode`:

- builds the constraint system of s5.3.3.4 for the received ISIs: S LDPC
  rows and H HDPC rows (right side zero), the LT rows of the K' - K padding
  symbols (ISIs K .. K'-1, known to be zero, s5.3.1), then one LT row per
  received symbol (s5.3.5.3), an ESI of K or more taken to ISI ESI + K' - K
  (s5.3.1);
- solves that rectangular system for the L intermediate symbols by
  Gauss-Jordan elimination over GF(256), in integer tables (`rfc6330.MUL`,
  `rfc6330.INV`): no floating point anywhere;
- returns the K source symbols, the LT symbols of ISIs 0 .. K-1 of the
  intermediate symbols (s5.3.5.3), or None where the system's rank is
  below L.

Departures from s5.4, whose decoding process the RFC gives as an example:
- no inactivation and no choice of rows by degree: the columns are
  eliminated in order, each pivot the first row below that has a nonzero
  entry there, and every other row cleared (Gauss-Jordan), so it costs
  O(L^2 (L + T)) byte operations and serves L up to `harness.SOLVE_MAX_L`;
- every source symbol is recomputed from the intermediate symbols, the
  received ones too, and nothing is copied from the input;
- rows left over once L pivots are found are not checked: a received
  symbol that contradicts the others is not detected.
"""

import numpy as np
import torch

from rqbench.harness import SOLVE_MAX_L
from rqbench.reference import rfc6330


def constraint_rows(P: rfc6330.Params, esis) -> np.ndarray:
    """A [S + H + (K' - K) + len(esis), L] over GF(256): the LDPC and HDPC
    rows and the padding symbols' LT rows of `rfc6330.constraint_matrix`,
    then the LT row of each received ESI's ISI; columns are the
    intermediate symbols C[0..L-1]."""
    esis = np.asarray(esis, np.int64)
    isis = np.where(esis < P.K, esis, esis + (P.Kp - P.K))  # s5.3.1: repair ESIs skip the padding
    A = rfc6330.constraint_matrix(P)
    lt = np.zeros((esis.size, P.L), np.uint8)
    for i, nb in enumerate(rfc6330.neighbors(P, isis)):
        lt[i, nb] ^= 1
    return np.concatenate([A[: P.S + P.H], A[P.S + P.H + P.K :], lt])


def gauss_jordan(M: torch.Tensor, n: int) -> torch.Tensor | None:
    """Reduce M = [A | B] (uint8, A's n columns first) in place over
    GF(256) so that its first n rows read [I | X] with A X = B; returns X,
    or None where A's rank is below n."""
    dev = M.device
    mul = torch.from_numpy(rfc6330.MUL).to(dev)
    inv = torch.from_numpy(rfc6330.INV).to(dev)
    for c in range(n):
        nz = torch.nonzero(M[c:, c])
        if nz.numel() == 0:
            return None
        r = c + int(nz[0, 0])
        if r != c:
            M[[c, r]] = M[[r, c]]
        # columns left of c are zero in this row: only c.. are touched
        piv = mul[int(inv[int(M[c, c])])][M[c, c:].long()]
        M[c, c:] = piv
        rows = torch.nonzero(M[:, c])[:, 0]
        rows = rows[rows != c]
        if rows.numel():
            multiples = mul[:, piv.long()]  # [256, width]: the pivot row times each element
            M[rows, c:] ^= multiples[M[rows, c].long()]
    return M[:n, n:]


def decode(P: rfc6330.Params, esis, payloads, device="cpu") -> np.ndarray | None:
    """The block's K source symbols [K, T] (uint8) from the received
    symbols (esis [n], payloads uint8 [n, T]), or None where they do not
    determine the intermediate symbols."""
    if P.L > SOLVE_MAX_L:
        raise ValueError(f"L = {P.L} is above SOLVE_MAX_L = {SOLVE_MAX_L}: the plain solve would not end")
    payloads = np.asarray(payloads, np.uint8)
    A = torch.from_numpy(constraint_rows(P, esis)).to(device)
    B = torch.zeros((A.shape[0], payloads.shape[1]), dtype=torch.uint8, device=device)
    B[A.shape[0] - payloads.shape[0] :] = torch.from_numpy(payloads).to(device)
    C = gauss_jordan(torch.cat([A, B], dim=1), P.L)
    if C is None:
        return None
    return rfc6330.xor_rows(C, rfc6330.neighbors(P, np.arange(P.K))).cpu().numpy()
