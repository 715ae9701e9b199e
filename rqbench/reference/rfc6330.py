"""A plain RFC 6330 encoder: the yardstick that the benchmark holds the
program's repair symbols to.

Written from the RFC's text (sections named at each function) on numpy and
plain torch, and independent of the program: it imports nothing of it, and
only its constant tables are a frozen copy (`_tables.py`).  It works at the
level of the whole linear map rather than a solver's schedule:

- `constraint_matrix(P)` builds the L x L matrix A of s5.3.3.3 (LDPC, HDPC
  and the K' systematic LT rows) over GF(256);
- `encoding_map(P, K, n)` solves A X = E by Gauss-Jordan elimination over
  GF(256) in torch, E picking the K source rows of D, and multiplies the
  LT rows of the repair ISIs K' .. K'+n-1 (s5.3.5.3) into it: the n x K
  matrix M with repair = M (x) source;
- `gf_matmul(M, D)` takes that product over GF(256) bit by bit, as real
  matrix products of 0/1 values in float32 whose sums are exact (at most
  8 K < 2**24), reduced mod 2.  `precision="bfloat16"` rounds those sums to
  bfloat16 instead: the control, which loses the low bits of sums past 256.

The elimination costs O(L^3) byte operations, so this serves K' up to a few
thousand; a K' of 50,000 needs an inactivation decoder (left for later).
There the reference checks a given block instead, in O(L) row operations:

- `constraint_misses(P, C, source)` counts the bytes by which A C misses
  what the RFC requires (zero LDPC and HDPC rows, the source symbols on the
  first K LT rows, zero padding).  A is regular, so 0 proves C the block's
  intermediate symbols, and `xor_rows(C, neighbors(P, isis))` then gives
  the RFC's symbols of any ISIs from it (s5.3.5.3).
"""

import base64
from dataclasses import dataclass

import numpy as np
import torch

from rqbench.reference import _tables

# --- constants ----------------------------------------------------------------


def _unpack(b64: str, dtype: str) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), dtype=dtype)


V = [_unpack(getattr(_tables, f"V{i}_B64"), "<u4").astype(np.uint64) for i in range(4)]
DEG_F = _unpack(_tables.DEG_B64, "<u4").astype(np.int64)  # f[0..30], s5.3.5.2
K_PADDED = _unpack(_tables.K_PADDED_B64, "<u2").astype(np.int64)
J_K = _unpack(_tables.J_K_B64, "<u2").astype(np.int64)
S_H_W = _unpack(_tables.S_H_W_B64, "<u2").astype(np.int64).reshape(-1, 3)

# GF(256) of s5.7: polynomial x^8 + x^4 + x^3 + x^2 + 1, alpha = 2
EXP = np.zeros(510, np.int64)
LOG = np.zeros(256, np.int64)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
EXP[255:] = EXP[:255]
_a = np.arange(256)
MUL = np.where((_a[:, None] == 0) | (_a[None, :] == 0), 0, EXP[(LOG[:, None] + LOG[None, :]) % 255]).astype(np.uint8)
INV = np.zeros(256, np.uint8)
INV[1:] = EXP[(255 - LOG[1:]) % 255]


def gf_mul(a, b) -> np.ndarray:
    return MUL[np.asarray(a, np.int64), np.asarray(b, np.int64)]


# --- parameters (s5.3.3.3, s5.6) ---------------------------------------------


def _prime(n: int) -> bool:
    return n >= 2 and all(n % d for d in range(2, int(n ** 0.5) + 1))


@dataclass(frozen=True)
class Params:
    K: int
    Kp: int
    J: int
    S: int
    H: int
    W: int
    L: int
    P: int
    P1: int
    B: int


def params(K: int) -> Params:
    """The smallest Table 2 row with K' >= K, and what follows from it."""
    i = int(np.searchsorted(K_PADDED, K))
    Kp, J = int(K_PADDED[i]), int(J_K[i])
    S, H, W = (int(v) for v in S_H_W[i])
    L = Kp + S + H
    P = L - W
    P1 = next(p for p in range(P, 2 * P + 2) if _prime(p))
    return Params(K=K, Kp=Kp, J=J, S=S, H=H, W=W, L=L, P=P, P1=P1, B=W - S)


# --- Rand, Deg, Tuple (s5.3.5.1, s5.3.5.2, s5.3.5.4) ------------------------


def rand(y, i: int, m) -> np.ndarray:
    """Rand[y, i, m] for an array of y."""
    y = np.asarray(y, np.uint64)
    x = [((y >> np.uint64(8 * k)) + np.uint64(i)) & np.uint64(0xFF) for k in range(4)]
    return (V[0][x[0]] ^ V[1][x[1]] ^ V[2][x[2]] ^ V[3][x[3]]) % np.uint64(m)


def tuples(P: Params, X) -> tuple:
    """(d, a, b, d1, a1, b1) for an array of ISIs X."""
    X = np.asarray(X, np.uint64)
    A = 53591 + P.J * 997
    A += A % 2 == 0
    B = 10267 * (P.J + 1)
    y = (np.uint64(B) + X * np.uint64(A)) & np.uint64(0xFFFFFFFF)
    v = rand(y, 0, 1 << 20).astype(np.int64)
    d = np.minimum(np.searchsorted(DEG_F, v, side="right"), P.W - 2)  # Deg[v]: f[d-1] <= v < f[d]
    a = 1 + rand(y, 1, P.W - 1).astype(np.int64)
    b = rand(y, 2, P.W).astype(np.int64)
    d1 = np.where(d < 4, 2 + rand(X, 3, 2).astype(np.int64), 2)
    a1 = 1 + rand(X, 4, P.P1 - 1).astype(np.int64)
    b1 = rand(X, 5, P.P1).astype(np.int64)
    return d, a, b, d1, a1, b1


def neighbors(P: Params, X) -> list[np.ndarray]:
    """For each ISI of X, the intermediate symbols that Enc[K', C, Tuple]
    (s5.3.5.3) adds up: d LT symbols b, b+a, ... mod W, then d1 PI symbols W
    + b1, stepping b1 by a1 mod P1 and skipping values >= P."""
    d, a, b, d1, a1, b1 = tuples(P, X)
    out = []
    for di, ai, bi, d1i, a1i, b1i in zip(d, a, b, d1, a1, b1):
        lt = (bi + ai * np.arange(di)) % P.W
        pi = []
        while b1i >= P.P:
            b1i = (b1i + a1i) % P.P1
        pi.append(b1i)
        for _ in range(d1i - 1):
            b1i = (b1i + a1i) % P.P1
            while b1i >= P.P:
                b1i = (b1i + a1i) % P.P1
            pi.append(b1i)
        out.append(np.concatenate([lt, P.W + np.asarray(pi, np.int64)]))
    return out


# --- the constraint matrix (s5.3.3.3) ----------------------------------------


def ldpc_columns(P: Params) -> list[np.ndarray]:
    """For each LDPC row 0..S-1, the intermediate symbols it adds up:
    G_LDPC,1 (each of the first B columns in three rows), I_S, and G_LDPC,2
    (two PI symbols).  A symbol named twice in a row cancels."""
    S, B, W = P.S, P.B, P.W
    i = np.arange(B)
    a, b = 1 + i // S, i % S
    s = np.arange(S)
    rows = np.concatenate([b, (b + a) % S, (b + 2 * a) % S, s, s, s])
    cols = np.concatenate([i, i, i, B + s, W + s % P.P, W + (s + 1) % P.P])
    pairs, count = np.unique(np.stack([rows, cols], 1), axis=0, return_counts=True)
    pairs = pairs[count % 2 == 1]
    return np.split(pairs[:, 1], np.searchsorted(pairs[:, 0], np.arange(1, S)))


def hdpc_matrix(P: Params) -> np.ndarray:
    """G_HDPC [H, K'+S] = MT x GAMMA over GF(256)."""
    S, H, Kp = P.S, P.H, P.Kp
    n = Kp + S
    MT = np.zeros((H, n), np.uint8)
    j = np.arange(n - 1)
    r6 = rand(j + 1, 6, H).astype(np.int64)
    r7 = rand(j + 1, 7, H - 1).astype(np.int64)
    MT[r6, j] = 1
    MT[(r6 + r7 + 1) % H, j] = 1  # the two rows differ: r7 + 1 < H
    MT[:, n - 1] = EXP[np.arange(H)]
    # row h of MT x GAMMA: g[j] = sum_{i >= j} MT[h, i] alpha^(i - j),
    # so g[j] = MT[h, j] + alpha * g[j + 1]
    G = np.zeros((H, n), np.uint8)
    g = np.zeros(H, np.uint8)
    for c in range(n - 1, -1, -1):
        g = MT[:, c] ^ MUL[2, g]
        G[:, c] = g
    return G


def constraint_matrix(P: Params) -> np.ndarray:
    """A [L, L] over GF(256): rows 0..S-1 LDPC, S..S+H-1 HDPC, then the LT
    rows of ISIs 0..K'-1; columns are the intermediate symbols C[0..L-1]."""
    S, H, Kp, L = P.S, P.H, P.Kp, P.L
    A = np.zeros((L, L), np.uint8)
    for r, cols in enumerate(ldpc_columns(P)):
        A[r, cols] = 1
    A[S : S + H, : Kp + S] = hdpc_matrix(P)
    A[S + np.arange(H), Kp + S + np.arange(H)] = 1  # I_H
    for i, nb in enumerate(neighbors(P, np.arange(Kp))):  # G_ENC
        A[S + H + i, nb] ^= 1
    return A


# --- the check of a given intermediate block ----------------------------------


def xor_rows(C: torch.Tensor, cols: list, chunk: int = 4096) -> torch.Tensor:
    """[len(cols), w]: row r the XOR of the rows cols[r] of C (uint8 [L, w])."""
    deg = np.array([c.size for c in cols])
    idx = np.full((len(cols), deg.max()), C.shape[0], np.int64)  # the pad reads a zero row
    idx[np.repeat(np.arange(len(cols)), deg), np.concatenate([np.arange(d) for d in deg])] = np.concatenate(cols)
    idx = torch.from_numpy(idx).to(C.device)
    Cz = torch.cat([C, C.new_zeros((1, C.shape[1]))])
    out = torch.empty((len(cols), C.shape[1]), dtype=torch.uint8, device=C.device)
    for lo in range(0, len(cols), chunk):
        part = Cz[idx[lo : lo + chunk, 0]]
        for k in range(1, idx.shape[1]):
            part ^= Cz[idx[lo : lo + chunk, k]]
        out[lo : lo + chunk] = part
    return out


def constraint_misses(P: Params, C: torch.Tensor, source: torch.Tensor, lt=None) -> int:
    """The bytes of A C (s5.3.3.3) that differ from what the RFC requires:
    zero for the S LDPC and H HDPC rows, the K source symbols and then zero
    for the K' LT rows.  C uint8 [L, w], source [K, w]; `lt`, if given, the
    neighbors of ISIs 0..K'-1.  A is regular (s5.6), so 0 proves C the
    block's intermediate symbols."""
    S, H, Kp = P.S, P.H, P.Kp
    miss = int(torch.count_nonzero(xor_rows(C, ldpc_columns(P))))
    G = torch.from_numpy(hdpc_matrix(P)).to(C.device)
    miss += int(torch.count_nonzero(gf_matmul(G, C[: Kp + S], cols=512) ^ C[Kp + S :]))
    got = xor_rows(C, neighbors(P, np.arange(Kp)) if lt is None else lt)
    got[: P.K] ^= source
    return miss + int(torch.count_nonzero(got))


# --- the encoding map ---------------------------------------------------------


def _solve(A: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """X with A X = E over GF(256), by Gauss-Jordan elimination (uint8)."""
    dev = A.device
    mul = torch.from_numpy(MUL).to(dev).reshape(-1).long()
    inv = torch.from_numpy(INV).to(dev).long()
    M = torch.cat([A, E], dim=1).long()
    n = A.shape[0]
    for c in range(n):
        r = c + int(torch.nonzero(M[c:, c])[0, 0])  # A is regular (s5.6)
        if r != c:
            M[[c, r]] = M[[r, c]]
        M[c] = mul[inv[M[c, c]] * 256 + M[c]]
        f = M[:, c].clone()
        f[c] = 0
        rows = torch.nonzero(f)[:, 0]
        if rows.numel():
            M[rows] ^= mul[f[rows, None] * 256 + M[c][None, :]]
    return M[:, n:].to(torch.uint8)


def encoding_map(P: Params, n_repair: int, device="cpu") -> torch.Tensor:
    """M [n_repair, K] over GF(256): the repair symbols of ESIs K .. K+n-1
    (ISIs K' .. K'+n-1, s5.3.1) of a block are M (x) its K source symbols."""
    A = torch.from_numpy(constraint_matrix(P)).to(device)
    E = torch.zeros((P.L, P.K), dtype=torch.uint8, device=device)
    E[P.S + P.H + torch.arange(P.K, device=device), torch.arange(P.K, device=device)] = 1
    X = _solve(A, E)  # C = X (x) source
    rep = torch.zeros((n_repair, P.K), dtype=torch.uint8, device=device)
    for i, nb in enumerate(neighbors(P, np.arange(P.Kp, P.Kp + n_repair))):
        rep[i] = _xor_rows(X, nb)
    return rep


def _xor_rows(X: torch.Tensor, rows) -> torch.Tensor:
    out = X[int(rows[0])].clone()
    for r in rows[1:]:
        out ^= X[int(r)]
    return out


def gf_matmul(M: torch.Tensor, D: torch.Tensor, precision: str = "float32", cols: int = 1 << 14) -> torch.Tensor:
    """M (x) D over GF(256): M uint8 [n, k], D uint8 [k, w] -> uint8 [n, w].

    Multiplication by a constant c is GF(2)-linear on the 8 bits of an
    octet: bit p of c x is sum_q bit p of (c alpha^q) times bit q of x.  So M
    becomes a 0/1 matrix [8n, 8k], D a 0/1 matrix [8k, w], and the product
    is their real product mod 2."""
    dev = D.device
    n, k = M.shape
    q = torch.arange(8, device=dev)
    mul = torch.from_numpy(MUL).to(dev).long()
    prod = mul[M.long()[:, :, None], (1 << q)[None, None, :]]  # [n, k, q]: M alpha^q
    Mb = ((prod[..., None] >> q) & 1).permute(0, 3, 1, 2).reshape(8 * n, 8 * k)  # rows (i, p), cols (j, q)
    dt = torch.float32 if precision == "float32" else torch.bfloat16
    Mb = Mb.to(dt)
    out = torch.empty((n, D.shape[1]), dtype=torch.uint8, device=dev)
    q32 = q.to(torch.int32)
    weight = (1 << q32).view(1, 8, 1)
    tf32 = dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, D.shape[1], cols):
            Dc = D[:, lo : lo + cols].to(torch.int32)
            Db = ((Dc[:, None, :] >> q32[None, :, None]) & 1).reshape(8 * k, -1).to(dt)  # rows (j, q)
            R = (Mb @ Db).to(torch.int32) & 1
            out[:, lo : lo + cols] = (R.view(n, 8, -1) * weight).sum(1).to(torch.uint8)
    finally:
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def repair_symbols(P: Params, source: np.ndarray, n_repair: int, device="cpu", M=None,
                   precision: str = "float32") -> np.ndarray:
    """Repair symbols [blocks, n_repair, T] of an object laid as blocks of K
    source symbols of T bytes each (source uint8 [blocks, K, T])."""
    Z, K, T = source.shape
    M = encoding_map(P, n_repair, device) if M is None else M
    D = torch.from_numpy(np.ascontiguousarray(source.transpose(1, 0, 2).reshape(K, Z * T))).to(device)
    R = gf_matmul(M, D, precision)
    return R.cpu().numpy().reshape(n_repair, Z, T).transpose(1, 0, 2)
