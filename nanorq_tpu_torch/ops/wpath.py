"""Dense combination-matrix (W) decode path on torch tensors.

Counterpart of `nanorq_tpu.ops.wpath`.  A decode pattern's recovered gap
symbols are a linear combination of the payload rows, S = W D, with W folded
on the host from the solver's factorization.  The device work is one matmul:

- GF(2) (binary factorization): K1 gathers the payload rows W's packed bits
  index, then K2 multiplies by the packed bits (`_w_gf2_jit` in JAX);
- GF(256) (HDPC pivots taken): K3 on the byte matrix (`_w_matmul_jit`).

The residual arm's product (`res_apply_batch`) is two batched K3 launches.

The host W constructors (`w_rows`, `w_rows_gf2`) are numpy over the native
solver's ctypes interface.  In the JAX package they sit in a module that
imports jax at its top, so the port carries its own copies, line for line
the same computation.
"""

import ctypes

import numpy as np
import torch

from nanorq_tpu.precode.device_schedule import _pad_rows
from nanorq_tpu.precode.matrix import CSRRows, hdpc_full_rows
from nanorq_tpu.precode.solver import SolveState
from nanorq_tpu_torch.ops.kernels import gf2_matmul, gf256_matmul
from nanorq_tpu_torch.ops.replay import take_rows

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _native():
    from nanorq_tpu.native import get_lib

    return get_lib()


def _pattern_edges(st: SolveState, out_rows: CSRRows):
    """Output-row entries in the pivot basis plus the binary sel-row edges."""
    nrhs = len(out_rows)
    kk, cols = out_rows.select_flat(np.arange(nrhs))
    pos = st.pivpos_of_col[cols]
    uc = st.ucol_of[cols]
    order_sel = st.order[st.i : st.i + st.u]
    bin_slots = np.nonzero(order_sel < st.NB)[0]
    rc = st.rows_cols if isinstance(st.rows_cols, CSRRows) else CSRRows.from_list(st.rows_cols)
    skk, scols = rc.select_flat(order_sel[bin_slots])
    spos = st.pivpos_of_col[scols]
    sm = spos >= 0
    bs_sel = np.ascontiguousarray(bin_slots[skk[sm]], np.int32)
    bs_pos = np.ascontiguousarray(spos[sm], np.int32)
    return nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos


def _p32(a):
    return np.ascontiguousarray(a, np.int32).ctypes.data_as(_i32p)


def w_rows(st: SolveState, out_rows: CSRRows, n_cols: int | None = None) -> tuple[np.ndarray, bool]:
    """Byte combination rows W [nout, n_cols] with (W A)[r] = out row r, and
    whether every coefficient is 0/1 (nanorq_tpu.ops.wpath.w_rows).
    Requires the native factorization; raises RuntimeError otherwise."""
    lib = _native()
    if lib is None or getattr(st, "vinv", None) is None or getattr(st, "tri_edges", None) is None:
        raise RuntimeError("w_rows requires the native solver factorization")
    if not hasattr(lib, "_wsolve_bound"):
        lib.nrq_wsolve.restype = None
        lib.nrq_wsolve.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, _i32p, _i32p, ctypes.c_int64, _i32p, _i32p,
            ctypes.c_int64, _i32p, _i32p, _u8p, _i32p, _u8p, _u8p, _u8p, _u8p, _u8p,
        ]
        lib.nrq_wscatter.restype = None
        lib.nrq_wscatter.argtypes = [ctypes.c_int32, ctypes.c_int32, _i32p, ctypes.c_int32, _u8p, _u8p]
        lib._wsolve_bound = True

    P = st.P
    i, u = st.i, st.u
    nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos = _pattern_edges(st, out_rows)
    g1 = np.zeros((max(i, 1), nrhs), np.uint8)
    g2 = np.zeros((max(u, 1), nrhs), np.uint8)
    m = pos >= 0
    g1[pos[m], kk[m]] = 1
    m = uc >= 0
    g2[uc[m], kk[m]] = 1

    hd_cols = np.zeros(0, np.uint8)
    hd_sel = np.full(max(u, 1), -1, np.int32)
    if st.hdpc_used:
        hd_full = hdpc_full_rows(P)
        hd_cols = np.ascontiguousarray(hd_full[:, st.piv_cols]) if i else np.zeros((P.H, 0), np.uint8)
        hs = np.nonzero(order_sel >= st.NB)[0]
        hd_sel[hs] = (order_sel[hs] - st.NB).astype(np.int32)

    tri_ek, tri_ep = st.tri_edges
    ut_ek, ut_uc = st.ut_edges
    w1 = np.empty((max(i, 1), nrhs), np.uint8)
    w2 = np.empty((max(u, 1), nrhs), np.uint8)
    vinv = np.ascontiguousarray(st.vinv if u else np.zeros((0, 0), np.uint8))

    def p8(a):
        return a.ctypes.data_as(_u8p)

    lib.nrq_wsolve(
        nrhs, i, u, P.H, int(st.hdpc_used),
        tri_ek.size, _p32(tri_ek), _p32(tri_ep),
        ut_ek.size, _p32(ut_ek), _p32(ut_uc),
        bs_sel.size, _p32(bs_sel), _p32(bs_pos),
        p8(hd_cols) if hd_cols.size else None, _p32(hd_sel), p8(vinv) if u else None,
        p8(g1), p8(g2), p8(w1), p8(w2),
    )
    n_cols = n_cols or _pad_rows(st.M + 1)
    W = np.zeros((nrhs, n_cols), np.uint8)
    if i:
        lib.nrq_wscatter(nrhs, i, _p32(st.piv_rows), n_cols, p8(np.ascontiguousarray(w1[:i])), p8(W))
    if bin_slots.size:
        w2b = np.ascontiguousarray(w2[bin_slots])
        lib.nrq_wscatter(nrhs, bin_slots.size, _p32(order_sel[bin_slots]), n_cols, p8(w2b), p8(W))
    return W, not st.hdpc_used


def _pack_rhs(idx_r, idx_c, n, RW8):
    u = np.zeros((n, RW8), np.uint8)
    np.bitwise_or.at(u, (idx_r, idx_c >> 3), (np.uint8(1) << (idx_c & 7).astype(np.uint8)))
    return u


def _quant_k(n: int) -> int:
    """Gathered-row-count grid: multiples of 512."""
    return -(-n // 512) * 512


def w_rows_gf2(st: SolveState, out_rows: CSRRows, zero_row: int):
    """Binary-system W in gathered form (nanorq_tpu.ops.wpath.w_rows_gf2):
    Wbits uint8 [nrhs, kq/8] little-endian packed over the gathered payload
    rows D[rows], rows int32 [kq] padded with `zero_row`."""
    lib = _native()
    if lib is None or st.hdpc_used or getattr(st, "vinv", None) is None or getattr(st, "tri_edges", None) is None:
        raise RuntimeError("w_rows_gf2 requires a native binary factorization")
    if not hasattr(lib, "_wgf2_bound"):
        lib.nrq_wsolve_gf2.restype = None
        lib.nrq_wsolve_gf2.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, _i32p, _i32p, ctypes.c_int64, _i32p, _i32p,
            ctypes.c_int64, _i32p, _i32p, _u8p, _u64p, _u64p, _u64p, _u64p,
        ]
        lib.nrq_bit_transpose.restype = None
        lib.nrq_bit_transpose.argtypes = [ctypes.c_int32, ctypes.c_int32, _u64p, _u64p]
        lib._wgf2_bound = True

    i, u = st.i, st.u
    nrhs, kk, pos, uc, order_sel, bin_slots, bs_sel, bs_pos = _pattern_edges(st, out_rows)
    RW = -(-nrhs // 64)
    RW8 = RW * 8
    m = pos >= 0
    g1 = _pack_rhs(pos[m], kk[m], max(i, 1), RW8)
    m = uc >= 0
    g2 = _pack_rhs(uc[m], kk[m], max(u, 1), RW8)
    tri_ek, tri_ep = st.tri_edges
    ut_ek, ut_uc = st.ut_edges
    w1 = np.empty((max(i, 1), RW8), np.uint8)
    w2 = np.empty((max(u, 1), RW8), np.uint8)
    vinv = np.ascontiguousarray(st.vinv if u else np.zeros((0, 0), np.uint8))

    def p(a, tp):
        return a.ctypes.data_as(tp)

    lib.nrq_wsolve_gf2(
        RW, i, u,
        tri_ek.size, _p32(tri_ek), _p32(tri_ep),
        ut_ek.size, _p32(ut_ek), _p32(ut_uc),
        bs_sel.size, p(bs_sel, _i32p), p(bs_pos, _i32p),
        p(vinv, _u8p) if u else None,
        p(g1, _u64p), p(g2, _u64p), p(w1, _u64p), p(w2, _u64p),
    )
    n = i + bin_slots.size
    kq = max(64, _quant_k(n))
    src = np.empty((n, RW8), np.uint8)
    src[:i] = w1[:i]
    src[i:] = w2[bin_slots]
    NW = -(-n // 64)
    Wt = np.zeros((nrhs, NW * 8), np.uint8)
    lib.nrq_bit_transpose(n, nrhs, p(src, _u64p), p(Wt, _u64p))
    Wbits = np.zeros((nrhs, kq // 8), np.uint8)
    Wbits[:, : min(NW * 8, kq // 8)] = Wt[:, : kq // 8]
    rows = np.full(kq, zero_row, np.int32)
    rows[:i] = st.piv_rows
    rows[i:n] = order_sel[bin_slots].astype(np.int32)
    return Wbits, rows


# --- device apply -----------------------------------------------------------


def w_apply_gf2(Wbits: torch.Tensor, rows: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """out [m, t] = unpack(Wbits) (x)GF(2) D[rows]: a K1 row gather, then K2
    on the packed bits.  Wbits uint8 [m, kq/8], rows int32 [kq, 1]."""
    return gf2_matmul(Wbits, take_rows(D, rows))


def w_apply_gf256(W: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """out [m, t] = W (x)GF(256) D[:k] for W uint8 [m, k] (K3)."""
    return gf256_matmul(W, D[: W.shape[1]])


def w_apply_gf2_batch(bits: torch.Tensor, rows: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Stacked GF(2) W apply: bits [nb, m, kq/8], rows [nb, kq, 1] int32,
    D [nb, M_pad, t] -> [nb, m, t].  One K1 + K2 pair per block."""
    out = D.new_zeros(bits.shape[0], bits.shape[1], D.shape[2])
    for j in range(bits.shape[0]):
        gf2_matmul(bits[j], take_rows(D[j], rows[j]), out=out[j])
    return out


def w_apply_gf256_batch(W: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Stacked GF(256) W apply: W [nb, m, k], D [nb, M_pad, t] -> [nb, m, t],
    one batched K3 launch."""
    return gf256_matmul(W, D[:, : W.shape[2]].contiguous())


def res_apply_batch(W: torch.Tensor, D0: torch.Tensor, R: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The residual decode product X = R (x) (y ^ W (x) D0), batched over blocks
    (counterpart of nanorq_tpu.ops.wpath._res_batch_jit).

    W [nb, nr, k] canonical combination rows of the received repair symbols,
    D0 [nb, k, t] the received payloads (gap rows zero), R [nb, g, nr] the
    host's left inverses of G = W[:, gaps], y [nb, nr, t] the repair payloads
    -> X [nb, g, t], rows [:g_b] of block b its gap payloads.  Zero-padded
    rows and columns are exact no-ops.  Two batched K3 launches: the first
    XORs W (x) D0 into a copy of y through K3's out=, the second multiplies
    that by R.  JAX expands W and R to companion bits on the device
    (`_companion_dev`) because its kernel takes bit planes; K3 takes the byte
    matrices as they are, so no companion step runs here."""
    yhat = y.clone()
    gf256_matmul(W, D0, out=yhat)
    return gf256_matmul(R, yhat)


def w_stack_gf2(plans: list) -> tuple[np.ndarray, np.ndarray]:
    """Stack gathered-form GF(2) WSchedules: (bits [nb, m, kq/8], rows
    [nb, kq]), m and kq padded to the batch max (pad rows read D's zero row)."""
    m = max(p.Wbits.shape[0] for p in plans)
    kq = max(p.rows.size for p in plans)
    bits = np.zeros((len(plans), m, kq // 8), np.uint8)
    rows = np.full((len(plans), kq), plans[0].M_pad - 1, np.int32)
    for j, p in enumerate(plans):
        bits[j, : p.Wbits.shape[0], : p.Wbits.shape[1]] = p.Wbits
        rows[j, : p.rows.size] = p.rows
    return bits, rows


def w_stack_gf256(plans: list) -> np.ndarray:
    """Stack byte-W WSchedules: [nb, m, M_pad] (zero rows are no-ops)."""
    m = max(p.W.shape[0] for p in plans)
    k = plans[0].M_pad
    W = np.zeros((len(plans), m, k), np.uint8)
    for j, p in enumerate(plans):
        W[j, : p.W.shape[0]] = p.W[:, :k]
    return W
