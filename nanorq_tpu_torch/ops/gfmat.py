"""Plain torch GF(2)/GF(256) primitives: the reference every kernel is held to.

Counterparts of `nanorq_tpu.ops.gfmat` (bit-plane matmuls and gather-XOR) and
`nanorq_tpu.gf256.bitplane` (companion bits).  `ops/kernels.py` runs these on
CPU tensors; on CUDA tensors they exist only to check and time the kernels.

A GF(2) combination of byte rows is an integer matmul per bit plane, reduced
mod 2.  On the CPU that matmul is integer (int32).  On a CUDA tensor it is a
float32 matmul over 0/1 operands: every product is 0 or 1 and every sum is at
most k < 2**24, so float32 holds it exactly, and it stays exact under TF32
too (0 and 1 are exact in TF32's 10-bit mantissa and the sum accumulates in
float32).
"""

import torch

from nanorq_tpu_torch.gf256.tables import GF_MUL, OCT_EXP

_SHIFTS = {}  # device -> uint8 arange(8), the bit positions
_GF_MUL = {}  # device -> [256, 256] uint8 product table
_ALPHA = {}  # device -> int64 alpha^0..alpha^7


def _shifts(device) -> torch.Tensor:
    s = _SHIFTS.get(device)
    if s is None:
        s = _SHIFTS[device] = torch.arange(8, dtype=torch.uint8, device=device)
    return s


def unpack_bits(p: torch.Tensor) -> torch.Tensor:
    """Little-endian bit unpack along the last axis: [..., kb] -> [..., 8kb]
    (the np.packbits(..., bitorder="little") layout of the schedules)."""
    bits = (p[..., :, None] >> _shifts(p.device)) & 1
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 8)


def unpack_planes(X: torch.Tensor) -> torch.Tensor:
    """[n, t] uint8 -> [n, 8, t] 0/1 bit planes (plane b = bit b)."""
    return (X[:, None, :] >> _shifts(X.device)[None, :, None]) & 1


def pack_planes(P8: torch.Tensor) -> torch.Tensor:
    """[n, 8, t] 0/1 -> [n, t] uint8."""
    w = (1 << _shifts(P8.device).to(torch.int32))[None, :, None]
    return (P8.to(torch.int32) * w).sum(1).to(torch.uint8)


def _mm_mod2(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A @ B) mod 2 for 0/1 uint8 operands, exact on either device."""
    if A.device.type == "cuda":
        acc = torch.mm(A.to(torch.float32), B.to(torch.float32))
        return (acc.to(torch.int32) & 1).to(torch.uint8)
    return (torch.mm(A.to(torch.int32), B.to(torch.int32)) & 1).to(torch.uint8)


def gf2_matmul(bits: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """out[r] = XOR_{c: bits[r,c]=1} X[c];  bits [m, k] 0/1, X [k, t] uint8."""
    k, t = X.shape
    planes = unpack_planes(X).reshape(k, 8 * t)
    out = _mm_mod2(bits, planes).reshape(bits.shape[0], 8, t)
    return pack_planes(out)


def companion_bits(M: torch.Tensor) -> torch.Tensor:
    """GF(256) matrix [m, k] -> GF(2) companion matrix [8m, 8k] (0/1 uint8):
    comp[8r+o, 8c+b] = bit_o(M[r,c] (x) alpha^b)."""
    dev = M.device
    tab = _GF_MUL.get(dev)
    if tab is None:
        tab = _GF_MUL[dev] = torch.from_numpy(GF_MUL.copy()).to(dev)
        _ALPHA[dev] = torch.from_numpy(OCT_EXP[:8].astype("int64")).to(dev)
    m, k = M.shape
    prod = tab[M.to(torch.int64)[:, :, None], _ALPHA[dev][None, None, :]]  # [m, k, b]
    bits = (prod[..., None] >> _shifts(dev)) & 1  # [m, k, b, o]
    return bits.permute(0, 3, 1, 2).reshape(8 * m, 8 * k)


def gf256_matmul_bits(Mbits: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """GF(256) matmul via companion bits: Mbits [8m, 8k], X [k, t] uint8."""
    k, t = X.shape
    xb = unpack_planes(X).reshape(8 * k, t)  # row 8c+b = bit b of X[c]
    ob = _mm_mod2(Mbits, xb)  # [8m, t]
    return pack_planes(ob.reshape(Mbits.shape[0] // 8, 8, t))


def gf256_matmul(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """out[r] = XOR_c M[r,c] (x) X[c] over GF(256), poly 0x11D."""
    return gf256_matmul_bits(companion_bits(M), X)


def gf256_matmul_batch(M: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """nb independent GF(256) products: M [nb, m, k], X [nb, k, t] -> [nb, m, t]."""
    out = X.new_zeros(M.shape[0], M.shape[1], X.shape[2])
    for j in range(M.shape[0]):
        out[j] = gf256_matmul(M[j], X[j])
    return out


def xor_reduce_gather(src: torch.Tensor, idx: torch.Tensor, *, out: torch.Tensor | None = None,
                      rows: torch.Tensor | None = None, zero_index: int | None = None) -> torch.Tensor:
    """res[i] = XOR_k src[idx[i,k]]: src [S, t], idx [n, w] -> [n, t].

    zero_index (= S): that index reads as a zero row.  With `out`, res is
    XORed into it in place: into out[rows[i]] when rows (int [n], distinct)
    is given, else into out[i]."""
    if zero_index is not None:
        src = torch.cat([src, src.new_zeros(1, src.shape[1])])
    idx = idx.to(torch.int64)
    res = src.new_zeros(idx.shape[0], src.shape[1]) if idx.shape[1] == 0 else src[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        res ^= src[idx[:, j]]
    if out is None:
        return res
    if rows is None:
        out ^= res
    else:
        out[rows.to(torch.int64)] ^= res
    return out


def xor_reduce_gather_skip(src: torch.Tensor, idx: torch.Tensor, sentinel: int) -> torch.Tensor:
    """out[i] = XOR over k with idx[i,k] != sentinel of src[idx[i,k]]: a
    sentinel slot reads as zero whatever src[sentinel] holds."""
    idx = idx.to(torch.int64)
    out = src.new_zeros(idx.shape[0], src.shape[1])
    for j in range(idx.shape[1]):
        col = idx[:, j]
        out ^= src[col] * (col != sentinel).to(src.dtype)[:, None]
    return out
