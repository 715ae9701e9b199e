"""Wrappers of the three payload kernels (`csrc/*.cu`).

Each wrapper checks what it is given and raises on anything its kernel does
not take.  On CPU tensors it runs the plain torch version in `ops/gfmat.py`;
on CUDA tensors it launches the kernel on the current stream, or raises --
there is no fallback.  `LAUNCHES[name]` counts kernel launches (CUDA only),
so a run can show that its main path went through the kernels.  An index
that gather_xor cannot take raises on the CPU; on CUDA the kernel sets a
device flag that `take_index_errors` reads.

Every wrapper takes an optional `out`: when given, the result is XORed into
it in place (the replay accumulates gathers and products into row blocks it
owns) instead of being returned in a fresh tensor.
"""

import numpy as np
import torch

from nanorq_tpu.gf256.tables import OCT_EXP, OCT_LOG
from nanorq_tpu_torch.ops import _build, gfmat

LAUNCHES = {"gather_xor": 0, "gf2_matmul": 0, "gf256_matmul": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _bytes2d(x: torch.Tensor, name: str) -> None:
    _need(isinstance(x, torch.Tensor) and x.dtype == torch.uint8 and x.dim() == 2,
          f"{name}: expected a 2-D uint8 tensor, got {getattr(x, 'dtype', type(x))} "
          f"{tuple(getattr(x, 'shape', ()))}")
    _need(x.is_contiguous(), f"{name}: must be contiguous")


def _out(out, shape, *inputs: torch.Tensor):
    """Check an out= tensor: its shape, its device, and that it shares no
    bytes with an input (the kernels read and write through __restrict__)."""
    if out is None:
        return None
    _bytes2d(out, "out")
    _need(tuple(out.shape) == tuple(shape), f"out: shape {tuple(out.shape)} != {tuple(shape)}")
    o0 = out.data_ptr()
    o1 = o0 + out.numel()
    for x in inputs:
        _need(out.device == x.device, "out: on another device than the inputs")
        x0 = x.data_ptr()
        _need(o1 <= x0 or x0 + x.numel() * x.element_size() <= o0, "out: overlaps an input")
    return out


def _plain(res: torch.Tensor, out):
    if out is None:
        return res
    out ^= res
    return out


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _device_kind(*xs: torch.Tensor) -> str:
    dev = xs[0].device
    for x in xs[1:]:
        _need(x.device == dev, f"inputs on different devices: {dev} and {x.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


_INDEX_ERR: dict = {}  # CUDA device -> int32 [1], set by K1 on an index outside [0, S)


def take_index_errors(device: torch.device) -> bool:
    """Whether a gather_xor launch on the CUDA `device` met an index outside
    [0, S) since the last call, and clear the flag.  Waits for the device."""
    flag = _INDEX_ERR.get(torch.device(device))
    if flag is None:
        return False
    bad = bool(flag.item())
    flag.zero_()
    return bad


def _index_flag(dev: torch.device) -> torch.Tensor:
    flag = _INDEX_ERR.get(dev)
    if flag is None:
        flag = _INDEX_ERR[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return flag


def gather_xor(src: torch.Tensor, idx: torch.Tensor, out: torch.Tensor | None = None, *,
               check: bool = False) -> torch.Tensor:
    """K1: out[i] = XOR_k src[idx[i, k]];  src uint8 [S, t], idx int32 [n, w].

    Indices must lie in [0, S); the codec's sentinels point at a zero row.
    An index outside raises IndexError: always on the CPU; on CUDA the
    kernel flags it on the device, and the wrapper raises when `check` is
    set (which waits for the kernel) -- else the flag stays set for
    `take_index_errors`."""
    _bytes2d(src, "src")
    _need(idx.dtype == torch.int32 and idx.dim() == 2 and idx.is_contiguous(),
          f"idx: expected a contiguous 2-D int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    S, t = src.shape
    n, w = idx.shape
    out = _out(out, (n, t), src, idx)
    if _device_kind(src, idx) == "cpu":
        if n == 0 or w == 0:
            return _plain(src.new_zeros(n, t), out)
        if int(idx.min()) < 0 or int(idx.max()) >= S:
            raise IndexError(f"gather_xor: an index lies outside [0, {S})")
        return _plain(gfmat.xor_reduce_gather(src, idx), out)
    acc = out is not None
    res = out if acc else torch.empty((n, t), dtype=torch.uint8, device=src.device)
    if n and t:
        lib = _build.load()
        with torch.cuda.device(src.device):
            _launch("gather_xor", lib.nrq_gather_xor, src.data_ptr(), S, t, idx.data_ptr(), n, w,
                    res.data_ptr(), int(acc), _index_flag(src.device).data_ptr(), _stream(src.device))
        if check and take_index_errors(src.device):
            raise IndexError(f"gather_xor: an index lies outside [0, {S})")
    return res


def gf2_matmul(bits: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: out[r] = XOR_{c: bit(r,c)} X[c];  bits uint8 [m, >=ceil(k/8)] packed
    little-endian (bit c of row r = bits[r, c//8] >> (c%8) & 1), X uint8 [k, t]."""
    _bytes2d(bits, "bits")
    _bytes2d(X, "X")
    m, pitch = bits.shape
    k, t = X.shape
    _need(pitch * 8 >= k, f"bits: {pitch} bytes per row cannot hold k={k} columns")
    out = _out(out, (m, t), bits, X)
    if _device_kind(bits, X) == "cpu":
        return _plain(gfmat.gf2_matmul(gfmat.unpack_bits(bits)[:, :k], X), out)
    acc = out is not None
    res = out if acc else torch.empty((m, t), dtype=torch.uint8, device=X.device)
    if m and t:
        lib = _build.load()
        with torch.cuda.device(X.device):
            _launch("gf2_matmul", lib.nrq_gf2_matmul, bits.data_ptr(), m, k, pitch, X.data_ptr(), t,
                    res.data_ptr(), int(acc), _stream(X.device))
    return res


_TABLES: dict = {}  # device -> (log uint16-as-int16 [256], exp uint8 [1024])


def _gf_tables(dev: torch.device):
    tabs = _TABLES.get(dev)
    if tabs is None:
        log = OCT_LOG.astype(np.int16)
        log[0] = 512  # sentinel: log[0] + any log lands in exp's zero half
        exp = np.zeros(1024, np.uint8)
        exp[:510] = OCT_EXP[:510]
        tabs = _TABLES[dev] = (torch.from_numpy(log).to(dev), torch.from_numpy(exp).to(dev))
    return tabs


def gf256_matmul(M: torch.Tensor, X: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """K3: out[r] = XOR_c M[r,c] (x) X[c] over GF(256);  M uint8 [m, k], X uint8 [k, t]."""
    _bytes2d(M, "M")
    _bytes2d(X, "X")
    m, k = M.shape
    _need(X.shape[0] == k, f"X: {X.shape[0]} rows for a {k}-column M")
    t = X.shape[1]
    out = _out(out, (m, t), M, X)
    if _device_kind(M, X) == "cpu":
        return _plain(gfmat.gf256_matmul(M, X), out)
    acc = out is not None
    res = out if acc else torch.empty((m, t), dtype=torch.uint8, device=X.device)
    if m and t:
        lib = _build.load()
        log, exp = _gf_tables(X.device)
        with torch.cuda.device(X.device):
            _launch("gf256_matmul", lib.nrq_gf256_matmul, M.data_ptr(), m, k, X.data_ptr(), t,
                    log.data_ptr(), exp.data_ptr(), res.data_ptr(), int(acc), _stream(X.device))
    return res
