"""K2 and K3 at the main path's shapes, against the plain versions.

    python -m nanorq_tpu_torch.tools.matmul_forms [--shapes NAME,...] [--iters N]

For each shape of `SHAPES` (K = 1000, K' = 1002, T = 1280, Z = 200 blocks:
the encoder's chunk inverse, Wut, HDPC and Vinv at t = T and t = Z*T -- the
encoder schedule's own matrices, cut to their nonzero extents as the replay
passes them, and Wut and HDPC also uncut -- the dense-W decode, single and
batched, and the residual arm's chunk; X random) and of `EDGES` (ragged k,
m < 16, t % 16 != 0, k split across blocks by the launch rule, nb = 1 and
200, K3's log/exp form split and ragged), the wrapper's default call -- the
one kernel its rule picks, named in `form` -- runs on seeded random inputs
and must equal the plain torch version (`ops/gfmat.py`) bit for bit, alone
and XORed into out=.  `ms` is the mean of `--iters` launches captured in
one CUDA graph and replayed (the kernel's own time, not Python's launch
rate), `plain_ms` a CUDA-event mean.  One JSON line per shape.  Needs a
CUDA device.

Each line carries the least time of the product on an H100 SXM at 700 W
(`bounds`): `bytes_ms`, each input read once and the output written once at
3.35 TB/s; `tc_ms`, the operations of the TPU kernels' formulation (int8
matmuls over bit planes: 16 m k t for GF(2), 128 m k t for GF(256)) at
1,979 TOP/s; `m4r_ms`, the 32-bit XORs of the four-Russians method (one per
row, 4 bits of A and 4 bytes of t; A has 8 bits per GF(256) coefficient),
two per three-input LOP3, at 64 LOP3 per clock per SM (CUDA C++
Programming Guide, compute capability 9.0) x 132 SMs x 1.98 GHz.
`bound_ms` is the larger of the bytes and the fewer of the two operation
counts.  `form_floor_ms` is the kept form's own floor, which the bound does
not include: the four-Russians form's table reads (16 bytes of shared
memory per row, group of 4 A bits and 16-byte lane) at 128 bytes per clock
per SM, log/exp's byte lookups at 32 per clock per SM.
"""

import argparse
import json

import numpy as np
import torch

from nanorq_tpu_torch.ops import gfmat, kernels

HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
SM_CLOCKS = 132 * 1.98e9  # SMs x boost clock
LOP3_OPS = 64 * SM_CLOCKS
SMEM_BPS = 128 * SM_CLOCKS
SMEM_LOOKUPS = 32 * SM_CLOCKS
K, KP, T, Z = 1000, 1002, 1280, 200
MPAD = 2048  # the encoder schedule's M_pad at K' = 1002
WIDE = Z * T

# name -> (kind, nb, m, k, t): kind "gf2" (random bits [nb, m, k/8]) or
# "gf256" (random bytes); or ("sched", matrix, t): the K' = 1002 encoder
# schedule's matrix as the replay passes it ("_full": uncut, padded)
SHAPES = {
    "tinv": ("sched", "tinv", T),
    "tinv_wide": ("sched", "tinv", WIDE),
    "wut": ("sched", "wut", T),
    "wut_wide": ("sched", "wut", WIDE),
    "wut_full_wide": ("sched", "wut_full", WIDE),
    "hdpc": ("sched", "mhd", T),
    "hdpc_wide": ("sched", "mhd", WIDE),
    "hdpc_full_wide": ("sched", "mhd_full", WIDE),
    "vinv": ("sched", "vinv", T),
    "vinv_wide": ("sched", "vinv", WIDE),
    "wdec": ("gf2", 1, 64, 1024, T),
    "wdec_b32": ("gf2", 32, 64, 1024, T),
    "wdec_b200": ("gf2", 200, 64, 1024, T),
    "wdec256": ("gf256", 1, 64, MPAD, T),
    "res_w": ("gf256", 32, 110, 1024, T),
    "res_r": ("gf256", 32, 64, 110, T),
}
# name -> (kind, nb, m, k, t); the launch rule splits k wherever rows and
# column tiles give fewer than 528 thread blocks
EDGES = {
    "gf2_ragged": ("gf2", 1, 50, 203, 1283),
    "gf2_m5_longk": ("gf2", 1, 5, 20000, 64),  # 313 splits of 2 k tiles
    "gf2_m13_t8": ("gf2", 2, 13, 77, 8),
    "gf2_nb1_ksplit": ("gf2", 1, 70, 1100, 1296),  # 35 splits of 1 k tile
    "gf2_b200_ragged": ("gf2", 200, 17, 300, 100),
    "gf256_ragged": ("gf256", 1, 20, 203, 1283),
    "gf256_m3_longk": ("gf256", 3, 3, 2000, 160),  # 167 splits of 3 k tiles
    "gf256_m1_t16": ("gf256", 1, 1, 9, 16),
    "gf256_b200": ("gf256", 200, 9, 40, 160),
    "gf256_logexp_ksplit": ("gf256", 1, 7, 1000, 65536),  # log/exp, 8 splits
    "gf256_logexp_ragged": ("gf256", 1, 10, 203, 65541),  # log/exp, byte lanes
}


def form(kind: str, m: int, t: int) -> str:
    """The form the wrapper's rule runs for the shape."""
    if kind == "gf2":
        return "m4r"
    return "logexp" if kernels.gf256_form(m, t) == kernels.GF256_LOGEXP else "m4r"


def bounds(kind: str, nb: int, m: int, k: int, t: int) -> dict:
    """The least times (ms) of one product on the H100 (see the module's
    doc), with `bound_ms` and what sets it."""
    kbits = k if kind == "gf2" else 8 * k
    a_bytes = m * (-(-k // 8) if kind == "gf2" else k)
    b = {"bytes_ms": nb * (a_bytes + k * t + m * t) / HBM_BPS * 1e3,
         "tc_ms": nb * (16 if kind == "gf2" else 128) * m * k * t / INT8_OPS * 1e3,
         "m4r_ms": nb * m * kbits * t / 32 / LOP3_OPS * 1e3}
    ops = min(b["tc_ms"], b["m4r_ms"])
    b["bound_ms"], b["bound_by"] = (b["bytes_ms"], "bytes") if b["bytes_ms"] >= ops else (ops, "operations")
    if form(kind, m, t) == "m4r":
        b["form_floor_ms"] = nb * m * kbits * t / 4 / SMEM_BPS * 1e3
    else:
        b["form_floor_ms"] = nb * m * k * t / SMEM_LOOKUPS * 1e3
    return b


def operands(rng: np.random.Generator, kind: str, nb: int, m: int, k: int, t: int, dev):
    """(A, X) on `dev`: random packed bits [nb, m, ceil(k/8)] or bytes [nb, m, k],
    and X [nb, k, t]; 2-D when nb == 1."""
    if kind == "gf2":
        A = np.packbits(rng.integers(0, 2, (nb, m, k), dtype=np.uint8), axis=2, bitorder="little")
    else:
        A = rng.integers(0, 256, (nb, m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (nb, k, t), dtype=np.uint8)
    if nb == 1:
        A, X = A[0], X[0]
    return torch.from_numpy(A).to(dev), torch.from_numpy(X).to(dev)


def sched_operands(rng: np.random.Generator, which: str, t: int, dev):
    """(kind, A, X) for one matrix of the K' = KP encoder schedule, as
    `ops/replay.replay` hands it to the kernel; X random [k, t]."""
    from nanorq_tpu_torch.codec.cache import encoder_schedule
    from nanorq_tpu_torch.ops.replay import device_arrays

    ds = encoder_schedule(KP)
    arr = device_arrays(ds, dev)
    if which == "tinv":
        kind, A, k = "gf2", arr["tri"][0]["tinv"][0], ds.CB
    elif which == "wut":
        kind, A, k = "gf2", arr["wut"], arr["wut_k"]
    elif which == "wut_full":
        kind, A, k = "gf2", torch.from_numpy(ds.wut).to(dev), ds.u_pad
    elif which == "mhd":
        kind, A = "gf256", arr["mhd"]
        k = A.shape[1]
    elif which == "mhd_full":
        kind, A = "gf256", torch.from_numpy(ds.mhd).to(dev)
        k = A.shape[1]
    else:
        kind, A, k = "gf256", arr["vinv"], ds.u_pad
    X = torch.from_numpy(rng.integers(0, 256, (k, t), dtype=np.uint8)).to(dev)
    return kind, A, X


def plain(kind: str, A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    if kind == "gf256":
        return gfmat.gf256_matmul_batch(A, X) if A.dim() == 3 else gfmat.gf256_matmul(A, X)
    k = X.shape[-2]
    if A.dim() == 2:
        return gfmat.gf2_matmul(gfmat.unpack_bits(A)[:, :k], X)
    return torch.stack([gfmat.gf2_matmul(gfmat.unpack_bits(A[j])[:, :k], X[j]) for j in range(A.shape[0])])


def events_ms(fn, iters: int) -> float:
    """CUDA-event mean of fn() over `iters` back-to-back calls, after one."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls captured in one CUDA graph
    and replayed twice (the second replay timed)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):  # warm up outside the capture (allocator, tables)
        fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / iters


def measure(name: str, spec: tuple, dev, iters: int, timed: bool = True) -> dict:
    """One line: the wrapper's call bit-exact against plain, with its time and
    the bounds."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if spec[0] == "sched":
        kind, A, X = sched_operands(rng, spec[1], spec[2], dev)
        nb, (m, k), t = 1, (A.shape[0], X.shape[0]), X.shape[1]
    else:
        kind, nb, m, k, t = spec
        A, X = operands(rng, kind, nb, m, k, t, dev)
    mm = kernels.gf2_matmul if kind == "gf2" else kernels.gf256_matmul
    want = plain(kind, A, X)
    line = {"name": name, "kind": kind, "nb": nb, "m": m, "k": k, "t": t, "form": form(kind, m, t)}
    got = mm(A, X)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the kernel differs from plain in {int((got != want).sum())} bytes")
    acc = want.clone()  # out ^= product, from the product itself, gives zeros
    mm(A, X, out=acc)
    torch.cuda.synchronize()
    if bool(acc.any()):
        raise AssertionError(f"{name}: the kernel with out= does not XOR into out")
    if timed:
        line["ms"] = graph_ms(lambda: mm(A, X), iters)
        line["plain_ms"] = events_ms(lambda: plain(kind, A, X), 2 if t > T else 5)
        line.update(bounds(kind, nb, m, k, t))
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="", help="comma-separated names (default: all shapes and edges)")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("matmul_forms: needs a CUDA device")
    dev = torch.device("cuda", 0)
    names = [n for n in args.shapes.split(",") if n] or [*SHAPES, *EDGES]
    lines = []
    for n in names:
        if n in SHAPES:
            line = measure(n, SHAPES[n], dev, args.iters)
        else:
            line = measure(n, EDGES[n], dev, args.iters, timed=False)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
