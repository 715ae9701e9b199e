"""K1 at every gather of one warm encode, against its plain version and its bounds.

    python -m nanorq_tpu_torch.tools.gather_launches [--iters N]

Records the K1 launches of one structured replay and one repair LT combine
-- what `codec.batch.generate` and `repair_symbols` run -- through the
K = 1000 encoder schedule (K' = 1002) and the plan of 200 repair symbols, on
a seeded random D at t = Z*T (Z = 200 blocks of T = 1280), warm (a first
replay builds the schedule's tensors).  Then, for each launch, on its own
operands: the kernel bit-exact against the plain version (`gfmat`), into a
fresh tensor, XORed into its out= (at its `rows`), or written into its out=
(`overwrite`: the replay's prologue fills the buffers its program owns);
`ms`, its mean over `--iters` launches in one CUDA graph; `plain_ms` (CUDA
events); and, for a width-1 gather that does not XOR, one
`torch.index_select` of the same rows (`library_ms`, in a CUDA graph).  One
JSON line per launch, then one line of sums.  Needs a CUDA device.

Bounds, at the H100 SXM data sheet's 3.35 TB/s (`bounds`): `bound_ms`, the
bytes the launch must move -- each distinct source row it reads once (index
S under zero_index reads nothing), its output rows written once and, when it
XORs into out, read once, its indices and rows once; `gathered_ms`, the
bytes of every slot read, as a kernel that finds no row in L2 moves them.
A launch's time in a loop of itself finds its inputs in L2 where they fit
(50 MB); the encode finds them there only when an earlier stage left them.
"""

import argparse
import json

import numpy as np
import torch

from nanorq_tpu_torch.ops import gfmat, kernels
from nanorq_tpu_torch.tools.matmul_forms import events_ms, graph_ms

HBM_BPS = 3.35e12  # the H100 SXM data sheet's memory rate
K, KP, T, Z, N_REPAIR = 1000, 1002, 1280, 200, 200
WIDE = Z * T
ENCODE_LAUNCHES = 17  # of one warm encode: the replay's 15 and the LT combine's 2


def encode_launches(dev, t: int = WIDE, seed: int = 0) -> list:
    """The K1 launches of one warm replay + repair LT combine at width t, as
    `kernels.record_gathers` records them."""
    from nanorq_tpu_torch.codec.cache import encoder_schedule
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
    from nanorq_tpu_torch.ops.replay import device_arrays, replay
    from nanorq_tpu_torch.rfc.params import params_init

    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds, dev)
    plan = lt_plan(np.arange(P.Kp, P.Kp + N_REPAIR, dtype=np.uint32), P, dev)
    D = torch.zeros((ds.M_pad, t), dtype=torch.uint8, device=dev)
    D[:K] = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (K, t), dtype=np.uint8)).to(dev)
    replay(arr, D)  # warm: nothing left to build
    with kernels.record_gathers() as rec:
        lt_combine(replay(arr, D), plan)
    return rec


def _acc(r: dict) -> bool:
    """Whether the launch XORed into its out= (not written into it, nor fresh)."""
    return r["out"] is not None and not r["overwrite"]


def label(r: dict) -> str:
    S, t = r["src"].shape
    n, w = r["idx"].shape
    tags = [tag for tag, on in (("acc", _acc(r)), ("into", r["overwrite"]), ("rows", r["rows"] is not None),
                                ("zero", r["zero_index"] is not None)) if on]
    return f"src[{S},{t}] idx({n},{w})" + ("" if not tags else " " + "+".join(tags))


def bounds(r: dict) -> dict:
    """bound_ms and gathered_ms of one launch (see the module's doc)."""
    src, idx, out, rows = r["src"], r["idx"], r["out"], r["rows"]
    t = src.shape[1]
    n = idx.shape[0]
    read = idx[idx != r["zero_index"]] if r["zero_index"] is not None else idx.reshape(-1)
    small = idx.numel() * 4 + (0 if rows is None else n * 4)
    out_bytes = n * t * (2 if _acc(r) else 1)
    return {"bound_ms": (int(torch.unique(read).numel()) * t + out_bytes + small) / HBM_BPS * 1e3,
            "gathered_ms": (int(read.numel()) * t + out_bytes + small) / HBM_BPS * 1e3}


def _calls(r: dict):
    """(kernel call, plain call) on r's operands; each XORs into (or, for an
    overwrite, writes into) its own copy of r's out, or returns a fresh
    result."""
    src, idx, rows, zi, over = r["src"], r["idx"], r["rows"], r["zero_index"], r["overwrite"]
    kout = None if r["out"] is None else r["out"].clone()
    pout = None if r["out"] is None else r["out"].clone()
    if over:
        return (lambda: kernels.gather_xor(src, idx, out=kout, zero_index=zi, overwrite=True),
                lambda: pout.copy_(gfmat.xor_reduce_gather(src, idx, zero_index=zi)))
    return (lambda: kernels.gather_xor(src, idx, out=kout, rows=rows, zero_index=zi),
            lambda: gfmat.xor_reduce_gather(src, idx, out=pout, rows=rows, zero_index=zi))


def check(r: dict) -> None:
    """The kernel against the plain version on r's operands, bit for bit."""
    kfn, pfn = _calls(r)
    got, want = kfn(), pfn()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label(r)}: K1 differs from plain in {int((got != want).sum())} bytes")
    if kernels.take_index_errors(r["src"].device):
        raise AssertionError(f"{label(r)}: K1 flagged an index or a row")


def measure(r: dict, iters: int) -> dict:
    """One line: bit-exactness, times and bounds of one recorded launch."""
    check(r)
    src, idx = r["src"], r["idx"]
    n, w = idx.shape
    line = {"shape": label(r), "S": src.shape[0], "t": src.shape[1], "n": n, "w": w}
    kfn, pfn = _calls(r)
    line["ms"] = graph_ms(kfn, iters)
    line["plain_ms"] = events_ms(pfn, 2 if src.shape[1] > T else 5)
    line["library_ms"] = None
    if w == 1 and not _acc(r):
        col = idx[:, 0].contiguous()
        line["library_ms"] = graph_ms(lambda: torch.index_select(src, 0, col), iters)
    line.update(bounds(r))
    line["share"] = line["bound_ms"] / line["ms"]
    line["gathered_share"] = line["gathered_ms"] / line["ms"]
    return line


def totals(lines: list) -> dict:
    return {"launches": len(lines), **{k: sum(x[k] for x in lines) for k in ("ms", "bound_ms")}}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_launches: needs a CUDA device")
    rec = encode_launches(torch.device("cuda", 0))
    if len(rec) != ENCODE_LAUNCHES:
        raise AssertionError(f"one encode ran {len(rec)} K1 launches, expected {ENCODE_LAUNCHES}")
    lines = [measure(r, args.iters) for r in rec]
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps(totals(lines)), flush=True)
    return lines


if __name__ == "__main__":
    main()
