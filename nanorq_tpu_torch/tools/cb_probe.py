"""Replay time against the trisolve's chunk size CB (counterpart of
`tools/cb_probe.py`).

    python -m nanorq_tpu_torch.tools.cb_probe K [CB ...] [--blocks B] [--iters N] [--device cuda]

Solves the K' of K once, compiles its encoder schedule at each CB
(`precode.device_schedule.compile_device(st, CB=)`; `default_cb` is a TPU
tuning) and times the structured replay of a seeded random D [M_pad, B*T],
T = 1280, B as the JAX tool takes it (32 blocks up to K = 2000, 16 up to
20000, else 4).  CB changes how the triangle is cut into chunks, never what
the replay computes: the intermediate symbols C of every CB are held against
the first CB's bit for bit, and a difference raises.  One JSON line per CB
(its chunks and segments, the range gathers' launches, ms / graph_ms, Gb/s
of payload), each with the card's name and power limit.
"""

import argparse
import time

import numpy as np
import torch

from nanorq_tpu_torch.ops.replay import device_arrays, replay
from nanorq_tpu_torch.precode.device_schedule import compile_device, default_cb
from nanorq_tpu_torch.precode.matrix import binary_rows
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import _sweep

T = 1280


def default_blocks(K: int) -> int:
    return 32 if K <= 2000 else (16 if K <= 20000 else 4)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("K", type=int)
    ap.add_argument("cbs", type=int, nargs="*", help="default: 128 256 512")
    ap.add_argument("--blocks", type=int, default=0, help="0: the JAX tool's B for K")
    ap.add_argument("--T", type=int, default=T)
    ap.add_argument("--iters", type=int, default=8)
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    K, cbs = args.K, args.cbs or [128, 256, 512]
    B = args.blocks or default_blocks(K)
    t = B * args.T
    P = params_init(K)
    st = solve_state(P, binary_rows(P))
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, 256, (K, t), dtype=np.uint8)).to(dev)
    first, lines = None, []
    for CB in cbs:
        t0 = time.perf_counter()
        ds = compile_device(st, CB=CB)
        compile_s = time.perf_counter() - t0
        arr = device_arrays(ds, dev)
        D = torch.zeros((ds.M_pad, t), dtype=torch.uint8, device=dev)
        D[:K] = src
        C = replay(arr, D)
        if first is None:
            first = C
        elif not torch.equal(C, first):
            raise AssertionError(f"K={K}: C at CB={CB} differs from C at CB={cbs[0]}")
        del C
        ranges = sum(seg.tinv.shape[0] * len(seg.ranges) for seg in ds.tri)
        line = {"tool": "cb_probe", "K": K, "Kp": P.Kp, "CB": CB, "default_cb": CB == default_cb(P.L), "B": B,
                "t": t, "chunks": ds.Lpad // CB, "segs": len(ds.tri), "range_gathers": ranges,
                "compile_s": compile_s, "C_equal": True,
                **_sweep.timed(lambda: replay(arr, D), dev, args.iters)}
        line["gbps"] = _sweep.gbps(K * args.T * B, line["ms"])
        lines.append(_sweep.emit(line, fields))
    return lines


if __name__ == "__main__":
    main()
