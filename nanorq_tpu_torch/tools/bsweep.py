"""Encode throughput against blocks per launch (counterpart of `tools/bsweep.py`).

    python -m nanorq_tpu_torch.tools.bsweep [K] [B ...] [--iters N] [--device cuda]

For the K' of K (default 10000), the encoder schedule replays a seeded
random D [M_pad, B*T] of B blocks side by side (T = 1280; default B = 4 8
16), alone ("replay") and followed by the LT combine of all K' symbols
("replay+lt"), as the JAX tool times them: eagerly (`ms`, `graph_ms`)
and through the schedule's program (`program_ms`, `ops/program.py`).  The
replay is a fixed chain of launches whatever B is, so the eager form is
launch-bound at small B; where the rate stops rising with B is the blocks
per launch the object path should feed it (the bench's object takes
max(1, 256 MiB // (K*T)) blocks).  One JSON line per
(B, stage): ms / graph_ms / program_ms, launches, Gb/s of payload (eager
and program), with the card's name and power limit.
"""

import argparse

import numpy as np
import torch

from nanorq_tpu_torch.codec.cache import encoder_schedule
from nanorq_tpu_torch.ops import program
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import _sweep


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("K", type=int, nargs="?", default=10000)
    ap.add_argument("bs", type=int, nargs="*", help="default: 4 8 16")
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=0, help="0: 8 from K = 20000, else 20 (the JAX tool's N)")
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    K, T = args.K, args.T
    iters = args.iters or (8 if K >= 20000 else 20)
    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds, dev)
    plan = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev)
    rng = np.random.default_rng(0)
    lines = []
    for B in args.bs or [4, 8, 16]:
        t = B * T
        D = torch.zeros((ds.M_pad, t), dtype=torch.uint8, device=dev)
        D[:K] = torch.from_numpy(rng.integers(0, 256, (K, t), dtype=np.uint8)).to(dev)
        calls = {"replay": (lambda: replay(arr, D), lambda: program.replay(arr, D)),
                 "replay+lt": (lambda: lt_combine(replay(arr, D), plan),
                               lambda: lt_combine(program.replay(arr, D), plan))}
        for stage, (fn, prog) in calls.items():
            line = {"tool": "bsweep", "K": K, "Kp": P.Kp, "CB": ds.CB, "B": B, "t": t, "stage": stage,
                    **_sweep.timed(fn, dev, iters, prog)}
            line["gbps"] = _sweep.gbps(K * T * B, line["ms"])
            line["graph_gbps"] = _sweep.gbps(K * T * B, line["graph_ms"])
            line["program_gbps"] = _sweep.gbps(K * T * B, line["program_ms"])
            lines.append(_sweep.emit(line, fields))
        del D
    return lines


if __name__ == "__main__":
    main()
