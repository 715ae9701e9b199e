"""Per-stage times of the structured replay (counterpart of
`tools/replay_stage_prof.py`).

    python -m nanorq_tpu_torch.tools.replay_stage_prof [K] [B] [iters] [--device cuda]

The encoder schedule of the K' of K (default 10000) on a seeded random D
[M_pad, B*T] (B default 4, T = 1280), each stage of `ops/replay.replay` on
its own, on buffers kept across calls (the values a stage reads do not
change its time; called once each in the replay's order, from `stages`'s
start, they compute the replay's C):

  full        the whole replay
  take_rows   stage 1's row gather y = D[piv_rows]
  tri         one whole trisolve (`_trisolve`)
  tri_gather  only its staircase range gathers (K1), chunk by chunk
  tri_matmul  only its chunk-inverse products (K2)
  bsel        stage 2's B_sel plan, XORed into the sel rows: its passes and
              its overflow classes composed with their placements (K1)
  hdpc        the HDPC product and its placed gather (K3, K1)
  vinv        stage 3, Vinv (K3)
  wut         stage 4, Wut (K2)
  mid         bsel, hdpc, vinv and wut in turn
  out_sel     stage 5's output gather
  lt          the LT combine of all K' symbols

A first line gives the schedule (CB, chunks, segments, the ranges' fill).
Then one JSON line per stage: ms / graph_ms, launches, Gb/s-equivalent of
the B blocks' payload, with the card's name and power limit; the line of
`full` also has `program_ms`, the replay through the schedule's program
(`ops/program.py`), null on every other stage.
"""

import argparse

import numpy as np
import torch

from nanorq_tpu_torch.codec.cache import encoder_schedule
from nanorq_tpu_torch.ops import program
from nanorq_tpu_torch.ops.kernels import gather_xor, gf2_matmul, gf256_matmul
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import _trisolve, apply_plan, device_arrays, replay, take_rows
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import _sweep


def stages(arr: dict, D: torch.Tensor, plan_all) -> dict:
    """name -> a call of that stage alone, on buffers made here once: D's
    pivot and sel rows gathered, the trisolve run (stage 1)."""
    Lpad, u_pad, CB = arr["Lpad"], arr["u_pad"], arr["CB"]
    t = D.shape[1]
    y = take_rows(D, arr["piv_rows"])
    z = torch.zeros((Lpad + u_pad, t), dtype=torch.uint8, device=D.device)
    t1, xu = z[:Lpad], z[Lpad:]
    _trisolve(arr, y.clone(), t1)
    zsel = take_rows(D, arr["sel_rows"])
    C = replay(arr, D)

    def tri_gather():
        for seg in arr["tri"]:
            for qi in range(seg["tinv"].shape[0]):
                q = seg["q0"] + qi
                for a, b, ix in seg["ranges"]:
                    gather_xor(t1, ix[qi], out=y[q * CB + a : q * CB + b], zero_index=Lpad)

    def tri_matmul():
        for seg in arr["tri"]:
            for qi in range(seg["tinv"].shape[0]):
                q = seg["q0"] + qi
                gf2_matmul(seg["tinv"][qi], y[q * CB : (q + 1) * CB], out=t1[q * CB : (q + 1) * CB])

    def bsel():
        apply_plan(t1, arr["bsel_passes"], arr["bsel_placed"], zsel, Lpad)

    hd = arr.get("mhd")

    def hdpc():
        if hd is not None and hd.numel():
            ix, rows = arr["hd_placed"]
            gather_xor(gf256_matmul(hd, t1[: hd.shape[1]]), ix, out=zsel, rows=rows, zero_index=hd.shape[0])

    def vinv():
        gf256_matmul(arr["vinv"], zsel, out=xu)

    def wut():
        if arr["wut"].numel() and arr["wut_k"]:
            gf2_matmul(arr["wut"], xu[: arr["wut_k"]], out=t1[: arr["wut"].shape[0]])

    def mid():
        bsel()
        hdpc()
        vinv()
        wut()

    return {"full": lambda: replay(arr, D), "take_rows": lambda: take_rows(D, arr["piv_rows"]),
            "tri": lambda: _trisolve(arr, y, t1), "tri_gather": tri_gather, "tri_matmul": tri_matmul,
            "bsel": bsel, "hdpc": hdpc, "vinv": vinv, "wut": wut, "mid": mid,
            "out_sel": lambda: take_rows(z, arr["out_sel"]), "lt": lambda: lt_combine(C, plan_all)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("K", type=int, nargs="?", default=10000)
    ap.add_argument("B", type=int, nargs="?", default=4)
    ap.add_argument("iters", type=int, nargs="?", default=8)
    ap.add_argument("--T", type=int, default=1280)
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    K, B, T = args.K, args.B, args.T
    t = B * T
    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    arr = device_arrays(ds, dev)
    D = torch.zeros((ds.M_pad, t), dtype=torch.uint8, device=dev)
    D[:K] = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (K, t), dtype=np.uint8)).to(dev)
    deps = sum(int((ix < ds.Lpad).sum()) for seg in ds.tri for _, _, ix in seg.ranges)
    slots = sum(ix.size for seg in ds.tri for _, _, ix in seg.ranges)
    head = {"tool": "replay_stage_prof", "K": K, "Kp": P.Kp, "L": P.L, "Lpad": ds.Lpad, "CB": ds.CB, "B": B,
            "t": t, "chunks": ds.Lpad // ds.CB, "segs": len(ds.tri), "range_fill": deps / max(1, slots)}
    lines = [_sweep.emit(head, fields)]
    plan_all = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev)
    full_program = lambda: program.replay(arr, D)  # noqa: E731
    for name, fn in stages(arr, D, plan_all).items():
        line = {"tool": "replay_stage_prof", "K": K, "B": B, "stage": name,
                **_sweep.timed(fn, dev, args.iters, full_program if name == "full" else None)}
        line["gbps_eq"] = _sweep.gbps(K * T * B, line["ms"])
        lines.append(_sweep.emit(line, fields))
    return lines


if __name__ == "__main__":
    main()
