"""Slot fill of the trisolve's staircase gathers under each width grid
(counterpart of `tools/slotfill_probe.py`; host only, no device).

    python -m nanorq_tpu_torch.tools.slotfill_probe [K ...]     (default: 50000)

Each chunk's dependency ranges gather [rows, w] index slots, w taken from a
width grid (`precode.device_schedule.WIDTH_GRID`, chosen by NANORQ_TRI_WQ
from `_WQ_GRIDS`: "dense", "hybrid64" -- the default --, "pow2"), so the
slots past a row's real degree, and the rows padded past a range's length,
are gathered for nothing.  For every grid the K' of each K is compiled
(`compile_device`, the encoder's layout) and its slots are counted as the
JAX tool counts them: slots, fill (real / slots), launches (chunks x ranges),
segments, the width and row-padding waste, and the slots by width.  The
grid is set for the compile and put back after it.  On the H100 a K1 gather
is not DMA-issue-bound as the TPU's was, so fill is a count here, not a
time: `replay_stage_prof` times the gathers.  One JSON line per (K, grid).
"""

import argparse
import json

from nanorq_tpu_torch.precode import device_schedule as dsmod
from nanorq_tpu_torch.precode.matrix import binary_rows
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init


def analyze(ds) -> dict:
    """The JAX tool's counts of one schedule's staircase gathers."""
    tot = used = w_waste = r_waste = launches = 0
    by_w = {}
    for seg in ds.tri:
        for _a, _b, idx in seg.ranges:
            nq, rlen, w = idx.shape
            pad = 8 if rlen <= 8 else (16 if rlen <= 16 else -(-rlen // 32) * 32)
            tot += nq * pad * w
            real = (idx != ds.Lpad).sum(axis=2)
            used += int(real.sum())
            w_waste += int((w - real).sum())
            r_waste += nq * (pad - rlen) * w
            launches += nq
            by_w[w] = by_w.get(w, 0) + nq * pad * w
    return {"slots": tot, "fill": used / tot if tot else None, "launches": launches, "segs": len(ds.tri),
            "width_waste": w_waste / tot if tot else None, "rowpad_waste": r_waste / tot if tot else None,
            "slots_by_width": {str(w): n for w, n in sorted(by_w.items())}}


def sweep(K: int, grids=None) -> list:
    """One line per grid (default: every grid of `_WQ_GRIDS`) for the K' of K."""
    P = params_init(K)
    st = solve_state(P, binary_rows(P))
    lines, saved = [], dsmod.WIDTH_GRID
    try:
        for name in grids or list(dsmod._WQ_GRIDS):
            dsmod.WIDTH_GRID = tuple(dsmod._WQ_GRIDS[name])
            lines.append({"tool": "slotfill_probe", "K": K, "Kp": P.Kp, "grid": name,
                          "default": dsmod._WQ_GRIDS[name] == saved, **analyze(dsmod.compile_device(st))})
    finally:
        dsmod.WIDTH_GRID = saved
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", type=int, nargs="*", help="default: 50000")
    args = ap.parse_args(argv)
    lines = [line for K in args.ks or [50000] for line in sweep(K)]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
