"""gather_db at the shapes it is judged on, and under other launch rules.

    python -m nanorq_tpu_torch.tools.gather_db_tune [--knobs] [--shapes NAME,...] [--iters N]

Shapes: `lt_class`, the widest LT class of the K = 1000 encoder over an
object (C_ext[1072, 256000], idx (566, 8)); `take_rows`, its pivot gather
(D[2048, 256000], idx (1280, 1)); and the six of the `db` table of
tools/gather_probe.py (sources of 52 MB-1.05 GB).  For each, through
the wrappers: gather_db at R = 8, 16, 32 bit-exact against the plain
version, its mean time over `--iters` launches in one CUDA graph, with
gather_v1 mode 2 and K1 beside it, the bytes bound and gather_db's share of
it.  With `--knobs`, also gather_db at R = 8 under every stage size and
sweep length of KNOBS (the library's nrq_gather_db_tuned), each bit-exact:
what decided db_plan's constants.  One JSON line per shape.  Needs a CUDA
device.

The script imports the package it finds first, so an older checkout's
gather_db is timed by running this file with that checkout on PYTHONPATH
(without --knobs, which it lacks):

    PYTHONPATH=_parent python nanorq_tpu_torch/tools/gather_db_tune.py
"""

import argparse
import json

import numpy as np
import torch

from nanorq_tpu_torch.ops import _build, gfmat, kernels
from nanorq_tpu_torch.tools import gather_probe
from nanorq_tpu_torch.tools.gather_launches import HBM_BPS, KP, WIDE
from nanorq_tpu_torch.tools.matmul_forms import graph_ms

ROWS = (8, 16, 32)
KNOBS = [(stage << 10, steps) for stage in (32, 48) for steps in (2, 4, 8, 16, 32, 64)]


def _u8(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)


def shapes(dev, rng):
    """name -> zero-argument maker of (src, idx) on the card."""
    from nanorq_tpu_torch.codec.cache import encoder_schedule
    from nanorq_tpu_torch.ops.lt import lt_plan
    from nanorq_tpu_torch.ops.replay import device_arrays
    from nanorq_tpu_torch.rfc.params import params_init

    P = params_init(KP)
    ds = encoder_schedule(P.Kp)
    widest = max(lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev).classes, key=lambda c: c.numel())
    made = {"lt_class": lambda: (_u8(rng, (P.L + 1, WIDE), dev), widest),
            "take_rows": lambda: (_u8(rng, (ds.M_pad, WIDE), dev), device_arrays(ds, dev)["piv_rows"])}
    for S, n, w, t, frac, name in gather_probe.DB_SHAPES:
        def table(S=S, n=n, w=w, t=t, frac=frac):
            src, idx = gather_probe.probe_data(rng, S, n, w, t, frac)
            return torch.from_numpy(src).to(dev), torch.from_numpy(idx).to(dev)
        made[name] = table
    return made


def _tuned(src, idx, R, stage, steps):
    """gather_db under db_plan's rule for `stage` bytes and `steps` steps a sweep."""
    out = torch.empty((idx.shape[0], src.shape[1]), dtype=torch.uint8, device=src.device)
    rc = _build.load().nrq_gather_db_tuned(src.data_ptr(), src.shape[0], src.shape[1], idx.data_ptr(),
                                           idx.shape[0], idx.shape[1], R, stage, steps, out.data_ptr(),
                                           kernels._flag(kernels._INDEX_ERR, src.device).data_ptr(),
                                           torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nrq_gather_db_tuned: cudaError {rc}")
    return out


def measure(name: str, src, idx, iters: int, knobs: bool) -> dict:
    n, w = idx.shape
    t = src.shape[1]
    want = gfmat.xor_reduce_gather(src, idx)
    calls = {f"gather_db_R{R}": (lambda R=R: kernels.gather_db(src, idx, R=R)) for R in ROWS if R * w <= 1024}
    calls["gather_v1_m2_R8"] = lambda: kernels.gather_v1(src, idx, 2)
    calls["gather_xor"] = lambda: kernels.gather_xor(src, idx)
    if knobs:
        for stage, steps in KNOBS:
            calls[f"db_stage{stage >> 10}k_steps{steps}"] = lambda a=stage, b=steps: _tuned(src, idx, 8, a, b)
    differs = [k for k, fn in calls.items() if not torch.equal(fn(), want)]
    if differs or kernels.take_index_errors(src.device):
        raise AssertionError(f"{name}: {differs or 'an index flag'} against the plain version")
    ms = {k: graph_ms(fn, iters) for k, fn in calls.items()}
    bound_ms = (int(torch.unique(idx).numel()) * t + n * t + idx.numel() * 4) / HBM_BPS * 1e3
    return {"shape": name, "S": src.shape[0], "n": n, "w": w, "t": t, "exact": True, "ms": ms,
            "bound_ms": bound_ms, "share_R8": bound_ms / ms["gather_db_R8"]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="gather-db-tune", description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None, help="comma-separated shape names (default: all)")
    ap.add_argument("--knobs", action="store_true", help="also every stage size and sweep length of KNOBS")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gather_db_tune: needs a CUDA device")
    dev = torch.device("cuda", 0)
    made = shapes(dev, np.random.default_rng(0))
    want = args.shapes.split(",") if args.shapes else list(made)
    if set(want) - set(made):
        raise SystemExit(f"unknown shapes {sorted(set(want) - set(made))}; known: {sorted(made)}")
    lines = []
    for name in want:
        src, idx = made[name]()
        lines.append(measure(name, src, idx, args.iters, args.knobs))
        print(json.dumps(lines[-1]), flush=True)
        del src, idx
        torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
