"""Gather probe driver: the three probe kernels, K1 and the plain version.

    python -m nanorq_tpu_torch.tools.gather_probe [--shapes NAME,...] [--tables v2,db] [--device cuda]

The port of tools/gather_v2_probe.py and tools/gather_db_probe.py: their
shape tables and their data (one `default_rng(0)` per table, uniform random
source rows with the last row S-1 zeroed as the sentinel, uniform indices
below S-1 of which the table's fraction is replaced by the sentinel).  For
each shape it runs, at R = 8, 16 and 32 rows per block where R*w fits,
gather_v1 in its three wait modes, gather_v2 (sentinel S-1, host counts),
gather_db; then K1 (gather_xor) and the plain torch version.  Every result
must equal the plain version bit for bit.  Times are means over ITERS
launches captured in one CUDA graph, after one warm-up: device time (a
Python loop between CUDA events reads the wrappers' launch overhead, 25-55
us, at the shapes that take less).  The third table, `main`, is not run by
default: the four gathers a K = 1000 encode takes at one block's width
(t = 1280), with uniform indices.  One JSON line per shape goes to
stdout (gathered_mb / ms / 1e3 is the gathered rate in GB/s), with
`bound_ms`, the least time the shape's bytes take at the H100 data sheet's
3.35 TB/s (each distinct source row read once, the output written once, the
indices read once), each variant's `share` of it (bound_ms / ms), and, at
width 1, `index_select_ms`: one torch.index_select of the same rows, timed
the same way.  Needs a CUDA device (`--device cpu` runs the plain versions
only and times nothing).
"""

import argparse
import json

import numpy as np
import torch

from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import gfmat, kernels
from nanorq_tpu_torch.tools.gather_launches import HBM_BPS
from nanorq_tpu_torch.tools.matmul_forms import graph_ms

# (S, n, w, t, sentinel fraction, name): gather_v2_probe.py's SHAPES
V2_SHAPES = [
    (10241, 512, 8, 20480, 0.35, "K1e4-chunk"),
    (52225, 1024, 8, 5120, 0.35, "K5e4-chunk"),
    (1025, 1024, 8, 40960, 0.30, "K1e3-LT"),
    (10241, 512, 16, 20480, 0.45, "K1e4-ov16"),
]
# gather_db_probe.py's SHAPES, all at its fraction 0.35 (the 1 GB sources
# exceed the card's 50 MB L2 twenty times over)
DB_SHAPES = [
    (51201, 1024, 4, 20480, 0.35, "K5e4-B16-w4"),
    (51201, 1024, 8, 20480, 0.35, "K5e4-B16-w8"),
    (51201, 1024, 4, 10240, 0.35, "K5e4-B8-w4"),
    (51201, 1024, 4, 5120, 0.35, "K5e4-B4-w4"),
    (10241, 512, 8, 20480, 0.35, "K1e4-B16-w8"),
    (10241, 512, 8, 5120, 0.35, "K1e4-B4-w8"),
]
# take_rows, a trisolve range, a bsel pass and the widest LT class of the K = 1000 encoder at t = 1280
MAIN_SHAPES = [
    (2048, 1280, 1, 1280, 0.0, "take_rows-1280"),
    (1408, 146, 4, 1280, 0.0, "trisolve-1280"),
    (1408, 128, 8, 1280, 0.0, "bsel-1280"),
    (1072, 566, 8, 1280, 0.0, "lt_class-1280"),
]
TABLES = {"v2": V2_SHAPES, "db": DB_SHAPES, "main": MAIN_SHAPES}
DEFAULT_TABLES = ("v2", "db")
ROWS = (8, 16, 32)
ITERS = 20  # timed launches per variant, as gather_db_probe.py's N


def probe_data(rng: np.random.Generator, S: int, n: int, w: int, t: int, frac: float):
    """(src uint8 [S, t], idx int32 [n, w]) by the probes' recipe."""
    src = rng.integers(0, 256, (S, t), dtype=np.uint8)
    src[S - 1] = 0
    idx = rng.integers(0, S - 1, (n, w)).astype(np.int32)
    idx[rng.random((n, w)) < frac] = S - 1
    return src, idx


def variants(src: torch.Tensor, idx: torch.Tensor, sentinel: int) -> dict:
    """name -> zero-argument call: every probe kernel at every R that fits,
    then K1 and the plain version ("plain", last)."""
    w = idx.shape[1]
    calls = {}
    for R in ROWS:
        if R * w > kernels._PROBE_MAX_SLOTS:
            continue
        cnt = kernels.probe_counts(idx, sentinel, R)
        for mode in (0, 1, 2):
            calls[f"gather_v1_m{mode}_R{R}"] = lambda R=R, mode=mode: kernels.gather_v1(src, idx, mode, R=R)
        calls[f"gather_v2_R{R}"] = lambda R=R, cnt=cnt: kernels.gather_v2(src, idx, cnt, sentinel, R=R)
        calls[f"gather_db_R{R}"] = lambda R=R: kernels.gather_db(src, idx, R=R)
    calls["gather_xor"] = lambda: kernels.gather_xor(src, idx)
    calls["plain"] = lambda: gfmat.xor_reduce_gather(src, idx)
    return calls


def run_shape(table: str, shape: tuple, rng: np.random.Generator, device) -> dict:
    """One shape: every variant against the plain version, timed on CUDA."""
    S, n, w, t, frac, name = shape
    dev = resolve(device)
    src_np, idx_np = probe_data(rng, S, n, w, t, frac)
    src = torch.from_numpy(src_np).to(dev)
    idx = torch.from_numpy(idx_np).to(dev)
    del src_np
    calls = variants(src, idx, S - 1)
    want = calls["plain"]()
    exact = {}
    for vname, fn in calls.items():
        got = fn()
        exact[vname] = bool(torch.equal(got, want))
    ms, select_ms = {}, None
    if dev.type == "cuda":
        if kernels.take_index_errors(dev) or kernels.take_count_errors(dev):
            raise AssertionError(f"{name}: a probe kernel flagged an index or a count")
        ms = {vname: graph_ms(fn, ITERS) for vname, fn in calls.items()}
        if w == 1:
            col = idx[:, 0].contiguous()
            select_ms = graph_ms(lambda: torch.index_select(src, 0, col), ITERS)
    bound_ms = (int(torch.unique(idx).numel()) * t + n * t + idx.numel() * 4) / HBM_BPS * 1e3
    line = {"table": table, "shape": name, "S": S, "n": n, "w": w, "t": t, "sentinel_frac": frac,
            "src_mb": S * t / 1e6, "gathered_mb": n * w * t / 1e6, "exact": all(exact.values()), "ms": ms,
            "bound_ms": bound_ms, "share": {k: bound_ms / v for k, v in ms.items()},
            "index_select_ms": select_ms}
    if not line["exact"]:
        line["differs"] = [k for k, ok in exact.items() if not ok]
    return line


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="gather-probe", description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None, help="comma-separated shape names (default: all)")
    ap.add_argument("--tables", default=",".join(DEFAULT_TABLES), help=f"of {','.join(TABLES)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    tables = args.tables.split(",")
    if set(tables) - set(TABLES):
        raise SystemExit(f"unknown tables {sorted(set(tables) - set(TABLES))}; known: {sorted(TABLES)}")
    want = set(args.shapes.split(",")) if args.shapes else None
    known = {sh[-1] for table in tables for sh in TABLES[table]}
    if want and want - known:
        raise SystemExit(f"unknown shapes {sorted(want - known)}; known: {sorted(known)}")
    lines = []
    for table in tables:
        rng = np.random.default_rng(0)  # each probe script starts its own generator
        for shape in TABLES[table]:
            if want and shape[-1] not in want:
                continue
            line = run_shape(table, shape, rng, dev)
            print(json.dumps(line), flush=True)
            lines.append(line)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if not all(line["exact"] for line in lines):
        raise SystemExit("gather_probe: a kernel differs from the plain version")
    return lines


if __name__ == "__main__":
    main()
