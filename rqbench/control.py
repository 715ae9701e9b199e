"""The controls of `correct`: each cell's check run with a stand-in that
breaks the configuration's guarantee (bit-exact with RFC 6330) in the
program's place, which the check has to find.

- sender, where the reference solves the block itself (`harness.solvable`):
  the plain reference (`reference/rfc6330.py`) with its GF(256) product's
  sums rounded to bfloat16 (`precision="bfloat16"`), the step a later change
  computing the products on tensor cores in a 16-bit type would take;
- sender, at a K the reference cannot solve: the precode skipped, the step a
  later change cutting the solve (most of the device time at K=50000) would
  take: the source symbols stand in for the intermediate symbols, and the
  repair symbols are their LT symbols, as a plain LT code's would be;
- receiver: a receiver that writes the source symbols it received and
  recovers none (the reference receiver without the code).

    python3 rqbench/control.py --workload <cell> --seeds 1 2 3 --seconds 10

runs set-up, a window at the cell's own load and the check once per seed, on
the card, and prints one JSON line per seed with every number compared and
its limit.  The benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def install(cell) -> None:
    """Put the controls in the cell's program's place."""
    import numpy as np
    import torch

    from rqbench import harness
    from rqbench.reference import rfc6330

    P = rfc6330.params(cell.K)
    solve = cell.role != "receive" and harness.solvable(cell.K)
    M = rfc6330.encoding_map(P, cell.n, cell.device) if solve else None
    lt = rfc6330.neighbors(P, np.arange(P.Kp, P.Kp + cell.n)) if cell.role != "receive" and not solve else None

    def encode(enc, obj, i):
        with cell.span("load", i):
            src = obj.reshape(cell.Z, cell.K, cell.T)
        with cell.span("generate", i):
            if solve:
                return rfc6330.repair_symbols(P, src, cell.n, cell.device, M, precision="bfloat16")
            C = torch.zeros((P.L, cell.Z * cell.T), dtype=torch.uint8, device=cell.device)
            C[: cell.K] = torch.from_numpy(np.ascontiguousarray(src.transpose(1, 0, 2)).reshape(cell.K, -1))
            rep = rfc6330.xor_rows(C, lt).cpu().numpy()
            return rep.reshape(cell.n, cell.Z, cell.T).transpose(1, 0, 2)

    def decode(dec, stream, payloads, out, i):
        rows = out.reshape(-1, cell.T)
        with cell.span("ingest", i):
            src = stream.rows < cell.Z * cell.K
            rows[stream.rows[src]] = payloads[src]
        return True

    cell.encode, cell.decode = encode, decode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from rqbench import harness

    if not torch.cuda.is_available():
        print("rqbench.control: torch sees no CUDA device", file=sys.stderr)
        return 2
    _, cfg, mix = harness.cell_files(harness.load_spec(ROOT), args.workload, ROOT)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.Cell(cfg, mix, seed, torch.device("cuda", 0))
        install(cell)
        cell.make_pool()
        cell.warm_up()
        cell.window(args.seconds)
        cell.release()
        checks = cell.check()
        print(json.dumps({"workload": args.workload, "seed": seed, "arm": "control",
                          "correct": cell.verdict(checks), "objects": len(cell.run.objects),
                          "seconds": time.perf_counter() - t0,
                          "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
