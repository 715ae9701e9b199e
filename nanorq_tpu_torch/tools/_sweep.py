"""What the retuning sweeps of this package share (`cb_probe`, `bsweep`,
`wb_probe`, `replay_stage_prof`): the device argument, the timer, and one
JSON line per point with the card's name and power limit.

On the card a point is timed two or three ways: `ms`, CUDA events around
`iters` back-to-back calls after one warm call, of the eager form (its
launches issued one by one from Python, launch overhead included);
`graph_ms`, the same calls captured in one CUDA graph (device time alone;
`tools/matmul_forms.graph_ms`); and, where the point has one, `program_ms`,
CUDA events around back-to-back calls of the program path
(`ops/program.replay`: the schedule's captured graph between the prologue's
two gathers and the epilogue's one), what a caller of the codec pays.  On
`--device cpu` the host clock stands in for `ms`, `graph_ms` and
`program_ms` are null (nothing is captured on the CPU) and the lines say
`"timing": "perf_counter"`: a rehearsal at a tiny size, no device number."""

import json
import time

from nanorq_tpu_torch.bench import device_fields
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.tools.matmul_forms import events_ms, graph_ms


def add_device(ap) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (timed on the card) or cpu (a rehearsal, host clock)")


def device(args):
    """(torch device, the fields every line carries)."""
    dev = resolve(args.device)
    return dev, device_fields(dev)


def timed(fn, dev, iters: int, program=None) -> dict:
    """ms and graph_ms of fn(), program_ms of program() where given (see the
    module's doc), and `launches`: the kernel launches of one call of fn (0
    on the CPU, where no kernel launches)."""
    before = dict(kernels.LAUNCHES)
    fn()
    launches = sum(kernels.LAUNCHES[k] - before[k] for k in before)
    if dev.type == "cuda":
        if program is not None:
            program()  # a width's first call runs eagerly; the warm call of events_ms captures
        return {"ms": events_ms(fn, iters), "graph_ms": graph_ms(fn, iters),
                "program_ms": None if program is None else events_ms(program, iters), "launches": launches}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return {"ms": (time.perf_counter() - t0) * 1e3 / iters, "graph_ms": None, "program_ms": None,
            "launches": launches}


def gbps(nbytes: int, ms: float | None) -> float | None:
    return None if not ms else 8 * nbytes / (ms * 1e-3) / 1e9


def emit(line: dict, fields: dict) -> dict:
    line = {**line, **fields}
    print(json.dumps(line), flush=True)
    return line
