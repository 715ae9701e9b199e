"""Run one cell of the benchmark once and print its result line.

    python3 rqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(also `python3 -m rqbench.run ...`), from the root of a checkout that holds
nanorq_tpu_torch.  The cell's configuration, traffic mix and metrics are
found by name from BENCHMARK.json; each metric is read by
`rqbench/metrics/<name>.py`.  With `--trace 0` the line holds the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, the device's busy
time in the traced window and a breakdown of where the time went.  The
numbers compared to decide `correct` are printed with their limits as the
last lines of standard error and under "checks", the line's last key.
Before them, standard error has the host's facts (`hostinfo.Facts`: where
the process ran, its quota and throttling, a probe of the host's speed
before and after the window); none of them is a metric.

Exits with 2 and prints no result where torch sees no CUDA device or fewer
than the cell asks for, where nanorq_tpu_torch is not in this checkout, or
where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "nanorq_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def reader(name: str):
    path = ROOT / "rqbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("rqbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(spec: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"] if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def fail(msg: str) -> int:
    print(f"rqbench: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from rqbench import harness, hostinfo

    spec = harness.load_spec(ROOT)
    w, cfg, mix = harness.cell_files(spec, args.workload, ROOT)
    if not torch.cuda.is_available():
        return fail("torch sees no CUDA device: this benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < w["chips"]:
        return fail(f"{args.workload} needs {w['chips']} cards, torch sees {torch.cuda.device_count()}")
    try:
        import nanorq_tpu_torch
    except ImportError as e:
        return fail(f"the program is not here: {e}")
    if Path(nanorq_tpu_torch.__file__).resolve().parents[1] != ROOT:
        return fail(f"nanorq_tpu_torch comes from {nanorq_tpu_torch.__file__}, not from this checkout")

    facts = hostinfo.Facts()
    facts.read_static(0)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.Cell(cfg, mix, args.seed, dev, trace=bool(args.trace))
    cell.make_pool()
    torch.cuda.reset_peak_memory_stats(dev)
    cell.warm_up()
    cell.run.setup_s = time.perf_counter() - T_START
    facts.snapshot("before")
    cell.window(args.seconds)
    facts.snapshot("after")
    peak = torch.cuda.max_memory_allocated(dev)
    cell.release()
    checks = cell.check()
    bad = forbidden_modules()
    if bad:
        return fail(f"loaded in this process: {', '.join(bad)}")

    run = cell.run
    metrics = {}
    for m in metrics_for(spec, args.workload, bool(args.trace)):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": w["chips"],
              "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(run.objects), "failed": len(cell.failed_objects),
              "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        idle = sorted(run.trace.idle_by_span().items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": run.trace.top_ops(10), "idle_gaps": [[k, v] for k, v in idle]}
    for err in cell.errors:
        print(err, file=sys.stderr)
    for line in facts.report():
        print(line, file=sys.stderr)
    if run.counters.get("replay_program_capture"):  # the warm-up left a program to capture
        print(f"rqbench: {run.counters['replay_program_capture']} replay programs captured inside the window",
              file=sys.stderr)
    result["correct"] = cell.verdict(checks)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(f"rqbench: {args.workload} seed {args.seed}: {len(run.objects)} objects in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s", file=sys.stderr)
    for key in ("enc_s", "dec_s"):
        xs = sorted(o[key] for o in run.objects if key in o)
        if xs:
            q = statistics.quantiles(xs, n=20) if len(xs) > 1 else [xs[0]] * 19
            print(f"rqbench: {key} over {len(xs)} objects, ms: min {1e3 * xs[0]:.3f} median "
                  f"{1e3 * statistics.median(xs):.3f} p95 {1e3 * q[18]:.3f} max {1e3 * xs[-1]:.3f}", file=sys.stderr)
            seq = [o[key] for o in run.objects if key in o]
            tenths = [statistics.median(seq[j * len(seq) // 10:(j + 1) * len(seq) // 10] or seq) for j in range(10)]
            print(f"rqbench: {key} median ms by tenth of the window's objects: "
                  + " ".join(f"{1e3 * x:.1f}" for x in tenths), file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
