"""Dense-W decode against blocks per batch, and the canonical decode layout
against the pattern's own (counterpart of `tools/wb_probe.py`).

    python -m nanorq_tpu_torch.tools.wb_probe [K ...] [--bs B ...] [--iters N] [--cold N] [--device cuda]

At each K (default 5000 and 10000), T = 1280, 6% source loss and 5%
overhead (the JAX tool's pattern, seed 0), on real payloads: a seeded
object encoded by the port, its repair symbols in the gap and overhead
slots.  For each B (default 4 8 16 32) one JSON line per form, each held
bit for bit against the dropped source rows:

- "W": the pattern's dense-W plan (`codec.cache.decoder_plan`, a WSchedule)
  applied to B blocks side by side, the JAX tool's measure;
- "W_stacked": B blocks, each with a pattern of its own, stacked as the
  decoder's batches stack them (`ops.wpath.w_apply_gf2_batch`; the decoder
  flushes `Decoder._BATCH_FLUSH` blocks a batch);
- "canonical" and "own": the structured replay + gap LT the decoder runs
  above `cache.WPATH_MAX_KP`, compiled against the K's frozen canonical
  layout (`compile_device(st, canonical=True)`, after the patterns that
  freeze it) and against the pattern's own layout (`canonical=False`).  The
  canonical layouts exist to share compiled XLA programs between patterns;
  eager CUDA compiles nothing per shape.  `slots` counts the trisolve's
  gather slots of each (`slotfill_probe.analyze`).

Each line: ms / graph_ms, launches, Gb/s of the B blocks' payload, with the
card's name and power limit.

Cold patterns (`--cold N`; by default 6 at a K above `cache.WPATH_MAX_KP`,
where the decoder takes the structured plan, and none below): the K's
layout frozen by _FREEZE_AFTER + 1 patterns, then N fresh patterns, each
met once as a receiver meets it, one block (t = T), random live rows.  Per
pattern one line per form, each one call timed alone (CUDA events around
it) and its C held bit for bit against the others': "canonical" (the
canonical schedule through the program of its signature,
`ops/program.replay`: eager at a signature's first call, the capture at its
second, the shared program after; its `route`), "canonical_eager" and
"own_eager" (the pattern's own layout, `canonical=False`, whose signature no
other pattern shares), each with the LT combine of the gap rows.  To time
an older checkout's replay of the same patterns, run this file on it
(`PYTHONPATH=<its root> python nanorq_tpu_torch/tools/wb_probe.py 50000`).
"""

import argparse
import time

import numpy as np
import torch

from nanorq_tpu_torch.codec import cache
from nanorq_tpu_torch.ops import program, wpath
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays, replay
from nanorq_tpu_torch.precode.device_schedule import _FREEZE_AFTER, compile_device
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import _sweep
from nanorq_tpu_torch.tools.slotfill_probe import analyze
from nanorq_tpu_torch.utils import stats


def pattern(K: int, seed: int):
    """(gaps, isis, overhead) of a 6% loss + 5% overhead pattern."""
    P = params_init(K)
    rng = np.random.default_rng(seed)
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    ov = max(1, int(0.05 * K))
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (np.arange(K, K + gaps.size + ov) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp :] = rep[gaps.size :]
    return gaps, isis, ov


def _check(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: recovered rows differ from the dropped source rows")


def probe_k(K: int, bs: list, T: int, iters: int, dev, fields) -> list:
    P = params_init(K)
    Bmax = max(bs)
    rng = np.random.default_rng(0)
    ds_enc = cache.encoder_schedule(P.Kp)
    src = torch.zeros((ds_enc.M_pad, Bmax * T), dtype=torch.uint8, device=dev)
    src[:K] = torch.from_numpy(rng.integers(0, 256, (K, Bmax * T), dtype=np.uint8)).to(dev)
    pats = [pattern(K, s) for s in range(Bmax)]
    nrep = max(g.size for g, _, _ in pats) + pats[0][2]
    reps = lt_combine(replay(device_arrays(ds_enc, dev), src), lt_plan(np.arange(P.Kp, P.Kp + nrep, dtype=np.uint32), P, dev))
    plans = [cache.decoder_plan(P, isis, ov) for _, isis, ov in pats]
    if not all(isinstance(p, cache.WSchedule) and p.Wbits is not None for p in plans):
        raise AssertionError(f"K={K}: the probe expects GF(2) dense-W plans")
    M_pad = plans[0].M_pad

    def payload(gaps, ov, cols) -> torch.Tensor:
        """The decode payload [M_pad, width of cols] of a pattern."""
        D = torch.zeros((M_pad, cols.stop - cols.start), dtype=torch.uint8, device=dev)
        D[:K] = src[:K, cols]
        D[torch.from_numpy(gaps).to(dev)] = reps[: gaps.size, cols]
        D[P.Kp : P.Kp + ov] = reps[gaps.size : gaps.size + ov, cols]
        return D

    gaps0, isis0, ov0 = pats[0]
    g0 = torch.from_numpy(gaps0).to(dev)
    # the structured plans of pattern 0: the canonical layout once frozen, and its own
    for _g, isis, ov in (pattern(K, 1000 + s) for s in range(_FREEZE_AFTER + 1)):
        compile_device(solve_state(P, cache._patched_rows(P, isis, ov), ov), canonical=True)
    st0 = solve_state(P, cache._patched_rows(P, isis0, ov0), ov0)
    structured = {name: compile_device(st0, canonical=c) for name, c in (("canonical", True), ("own", False))}
    gap_plan = lt_plan(gaps0.astype(np.uint32), P, dev)
    lines = []
    for B in bs:
        t = B * T
        D0 = payload(gaps0, ov0, slice(0, t))
        want0 = src[g0, :t]
        forms = {"W": (lambda: plans[0].apply(D0), lambda out: _check(out[: gaps0.size], want0, "W"), {})}
        Dst = torch.stack([payload(g, ov, slice(j * T, (j + 1) * T)) for j, (g, _, ov) in enumerate(pats[:B])])
        bits, rows = wpath.w_stack_gf2(plans[:B])
        bits, rows = torch.from_numpy(bits).to(dev), torch.from_numpy(rows[..., None]).to(dev)

        def stacked_ok(out, B=B):
            for j, (g, _, _) in enumerate(pats[:B]):
                _check(out[j, : g.size], src[torch.from_numpy(g).to(dev), j * T : (j + 1) * T], f"W_stacked block {j}")

        forms["W_stacked"] = (lambda: wpath.w_apply_gf2_batch(bits, rows, Dst), stacked_ok, {})
        for name, ds in structured.items():
            arr = device_arrays(ds, dev)
            forms[name] = (lambda arr=arr: lt_combine(replay(arr, D0), gap_plan),
                           lambda out, name=name: _check(out[: gaps0.size], want0, name),
                           {"slots": analyze(ds)["slots"], "chunks": ds.Lpad // ds.CB})
        for form, (fn, check, extra) in forms.items():
            check(fn())
            line = {"tool": "wb_probe", "K": K, "Kp": P.Kp, "B": B, "t": t, "form": form, "exact": True,
                    **extra, **_sweep.timed(fn, dev, iters)}
            line["gbps"] = _sweep.gbps(K * T * B, line["ms"])
            lines.append(_sweep.emit(line, fields))
        del D0, Dst
    return lines


def _once_ms(fn, dev) -> tuple:
    """(fn(), the ms of that one call): CUDA events around it on a card,
    the host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize(dev)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize(dev)
    return out, t0.elapsed_time(t1)


def cold_k(K: int, n: int, T: int, dev, fields) -> list:
    """The structured forms on n cold patterns (see the module's doc)."""
    P = params_init(K)
    for _g, isis, ov in (pattern(K, 1000 + s) for s in range(_FREEZE_AFTER + 1)):
        compile_device(solve_state(P, cache._patched_rows(P, isis, ov), ov), canonical=True)
    lines, out = [], []
    for s in range(n):
        gaps, isis, ov = pattern(K, 2000 + s)
        st = solve_state(P, cache._patched_rows(P, isis, ov), ov)
        schedules = {"canonical": compile_device(st, canonical=True), "own": compile_device(st, canonical=False)}
        plan = lt_plan(gaps.astype(np.uint32), P, dev)
        got = {}
        for form, ds, run in (("canonical", schedules["canonical"], program.replay),
                              ("canonical_eager", schedules["canonical"], replay), ("own_eager", schedules["own"], replay)):
            arr = device_arrays(ds, dev)
            D = torch.zeros((ds.M_pad, T), dtype=torch.uint8, device=dev)
            D[: P.Kp + ov] = torch.from_numpy(np.random.default_rng(2000 + s).integers(
                0, 256, (P.Kp + ov, T), dtype=np.uint8)).to(dev)
            D[K : P.Kp] = 0
            c0 = stats.snapshot()["counters"]
            got[form], ms = _once_ms(lambda: lt_combine(run(arr, D), plan)[: gaps.size], dev)
            line = {"tool": "wb_probe", "K": K, "Kp": P.Kp, "B": 1, "t": T, "form": form, "pattern": s,
                    "ms": ms, "gbps": _sweep.gbps(K * T, ms), "slots": analyze(ds)["slots"],
                    "chunks": ds.Lpad // ds.CB, "sig": arr.get("sig")}  # null on a package without signatures
            if form == "canonical":
                c1 = stats.snapshot()["counters"]
                d = {k: c1.get(k, 0) - c0.get(k, 0) for k in ("replay_program_capture", "replay_program_replay")}
                line["route"] = ("capture" if d["replay_program_capture"] else
                                 "program" if d["replay_program_replay"] else "eager")
            lines.append(line)
        exact = torch.equal(got["canonical"], got["canonical_eager"]) and torch.equal(got["canonical"], got["own_eager"])
        if not exact:
            raise AssertionError(f"K={K} pattern {s}: the forms' recovered rows differ")
        for line in lines[-3:]:
            line["exact"] = True
            out.append(_sweep.emit(line, {**fields, "timing": "events" if dev.type == "cuda" else "perf_counter"}))
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", type=int, nargs="*", help="default: 5000 10000")
    ap.add_argument("--bs", type=int, nargs="*", default=[4, 8, 16, 32])
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--cold", type=int, default=None, metavar="N",
                    help="cold patterns through the structured forms (default: 6 above cache.WPATH_MAX_KP, else 0)")
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    lines = []
    for K in args.ks or [5000, 10000]:
        cold = args.cold if args.cold is not None else (6 if params_init(K).Kp > cache.WPATH_MAX_KP else 0)
        lines += cold_k(K, cold, args.T, dev, fields) if cold else probe_k(K, args.bs, args.T, args.iters, dev, fields)
    return lines


if __name__ == "__main__":
    main()
