"""Where a cold decode block's time goes: its host prep and its device steps
(counterpart of `tools/decprep_prof.py`).

    python -m nanorq_tpu_torch.tools.decprep_prof [K ...] [--patterns N] [--T T] [--structured] [--device cuda]

At each K (default 1000 5000 10000 50000), 6% source loss and 5% overhead
(the JAX tool's patterns: seed 99 warms the per-K' caches, seeds 7000 +
s are timed), each pattern met once, as a receiver meets it: a fresh
Decoder of one block of K symbols is fed the received source symbols and
the repair symbols (random payloads: nothing is decoded) and its ingestion
timed (`ingest_ms`, outside the host prep and the device steps; the
decoder's ingestion slab is pinned on a card).  The host prep, timed as
`codec.cache.decoder_plan` runs it: `rows` (the patched rows), `solve` (the
factorization) and `plan` (the dense-W rows, or the canonical device
schedule of the structured path).  Where the plan is a
structured one (above `cache.WPATH_MAX_KP`, or at any K with
`--structured`), the device steps of one block of T bytes a symbol, each
by the host clock between two synchronisations (what the step adds to a
block's wall when nothing overlaps it): `arrays` (the schedule's packed
arrays built and uploaded, `ops/replay.device_arrays`), `lt_plan` (the gap
ISIs' LT plan), `stage` (the block's patched matrix built on the card as
the decoder builds it, `Decoder._repair_parts` + `parallel/mesh.assemble`:
its ingestion matrix uploaded from pinned memory, its repair rows through
one pinned staging copy, placed by one K1), `copy_in` (the packed arrays into the
slot of the signature's program; null where no program is cached and the
replay runs eagerly), `replay` (`ops/program.replay` after the copy-in:
its prologue, one graph launch and its epilogue; or the eager replay),
`lt` (the LT combine of the gap rows) and `fetch` (their download into
pinned memory).  Before the timed patterns, _FREEZE_AFTER + 8 patterns
walk the structured path (host and device), so that the canonical layout
has frozen and its signature's program is captured, as in a decoder's
steady state.

One JSON line per K: per column its least ms over the patterns (`ms`) and
every pattern's (`ms_all`), the replay's `route` per pattern ("program" or
"eager"), `host_ms` and `device_ms` (sums of the least), `ingest_ms` (the
least) and `ingest_ms_all`, and the card's name and power limit.  On `--device cpu` the host clock and the eager
replay stand in: a rehearsal at a tiny size, no device number.
"""

import argparse
import time

import numpy as np
import torch

from nanorq_tpu_torch.codec import cache as cc
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.ops import program, wpath
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.replay import device_arrays
from nanorq_tpu_torch.parallel import mesh as lanes
from nanorq_tpu_torch.precode.device_schedule import _FREEZE_AFTER, _pad_rows, compile_device
from nanorq_tpu_torch.precode.matrix import lt_rows_csr
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.tools import _sweep

HOST = ("rows", "solve", "plan")
DEVICE = ("arrays", "lt_plan", "stage", "copy_in", "replay", "lt", "fetch")


def pattern(P, K: int, seed: int):
    """(gaps, isis, overhead) of a 6% loss + 5% overhead pattern (the JAX tool's)."""
    rng = np.random.default_rng(seed)
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    ov = max(1, int(0.05 * K))
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (np.arange(K, K + gaps.size + ov) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp:] = rep[gaps.size:]
    return gaps, isis, ov


def _plan(P, st, gaps: np.ndarray, structured: bool):
    """The plan `cache.decoder_plan` builds for st (its path selection), or
    the canonical schedule when `structured`."""
    if not structured and P.Kp <= cc.WPATH_MAX_KP and not st.hdpc_used:
        M_pad = _pad_rows(st.M + 1)
        return wpath.w_rows_gf2(st, lt_rows_csr(gaps.astype(np.uint32), P), zero_row=M_pad - 1)
    if not structured and st.hdpc_used and P.Kp <= cc.WPATH_GF256_MAX_KP:
        M_pad = _pad_rows(st.M + 1)
        return wpath.w_rows(st, lt_rows_csr(gaps.astype(np.uint32), P), n_cols=M_pad)
    return compile_device(st, canonical=True)


def prof_k(K: int, n: int, T: int, structured: bool, dev, fields) -> dict:
    P = params_init(K)
    cuda = dev.type == "cuda"
    lane = lanes.local_mesh(dev).lanes[0]
    data = np.random.default_rng(K).integers(0, 256, (K + K // 5 + max(1, int(0.05 * K)) + 1, T), dtype=np.uint8)
    enc = Encoder(K * T, T, Al=min(8, T & -T), Z=1, device="cpu")  # one block of K symbols: the OTI
    if enc.block_symbols(0) != K:
        raise ValueError(f"K={K} T={T}: not one block of K symbols")

    def wall(fn):
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    def ingest(gaps: np.ndarray, ov: int) -> tuple:
        """A fresh decoder fed the pattern's symbols: (decoder, ms)."""
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        keep = np.setdiff1d(np.arange(K), gaps)
        rep = np.arange(K, K + gaps.size + ov)
        io = MemoryIO(np.zeros(K * T, np.uint8))
        src, reps = data[keep], data[K : K + rep.size]
        src_tags, rep_tags = [make_tag(0, int(e)) for e in keep], [make_tag(0, int(e)) for e in rep]
        t0 = time.perf_counter()
        dec.add_symbols(src, src_tags, io)
        dec.add_symbols(reps, rep_tags, io)
        return dec, 1e3 * (time.perf_counter() - t0)

    def block(seed: int) -> tuple:
        gaps, isis, ov = pattern(P, K, seed)
        dec, ingest_ms = ingest(gaps, ov)
        ms = {}
        rows, ms["rows"] = wall(lambda: cc._patched_rows(P, isis, ov))
        st, ms["solve"] = wall(lambda: solve_state(P, rows, ov))
        if st is None:
            raise AssertionError(f"K={K}: pattern {seed} did not solve")
        ds, ms["plan"] = wall(lambda: _plan(P, st, gaps, structured))
        if not hasattr(ds, "tri"):  # a dense-W plan: no structured device steps
            return ms, None, ingest_ms
        arr, ms["arrays"] = wall(lambda: device_arrays(ds, dev))
        plan, ms["lt_plan"] = wall(lambda: lt_plan(gaps.astype(np.uint32), P, dev))
        D, ms["stage"] = wall(lambda: lanes.assemble(lane, (1, ds.M_pad, T),
                                                     *dec._repair_parts([(0, gaps, ov)], ds.M_pad))[0])
        prog = program.lookup(arr, T, torch.cuda.current_stream(dev).cuda_stream) if cuda else None
        ms["copy_in"] = wall(lambda: program._copy_in(prog, arr))[1] if prog is not None else None
        C, ms["replay"] = wall(lambda: program.replay(arr, D))
        S, ms["lt"] = wall(lambda: lt_combine(C, plan)[: gaps.size])
        _, ms["fetch"] = wall(lambda: lanes.fetch([(lane, S)]))
        return ms, "program" if prog is not None else "eager", ingest_ms

    block(99)  # the per-K' caches (rows base, tables), the native library
    if structured or P.Kp > cc.WPATH_MAX_KP:
        for s in range(_FREEZE_AFTER + 8):  # the layout frozen, its signature's program captured
            block(31000 + s)
    runs = [block(7000 + s) for s in range(n)]
    cols = HOST + (DEVICE if runs[0][1] is not None else ())
    ms_all = {c: [r[c] for r, _, _ in runs] for c in cols}
    least = {c: min((x for x in v if x is not None), default=None) for c, v in ms_all.items()}
    line = {"tool": "decprep_prof", "K": K, "Kp": P.Kp, "T": T, "patterns": n,
            "plan": "structured" if runs[0][1] is not None else "dense-W",
            "route": [route for _, route, _ in runs], "ms": least, "ms_all": ms_all,
            "ingest_ms": min(i for _, _, i in runs), "ingest_ms_all": [i for _, _, i in runs],
            "host_ms": sum(least[c] for c in HOST),
            "device_ms": sum(least[c] or 0.0 for c in DEVICE) if runs[0][1] is not None else None,
            "timing": "perf_counter"}
    return _sweep.emit(line, fields)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", type=int, nargs="*", help="default: 1000 5000 10000 50000")
    ap.add_argument("--patterns", type=int, default=5, help="fresh patterns timed at each K")
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--structured", action="store_true", help="the structured plan at every K")
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    fields = {k: v for k, v in fields.items() if k != "timing"}
    return [prof_k(K, args.patterns, args.T, args.structured, dev, fields)
            for K in args.ks or [1000, 5000, 10000, 50000]]


if __name__ == "__main__":
    main()
