"""Benchmark of the port, mirroring the reference's benchmark.c semantics.

    python -m nanorq_tpu_torch.bench [--ks K ...] [--iters N] [--arms] [--mesh N] [--deadline S] [--device cuda]

The counterpart of the JAX package's `bench.py`, with its function names and
JSON keys.  Reference harness (benchmark.c): an in-memory random object of
K*T bytes, four configs -- encode (fresh schedule), precalc encode (schedule
reused), decode at 0% loss, decode at 6% loss + 5% repair overhead -- each
normalized to 256 MiB processed, in Mb/s (BASELINE.md; `REF_BASELINE`).

The schedule solve runs on the host once per (K', pattern) and is cached, so
every encode is a "precalc" encode; the fresh solve is reported apart
(`solve_ms`, `fresh_ms`, after one warm-up solve).  A batch is `blocks`
independent blocks side by side: the reference's 256 MiB object,
max(1, 256 MiB // (K*T)) blocks, at most Z_MAX (`--blocks` overrides).

Cells per K:
- encode_replay  intermediate symbols only, data on the device: the encoder
                 schedule's program on a card (`ops.program.replay`: one
                 captured CUDA graph between two gathers and one after),
                 eagerly on the CPU; every replay below takes the same route
- encode         replay + LT combine of all K' symbols, data on the device
- encode_e2e     the same object through `codec.batch.generate` and
                 `repair_symbols` (K // 5 repair symbols a block) from host
                 memory to host memory: with the upload of D and the download
                 of the repair symbols.  `encode` and `encode_e2e` are the
                 pair "without and with the copies".  The object's matrix is
                 held as `codec.batch.load_object` holds it
                 (`parallel.mesh.host_matrix`: pinned on a card)
- encode_fresh   a cold encoder on a 256 MiB object: fresh_ms + its
                 batches, the first at a warm eager encode's cost, the
                 program's capture (`capture_ms`) where the object holds two
                 whole batches of this width, the rest at `encode`'s
- decode0        0% loss: batched ingestion + no-op repair through Decoder
- decode         6% loss + 5% overhead, the warm plan of one pattern applied
                 to the whole batch on the device (`dec_plan`: "W", the dense
                 combination matmul, or "structured", replay + gap LT,
                 whichever `codec.cache.decoder_plan` gives), gated on byte
                 equality of the recovered symbols
- decode_e2e     6% loss + 5% overhead, a FRESH pattern per block through
                 `Decoder.repair_all`, every decoder memo cleared each round
                 (the reference's decode-oh5 column, invert included); with
                 `--arms` (and always at K = 1000 and 50000) one reading per
                 backend (`e2e_device`, `e2e_res`, `e2e_res_host`,
                 `e2e_host`), interleaved round-robin, and `e2e_auto_ok`:
                 whether "auto" came within 10% of the best of them
- decode_e2e warm, with `--arms`: the same object and patterns, every arm
                 and "auto" again with the plans and memos kept from the
                 round before (a first untimed round fills them):
                 `e2e_<arm>_warm`, `e2e_auto_warm` and `e2e_auto_warm_ok`
- e2e_ingest_ms  beside them: the ingestion the timed region leaves out,
                 the median wall of a fresh decoder's add_symbols calls over
                 the timed rounds (into its ingestion slabs);
                 `e2e_ingest_warm_ms` of the warm rounds
Each decode_e2e arm is read in R = max(3, min(--iters, 5)) rounds (5 at the
default --iters; the deadline may cut a call to 3 rounds, never fewer; each
round starts one arm later than the round before): its value is the MEDIAN
round, and `e2e_<arm>[_warm]_spread` beside it is (the slowest round - the
fastest) / the median (`e2e_auto_spread` for the cold `decode_e2e`).  `e2e_auto_ok` and `e2e_auto_warm_ok` compare medians.  Up
to the bench of run G8 (PERF.md section 4) these cells were the BEST of 2-3
rounds instead: a median is slower than a best round by about half the
spread, so an older best-of-rounds figure is not comparable with a median.
- with `--mesh N` (off by default), two cells more per K, on N lanes dealt
  round-robin over the visible cards (`parallel.mesh`; on `--device cpu`, N
  CPU lanes): encode_e2e_mesh, encode_e2e through `generate(mesh=)` and
  `repair_symbols(mesh=)`, and e2e_device_mesh, decode_e2e through
  `repair_all(backend="device", mesh=)`, in turn with the other arms

Program counters per K (`PROGRAM_KEYS`, beside the cells): `capture_ms`,
the host time of the encoder program's capture at the K's width (null on the
CPU, where nothing is captured), and the K's counts of program captures,
program replays, replays of a program another schedule of the signature
captured (`replay_program_shared`: the cold decode patterns that found their
signature's program), and schedule signatures new and seen before
(`replay_compile_new` / `replay_compile_hit`, once per schedule).

Timing: device-resident cells are timed between CUDA events over `iters`
back-to-back calls after two warm-up calls (on a card the second captures
the replay's program; `"timing": "events"`; on
`--device cpu` the host clock, `"perf_counter"`); a region shorter than 20
launch overheads (measured at start) is repeated with more calls, and the
cell is null where that cannot be reached.  The end-to-end cells (encode_e2e,
decode0, decode_e2e) are the host clock between two device synchronisations:
encode_e2e and decode0 the best of their rounds, decode_e2e the median.
Rates are Gbps (8e-9 * bytes / s) under the JAX bench's key names, and
`*_mbps` in BASELINE.md's unit, 8 * bytes / (2**20 * s).

Output: one JSON line per K on stdout as soon as that K is done, Ks in the
order 1000, 50000, 100, 500, 5000, 10000, each with the card's name and power
limit; then one summary line (`metric`, `value`, `unit`, `vs_baseline`,
`detail`, `partial`).  `--deadline` (wall seconds) is checked before every K
and every cell: what cannot start is left null, the summary says
`"partial": true` and the exit code is 0.  An exception inside a K is not
swallowed: the lines printed stand, the summary is emitted as partial, the
traceback goes to stderr and the exit code is 1.
"""

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as cc
from nanorq_tpu_torch.codec.api import SYM_ADDED, Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan
from nanorq_tpu_torch.ops.program import lookup, replay
from nanorq_tpu_torch.ops.replay import device_arrays
from nanorq_tpu_torch.ops.replay import replay as eager_replay
from nanorq_tpu_torch.parallel.mesh import host_matrix, local_mesh, make_mesh, upload
from nanorq_tpu_torch.precode.device_schedule import _FREEZE_AFTER, compile_device
from nanorq_tpu_torch.precode.matrix import binary_rows
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.rfc.tables import Z_MAX
from nanorq_tpu_torch.utils import stats

REF_BASELINE = {  # Mb/s from BASELINE.md (graph.png)
    100: {"encode": 5450, "precalc": 10200, "decode": 5600, "decode_oh5": 5800},
    500: {"encode": 4750, "precalc": 8200, "decode": 4800, "decode_oh5": 6750},
    1000: {"encode": 4700, "precalc": 7900, "decode": 4850, "decode_oh5": 6600},
    5000: {"encode": 3750, "precalc": 5900, "decode": 3900, "decode_oh5": 5000},
    10000: {"encode": 2900, "precalc": 4050, "decode": 3000, "decode_oh5": 3550},
    50000: {"encode": 1500, "precalc": 2100, "decode": 1550, "decode_oh5": 1950},
}

# decode_e2e block counts: enough distinct-pattern blocks that solves and
# staging dominate a launch even at small K, bounded by staging cost at large K
E2E_BLOCKS = {100: 128, 500: 64, 1000: 64, 5000: 16, 10000: 8, 50000: 8}

GRID = (100, 500, 1000, 5000, 10000, 50000)  # the reference Makefile's K grid
RUN_ORDER = (1000, 50000, 100, 500, 5000, 10000)  # the headline K and the costliest first
OBJECT_BYTES = 256 << 20  # the reference's object (benchmark.c:11)
ARMS = ("auto", "device", "res", "res_host", "host")
MESH_ARM = "device_mesh"  # decode_e2e's arm under --mesh
RES_MAX_K = 16384  # the residual arms above it would pay a multi-second elimination
MIN_LAUNCHES = 20  # a timed region is at least this many launch overheads ...
MAX_CALLS = 1 << 14  # ... or the cell is null once it would take more calls than this
# keys of a K's line, all present always: null where a cell did not run
KEYS = ("encode", "encode_mbps", "encode_replay", "encode_e2e", "encode_e2e_mbps", "encode_e2e_repair",
        "encode_fresh", "decode0", "decode", "agg", "solve_ms", "fresh_ms", "dec_solve_ms", "dec_plan",
        "batch_MB", "decode_e2e", "decode_e2e_mbps", "agg_e2e", "e2e_auto_ok", "vs_ref", "fresh_vs_ref",
        *(k for arm in ARMS[1:] for k in (f"e2e_{arm}", f"e2e_{arm}_mbps")),
        *(k for arm in ARMS for k in (f"e2e_{arm}_warm", f"e2e_{arm}_warm_mbps")), "e2e_auto_warm_ok",
        "e2e_ingest_ms", "e2e_ingest_warm_ms",
        *(f"e2e_{arm}{state}_spread" for state in ("", "_warm") for arm in ARMS))
# the program counters of a K's line, all present always (capture_ms null on the CPU)
PROGRAM_KEYS = ("capture_ms", "replay_program_capture", "replay_program_replay", "replay_program_shared",
                "replay_compile_new", "replay_compile_hit")
# and under --mesh N
MESH_KEYS = ("mesh_lanes", "encode_e2e_mesh", "encode_e2e_mesh_mbps", "e2e_device_mesh", "e2e_device_mesh_mbps")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _gate(ok, msg: str) -> None:
    """A correctness gate of the bench: a number is printed only behind it."""
    if not ok:
        raise AssertionError(msg)


def _gbps(nbytes: int, s: float) -> float:
    return 8 * nbytes / s / 1e9


def _mbps(nbytes: int, s: float) -> float:  # BASELINE.md's unit
    return 8 * nbytes / (1 << 20) / s


def device_fields(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on the CPU."""
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None, "timing": "perf_counter"}
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(dev.index)],
                       capture_output=True, text=True, timeout=60, check=True)
    name, limit = (x.strip() for x in r.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"device": name, "power_limit_w": float(limit.split()[0]), "timing": "events"}


class Clock:
    """The run's deadline, and the timer of device work on `dev`."""

    def __init__(self, dev: torch.device, deadline_s: float):
        self.dev = dev
        self.end = time.monotonic() + deadline_s
        self.partial = False
        self.floor_s = 0.0  # MIN_LAUNCHES launch overheads, once measured

    def expired(self) -> bool:
        """Whether the deadline has passed (and then the run is partial)."""
        if time.monotonic() >= self.end:
            self.partial = True
        return self.partial

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def region(self, fn, calls: int) -> float:
        """Seconds of `calls` back-to-back fn(): between CUDA events on the
        card, on the host clock on the CPU."""
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            return time.perf_counter() - t0
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(calls):
            fn()
        t1.record()
        torch.cuda.synchronize(self.dev)
        return t0.elapsed_time(t1) / 1e3

    def measure_overhead(self) -> float:
        """One launch's overhead: the mean of back-to-back one-element
        updates.  Sets the least timed region, MIN_LAUNCHES of them."""
        x = torch.zeros(1, dtype=torch.uint8, device=self.dev)
        self.region(lambda: x.add_(1), 10)
        per = self.region(lambda: x.add_(1), 200) / 200
        self.floor_s = MIN_LAUNCHES * per
        return per

    def timed(self, fn, iters: int) -> float | None:
        """Seconds per fn() over `iters` calls after two warm-up calls (on a
        card the second captures the replay's program); more calls while the
        region is under the floor; None where MAX_CALLS do not reach it or
        the deadline passes first."""
        fn()
        fn()
        self.sync()
        calls = max(1, iters)
        while True:
            s = self.region(fn, calls)
            if s >= self.floor_s:
                return s / calls
            if calls >= MAX_CALLS or self.expired():
                return None
            calls = min(MAX_CALLS, max(2 * calls, int(calls * 1.5 * self.floor_s / max(s, 1e-9))))

    def wall(self, fn) -> float:
        """Host seconds of one fn(), the device idle before and after."""
        self.sync()
        t0 = time.perf_counter()
        fn()
        self.sync()
        return time.perf_counter() - t0


def loss_pattern(rng: np.random.Generator, K: int):
    """(gaps, number of repair symbols): ~6% source loss, gaps + 5% repair
    symbols (benchmark.c's decode-oh5 run)."""
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    return gaps, gaps.size + max(1, int(0.05 * K))


def bench_decode0(K, T, blocks, iters, dev, clock: Clock):
    """0%-loss decode: batched ingestion + no-op repair via the public API."""
    rng = np.random.default_rng(1)
    F = K * T * blocks
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=blocks, device=dev)
    payloads = data.reshape(blocks * K, T)
    tags = np.array([make_tag(sbn, e) for sbn in range(blocks) for e in range(K)], np.int64)
    out = np.zeros(F, np.uint8)  # allocated once, like the reference's run loop (benchmark.c:172-217)
    io = MemoryIO(out)
    best = float("inf")
    for _ in range(max(3, iters)):
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        out[:] = 0

        def run():
            sts = dec.add_symbols(payloads, tags, io)  # whole burst, all blocks
            _gate(sts[0] == SYM_ADDED, "decode0: the first symbol was not added")
            for sbn in range(blocks):
                _gate(dec.repair_block(io, sbn), f"decode0: block {sbn} not whole")

        best = min(best, clock.wall(run))
        _gate(np.array_equal(out, data), "decode0 verification FAILED")
        if clock.expired():
            break
    return _gbps(F, best)


def e2e_object(K, T, nblocks, dev, seed: int = 7):
    """The decode_e2e object: (data, encoder, per block (kept source ESIs,
    repair ESIs, repair payloads)), every block with its own loss pattern."""
    rng = np.random.default_rng(seed)
    F = K * T * nblocks
    data = rng.integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=nblocks, device=dev)
    src = MemoryIO(data)
    per_block = []
    for sbn in range(nblocks):
        gaps, nrep = loss_pattern(rng, K)
        rep_esis = np.arange(K, K + nrep)
        per_block.append((np.setdiff1d(np.arange(K), gaps), rep_esis, enc.encode_batch(sbn, rep_esis, src)))
    return data, enc, per_block


def bench_decode_e2e(K, T, nblocks, rounds, dev, clock: Clock, arms=("auto",), mesh=None, warm=False):
    """End-to-end fresh-pattern decode through the public path: nblocks blocks
    with DISTINCT ~6% loss patterns + 5% overhead, repaired by ONE
    Decoder.repair_all call per arm and round.  The timed region is exactly
    repair_all (per-pattern prep + solves + recovery + write-through), with
    add_symbols ingestion outside it as the reference keeps it
    (benchmark.c:143-151).  Every per-pattern decoder memo is cleared each
    round (cold); with `warm`, once, then one untimed round of every arm
    fills them, and each timed round finds the plans and memos of the round
    before.  The output is compared with the object each time.  Arms are
    interleaved round-robin so that drift of the shared host's speed falls on
    every arm alike, each round starting one arm later than the one before,
    so that no arm always follows the same one (a host arm's native threads
    can still hold the cores as the next arm starts); `rounds` rounds, fewer
    where the deadline passes, but never fewer than 3.  The arm
    "device_mesh" is "device" over `mesh`.  Returns ({arm: the median round's seconds}, {arm: (slowest - fastest) /
    median}, the median ms of a fresh decoder's ingestion over the timed
    rounds)."""
    data, enc, per_block = e2e_object(K, T, nblocks, dev)
    payloads = data.reshape(nblocks * K, T)
    out = np.zeros(data.size, np.uint8)  # one buffer, like the reference's run loop

    sends = [(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], rep_pl,
              [make_tag(sbn, int(e)) for e in rep_esis]) for sbn, (keep, rep_esis, rep_pl) in enumerate(per_block)]
    ingest = []

    def fresh_decoder():
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        out[:] = 0
        io = MemoryIO(out)
        t0 = time.perf_counter()
        for src, src_tags, rep_pl, rep_tags in sends:
            dec.add_symbols(src, src_tags, io)
            dec.add_symbols(rep_pl, rep_tags, io)
        ingest.append(1e3 * (time.perf_counter() - t0))
        return dec, io

    def once(arm) -> float:
        dec, io = fresh_decoder()
        if not warm:
            cc.clear_decoder_cache()
        ok = []
        kw = {"backend": "device", "mesh": mesh} if arm == MESH_ARM else {"backend": arm}
        dt = clock.wall(lambda: ok.append(dec.repair_all(io, **kw)))
        _gate(ok[0], f"decode_e2e repair failed ({arm})")
        _gate(np.array_equal(out, data), f"decode_e2e verification FAILED ({arm})")
        return dt

    if warm:
        cc.clear_decoder_cache()
        for arm in arms:
            once(arm)
        ingest.clear()
    runs = {arm: [] for arm in arms}
    for rnd in range(max(3, rounds)):
        for arm in arms[rnd % len(arms):] + arms[: rnd % len(arms)]:  # each round starts one arm later
            runs[arm].append(once(arm))
        if rnd >= 2 and clock.expired():  # every arm has its three rounds at least
            break
    med = {arm: float(np.median(r)) for arm, r in runs.items()}
    spread = {arm: (max(r) - min(r)) / med[arm] for arm, r in runs.items()}
    return med, spread, float(np.median(ingest))


def bench_K(K, T, blocks, iters, rng, dev, clock: Clock, dec_blocks=0, mesh=None) -> dict:
    """The cells of one K but decode_e2e; a cell the deadline cuts stays null."""
    r = dict.fromkeys(KEYS)
    r.update(dict.fromkeys(PROGRAM_KEYS))
    if mesh is not None:
        r.update(dict.fromkeys(MESH_KEYS), mesh_lanes=mesh.size)
    P = params_init(K)
    t = blocks * T
    payload = K * T * blocks
    r["batch_MB"] = payload / 1e6

    # host fresh-schedule latency: rows + solve + device-schedule compile (the
    # reference's fresh-encode extra cost, benchmark.c:82-116), after one
    # untimed solve: table set-up and the native library's load are not K's
    compile_device(solve_state(P, binary_rows(P)))
    t0 = time.perf_counter()
    st = solve_state(P, binary_rows(P))
    r["solve_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    compile_device(st)
    r["fresh_ms"] = r["solve_ms"] + 1e3 * (time.perf_counter() - t0)
    ds = cc.encoder_schedule(P.Kp)
    arr = device_arrays(ds, dev)

    # the object as codec.batch.load_object holds it: pinned [K, t] on a card
    D = host_matrix(K, ds.M_pad, t, dev)
    D[:K] = rng.integers(0, 256, (K, t), dtype=np.uint8)
    Dj = upload(local_mesh(dev).lanes[0], D, ds.M_pad, K)

    # --- encode_replay: intermediate-symbol generation, the reference's timed
    # region in nanorq_generate_symbols ---
    if clock.expired():
        return r
    enc_per = clock.timed(lambda: replay(arr, Dj), iters)
    if enc_per:
        r["encode_replay"] = _gbps(payload, enc_per)
    capture_s = 0.0
    if dev.type == "cuda":
        prog = lookup(arr, t, torch.cuda.current_stream(dev).cuda_stream)
        capture_s = prog.capture_s if prog is not None else 0.0
        r["capture_ms"] = 1e3 * capture_s

    # --- encode (headline): replay + LT of all K' systematic symbols ---
    if clock.expired():
        return r
    plan_all = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, dev)
    encfull_per = clock.timed(lambda: lt_combine(replay(arr, Dj), plan_all), iters)
    if encfull_per:
        r["encode"], r["encode_mbps"] = _gbps(payload, encfull_per), _mbps(payload, encfull_per)
        # fresh encode: a cold encoder pays the schedule solve + compile once,
        # then streams batches, normalized to the reference's 256 MiB object:
        # the first batch replays eagerly, the second (when the object holds
        # two whole batches) captures the program, the rest replay it
        eager_per = clock.timed(lambda: lt_combine(eager_replay(arr, Dj), plan_all), iters) or encfull_per
        n = OBJECT_BYTES / payload
        fresh_s = (r["fresh_ms"] / 1e3 + min(n, 1.0) * eager_per + (capture_s if n >= 2 else 0.0)
                   + max(n - 1.0, 0.0) * encfull_per)
        r["encode_fresh"] = _gbps(OBJECT_BYTES, fresh_s)

    # --- encode_e2e: the same object from host memory to host memory ---
    if clock.expired():
        return r
    enc = Encoder(payload, T, Al=8, Z=blocks, device=dev)
    _gate(enc.num_blocks == blocks and all(enc.block_symbols(b) == K for b in range(blocks)),
          f"the scheme is not {blocks} blocks of K={K}")
    obj = tbatch.ObjectBatch(enc=enc, sbns=list(range(blocks)), Ks=np.full(blocks, K, np.int64), D=D)
    n_repair = max(1, K // 5)

    def encode_e2e(mesh=None):
        obj.C = None
        tbatch.generate(obj, dev, mesh=mesh)
        return tbatch.repair_symbols(obj, n_repair, dev, mesh=mesh)  # fetched to the host

    want = encode_e2e()  # warm: the repair plan
    encode_e2e()  # and the program's capture
    rounds = max(2, min(iters, 5))
    e2e_s = min(clock.wall(encode_e2e) for _ in range(rounds))
    r["encode_e2e"], r["encode_e2e_mbps"], r["encode_e2e_repair"] = _gbps(payload, e2e_s), _mbps(payload, e2e_s), n_repair
    if mesh is not None and not clock.expired():
        got = encode_e2e(mesh)  # warm: the lanes' plans and the first pinning
        encode_e2e(mesh)  # and the lanes' programs
        _gate(all(np.array_equal(got[b], want[b]) for b in range(blocks)), "encode_e2e_mesh verification FAILED")
        mesh_s = min(clock.wall(lambda: encode_e2e(mesh)) for _ in range(rounds))
        _gate(not mesh.take_index_errors(), "encode_e2e_mesh: a gather met an index outside its source")
        r["encode_e2e_mesh"], r["encode_e2e_mesh_mbps"] = _gbps(payload, mesh_s), _mbps(payload, mesh_s)
    del want
    obj.C = None

    # --- decode at ~6% loss + 5% overhead: patched solve (host, cached) + the
    # device path of the plan decoder_plan picks: the dense combination matmul
    # (WSchedule) at small and mid K', the structured replay + gap LT above ---
    if clock.expired():
        return r
    gaps, nrep = loss_pattern(rng, K)
    ov = nrep - gaps.size

    def pattern(g):
        isis = np.arange(P.Kp + ov, dtype=np.uint32)
        rep = (np.arange(K, K + g.size + ov) + (P.Kp - K)).astype(np.uint32)
        isis[g] = rep[: g.size]
        isis[P.Kp:] = rep[g.size:]
        return isis, rep

    # walk enough distinct patterns first that the per-K' canonical layout
    # freezes, so the measured pattern runs the layout a stream settles into;
    # the same loop yields the marginal per-pattern host prep (min, warm memos)
    lay0 = stats.snapshot()["counters"]
    dec_solve_ms = float("inf")
    walk = [loss_pattern(np.random.default_rng(1000 + s), K)[0] for s in range(_FREEZE_AFTER + 1)] + [gaps]
    for g in walk:
        t0 = time.perf_counter()
        plan_dec = cc.decoder_plan(P, pattern(g)[0], ov)
        dec_solve_ms = min(dec_solve_ms, 1e3 * (time.perf_counter() - t0))
        _gate(plan_dec is not None, f"K={K}: a 6% + 5% pattern did not solve")
    r["dec_solve_ms"] = dec_solve_ms
    wpath = isinstance(plan_dec, cc.WSchedule)
    r["dec_plan"] = "W" if wpath else "structured"
    lay1 = stats.snapshot()["counters"]
    layout = {k.removeprefix("replay_layout_"): lay1.get(k, 0) - lay0.get(k, 0)
              for k in ("replay_layout_hit", "replay_layout_grown", "replay_layout_frozen", "replay_layout_warmup")
              if lay1.get(k, 0) - lay0.get(k, 0)}
    if layout:
        r["dec_layout"] = layout

    # the decode payload: received sources, and real repair symbols in the gap
    # and overhead slots (from the encoder intermediates); --dec-blocks
    # decouples the decode batch from the encode one
    dec_blocks = dec_blocks or blocks
    t_dec, payload_dec = dec_blocks * T, K * T * dec_blocks
    if dec_blocks == blocks:
        Dsrc, Dj_src = D, Dj
    else:
        Dsrc = host_matrix(K, ds.M_pad, t_dec, dev)
        Dsrc[:K] = rng.integers(0, 256, (K, t_dec), dtype=np.uint8)
        Dj_src = upload(local_mesh(dev).lanes[0], Dsrc, ds.M_pad, K)
    rep_isis = pattern(gaps)[1]
    rep_payloads = lt_combine(replay(arr, Dj_src), lt_plan(rep_isis, P, dev))[: rep_isis.size].cpu().numpy()
    Dd = np.zeros((plan_dec.M_pad, t_dec), np.uint8)
    Dd[:K] = Dsrc[:K]
    Dd[gaps] = rep_payloads[: gaps.size]
    Dd[P.Kp : P.Kp + ov] = rep_payloads[gaps.size :]
    Ddj = torch.from_numpy(Dd).to(dev)
    del Dj, Dj_src, rep_payloads, Dd

    if wpath:
        dec_recover = lambda: plan_dec.apply(Ddj)  # noqa: E731
    else:
        arr_d = device_arrays(plan_dec, dev)
        plan_gaps = lt_plan(gaps.astype(np.uint32), P, dev) if gaps.size else None

        def dec_recover():
            C = replay(arr_d, Ddj)
            return lt_combine(C, plan_gaps) if plan_gaps is not None else C

    # byte-equality gate (reference benchmark.c:233-235): recovered gap
    # symbols must equal the dropped source symbols
    if gaps.size:
        rec = dec_recover()[: gaps.size].cpu().numpy()
        _gate(np.array_equal(rec, Dsrc[gaps]), "decode verification FAILED")
        log(f"K={K}: decode byte-equality verified over {gaps.size} recovered symbols"
            + (" (dense-W path)" if wpath else " (structured replay)"))
    dec_per = clock.timed(dec_recover, iters)
    if dec_per:
        r["decode"] = _gbps(payload_dec, dec_per)
        if encfull_per:  # per-byte harmonic aggregate
            r["agg"] = 8 / (encfull_per / payload + dec_per / payload_dec) / 1e9
    else:
        log(f"K={K}: warm decode cell too short to time -- dropped")
    del Ddj

    if clock.expired():
        return r
    r["decode0"] = bench_decode0(K, T, blocks, iters, dev, clock)
    return r


def default_blocks(K: int, T: int) -> int:
    """Blocks of the reference's 256 MiB object, at most Z_MAX of them."""
    return min(Z_MAX, max(1, OBJECT_BYTES // (K * T)))


def lanes_mesh(n: int, dev: torch.device):
    """n lanes dealt round-robin over the visible cards; n CPU lanes on the CPU."""
    if dev.type != "cuda":
        return make_mesh([dev] * n)
    return make_mesh([torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)])


def _auto_ok(K, state: str, secs: dict, nbytes: int) -> bool:
    """Routing sanity: whether "auto" came within 10% of the best arm, both
    read as the median of their rounds (`secs`, as bench_decode_e2e gives)."""
    best_arm = min(secs, key=secs.get)
    ok = bool(secs["auto"] <= secs[best_arm] / 0.9)
    if not ok:
        log(f"WARN K={K} ({state}): auto arm {_gbps(nbytes, secs['auto']):.2f} Gbps < 0.9x best arm "
            f"'{best_arm}' {_gbps(nbytes, secs[best_arm]):.2f} (medians) -- recalibrate routing")
    return ok


def run_grid(args, ks, results, dev, clock: Clock, fields: dict) -> None:
    rng = np.random.default_rng(0)
    mesh = lanes_mesh(args.mesh, dev) if args.mesh else None
    overhead = clock.measure_overhead()
    fmt = lambda v: "n/a" if v is None else f"{v:.2f}"  # noqa: E731
    for K in ks:
        if clock.expired():
            log(f"deadline: K={K} and what follows it not started")
            return
        blocks = min(args.blocks or default_blocks(K, args.T), Z_MAX)
        iters = args.iters if K <= 5000 else max(4, args.iters // 4)
        dec_blocks = min(args.dec_blocks, default_blocks(K, args.T))
        counts0 = stats.snapshot()["counters"]
        r = bench_K(K, args.T, blocks, iters, rng, dev, clock, dec_blocks=dec_blocks, mesh=mesh)
        if not args.no_pipe and not clock.expired():
            # decode_e2e: fresh-pattern decode through repair_all, per-pattern
            # work inside the timed region, for EVERY K; per arm at K in
            # {1000, 50000} (--arms: at every K)
            nb = E2E_BLOCKS.get(K) or max(4, min(128, (64 << 20) // (K * args.T)))
            arms = ("auto",)
            if args.arms or K in (1000, 50000):
                arms = ARMS if K <= RES_MAX_K else tuple(a for a in ARMS if not a.startswith("res"))
            if mesh is not None:
                arms += (MESH_ARM,)
            rounds = max(3, min(args.iters, 5))
            secs, spread, r["e2e_ingest_ms"] = bench_decode_e2e(K, args.T, nb, rounds, dev, clock, arms=arms,
                                                                mesh=mesh)
            nbytes = K * args.T * nb
            if mesh is not None:
                arms = arms[:-1]
                s_mesh = secs.pop(MESH_ARM)
                r["e2e_device_mesh"], r["e2e_device_mesh_mbps"] = _gbps(nbytes, s_mesh), _mbps(nbytes, s_mesh)
            r["decode_e2e"], r["decode_e2e_mbps"] = _gbps(nbytes, secs["auto"]), _mbps(nbytes, secs["auto"])
            for arm in arms:
                r[f"e2e_{arm}_spread"] = spread[arm]
            for arm in arms[1:]:
                r[f"e2e_{arm}"], r[f"e2e_{arm}_mbps"] = _gbps(nbytes, secs[arm]), _mbps(nbytes, secs[arm])
            if len(arms) > 1:
                r["e2e_auto_ok"] = _auto_ok(K, "cold", secs, nbytes)
            if args.arms and not clock.expired():  # the same object and patterns, warm
                wsecs, wspread, r["e2e_ingest_warm_ms"] = bench_decode_e2e(K, args.T, nb, rounds, dev, clock,
                                                                           arms=arms, warm=True)
                for arm, s in wsecs.items():
                    r[f"e2e_{arm}_warm"], r[f"e2e_{arm}_warm_mbps"] = _gbps(nbytes, s), _mbps(nbytes, s)
                    r[f"e2e_{arm}_warm_spread"] = wspread[arm]
                r["e2e_auto_warm_ok"] = _auto_ok(K, "warm", wsecs, nbytes)
            if r["encode"]:
                r["agg_e2e"] = 1.0 / (1.0 / r["encode"] + 1.0 / r["decode_e2e"])
        counts1 = stats.snapshot()["counters"]
        r.update({k: counts1.get(k, 0) - counts0.get(k, 0) for k in PROGRAM_KEYS[1:]})
        base = REF_BASELINE.get(K)
        if base and r["encode"]:
            # vs_ref from the fresh-pattern e2e decode when measured (the
            # reference's decode-oh5 times the per-run invert too)
            dec_ref = r["decode_e2e"] or r["decode"]
            if dec_ref:
                r["vs_ref"] = round((1.0 / (1.0 / r["encode"] + 1.0 / dec_ref))
                                    / (1.0 / (1e3 / base["precalc"] + 1e3 / base["decode_oh5"])), 3)
            r["fresh_vs_ref"] = round(r["encode_fresh"] / (base["encode"] / 1e3), 3)
        results[K] = r
        print(json.dumps({"K": K, **fields, "blocks": blocks, "launch_overhead_us": overhead * 1e6,
                          "partial": clock.partial, **r}), flush=True)
        log(f"K={K} B={blocks}: encode {fmt(r['encode'])} Gbps (ref precalc {(base or {}).get('precalc', 0) / 1e3:.2f}), "
            f"e2e {fmt(r['encode_e2e'])}, fresh {fmt(r['encode_fresh'])}, replay {fmt(r['encode_replay'])}, "
            f"decode0 {fmt(r['decode0'])}, decode {fmt(r['decode'])} ({r['dec_plan']}), decode_e2e {fmt(r['decode_e2e'])} "
            f"(ref {(base or {}).get('decode_oh5', 0) / 1e3:.2f}), arms device {fmt(r['e2e_device'])} / res "
            f"{fmt(r['e2e_res'])} / res_host {fmt(r['e2e_res_host'])} / host {fmt(r['e2e_host'])}, "
            f"solve {fmt(r['solve_ms'])}/{fmt(r['fresh_ms'])}/{fmt(r['dec_solve_ms'])} ms")


def emit(results, fields: dict, T: int, partial=False) -> None:
    """The summary line: the headline K's aggregate against the reference's."""
    K0 = 1000 if 1000 in results else next(iter(results), None)
    r0 = results.get(K0, {})
    base = REF_BASELINE.get(K0, REF_BASELINE[1000])
    ref_agg = 1.0 / (1e3 / base["precalc"] + 1e3 / base["decode_oh5"])
    value = r0.get("agg_e2e") or r0.get("agg") or r0.get("encode")
    vs_all = [r["vs_ref"] for r in results.values() if r.get("vs_ref") is not None]
    what = " (fresh-pattern solves included)" if r0.get("agg_e2e") else " (device-side sustained)"
    of = f"K={K0} T={T}" if results else "no K measured"
    print(json.dumps({
        "metric": f"encode+decode aggregate Gbps, {of}, 1 chip" + what + (" [PARTIAL]" if partial else ""),
        "value": None if value is None else round(value, 3),
        "unit": "Gbps",
        "vs_baseline": None if value is None else round(value / ref_agg, 3),
        "vs_baseline_min_over_grid": round(min(vs_all), 3) if vs_all else None,
        "partial": bool(partial),
        **fields,
        "detail": {str(k): {m: round(v, 3) if isinstance(v, float) else v for m, v in r.items()}
                   for k, r in results.items()},
    }), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nanorq-bench", description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--blocks", type=int, default=0, help="0 = the reference's 256 MiB object")
    ap.add_argument("--dec-blocks", type=int, default=0, help="decode batch override (0 = same as --blocks)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--ks", type=int, nargs="*", default=list(GRID), help="default: the reference Makefile's 6-K grid")
    ap.add_argument("--no-pipe", action="store_true", help="skip the fresh-pattern decode_e2e measurement")
    ap.add_argument("--arms", action="store_true", help="decode_e2e per backend at every K")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="also time encode_e2e and the device decode_e2e over N lanes (0 = off)")
    ap.add_argument("--deadline", type=float, default=1500.0, help="wall-clock seconds for the whole run")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    fields = device_fields(dev)
    ks = [k for k in RUN_ORDER if k in args.ks] + [k for k in args.ks if k not in RUN_ORDER]
    clock = Clock(dev, args.deadline)
    results, rc = {}, 0
    try:
        run_grid(args, ks, results, dev, clock, fields)
    except Exception:  # the lines printed stand; report, emit what is there, fail
        traceback.print_exc(file=sys.stderr)
        clock.partial, rc = True, 1
    if len(results) < len(ks):
        clock.partial = True
    emit(results, fields, args.T, partial=clock.partial)
    return rc


if __name__ == "__main__":
    sys.exit(main())
