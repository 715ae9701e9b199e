"""Where the decode's host time goes: the native host arms and the dense-W
device arm, step by step (counterpart of `tools/hostarm_prof.py`,
`probe_hostprof.py`, `probe_smallk.py` and `probe_hostarm.py`).

    python -m nanorq_tpu_torch.tools.hostarm_prof [K ...] [--blocks N] [--iters N] [--T T] [--arms ARM ...]
        [--device cuda]

At each K (default 100 500 1000 5000 10000), an object of `blocks` blocks
of K symbols of T bytes (default 1280); the block count is the JAX tools'
(`BLOCKS`) where K is in their table, else `blocks_for(K, T)`.  Each block
loses 6% of its source symbols and receives 5% of K repair symbols more
than it lost (the JAX tools' patterns, seed 7).  Every arm decodes it cold
(the decoder's plan cache and memos cleared) and warm (kept from the cold
runs), `iters` fresh decoders each; the fastest run's split is printed.
Every run also reports `ingest_ms`: the wall of the fresh decoder's
`add_symbols` calls (outside the decode, as the bench keeps it), where the
decoder's ingestion slabs are allocated (`Decoder._source_rows`: on a card
pinned where the device arm may read them, else pageable until it does).
Before any run, each K's first decoder is timed as a one-shot user meets it:
`ingest_first_ms` (any pinned slabs new to PyTorch's host cache, where no
earlier K left blocks of their size) and `decode_first_ms` (`repair_all`,
the default arm, cold); its line has `ingest_bytes` / `pinned_bytes`
(`Decoder.ingest_bytes`, read after the decode) and, on a card,
`host_memory_kept`: what the byte counts of `torch.cuda.host_memory_stats`
gained over the first decoder's life, read after it died (`allocated_bytes`:
what the host cache still pins), and `registered_kept`: the bytes still
page-locked in place (`parallel.mesh.HostSlab.registered`; null where the
package has no such slabs).  The first decoder touches only the package's public calls, so
this file also times an older checkout's (run it as a script with that
checkout on PYTHONPATH, `--arms host`; `python -m` would take the working
directory's package).

- `host` and `res_host` (the native CPU arms): `prep_ms`, the Python prep
  (`Decoder._repair_prepare` over the blocks), against `batch_ms`, the
  arm's batch call (`_repair_host_batch`, `_repair_residual_host_batch`),
  which splits into `native_ms` (the native call, `utils.stats` timers
  `host_repair` / `host_residual`) and `py_build_ms` (the Python around it:
  row pointers, for `res_host` the canonical w-rows); `finish_ms` (the
  gap rows' write-out, where they were not written through); and for
  `host` the native stage split that `NRQ_TIMING=1` prints
  (`native/solver.cc`: solve, s1..s5, ms, its thread 0 -- the only thread
  unless NANORQ_HOST_THREADS says otherwise).
- `device` (dense-W plans): each step by the host clock between two
  synchronisations, summed over the stacked batches as
  `Decoder._repair_launch_batch` cuts them: `prep_ms`, `plan_ms`
  (`codec.cache.decoder_plan`: the solve and the W rows cold, a cache hit
  warm), `stage_ms` (the repair rows' copy into pinned staging, timer
  "host_stage") and `upload_ms` (the rest of building the payload stack on
  the card, `parallel.mesh.shard_assemble`), `wstack_ms` (the W stack built
  and uploaded),
  `apply_ms` (K1 + K2, `ops/wpath.w_apply_gf2_batch`, for GF(2) plans; K3,
  `w_apply_gf256_batch`, for GF(256) ones -- `apply_ms_by_kind`) and
  `fetch_ms` (the gap rows into pinned memory); then one more run of the
  same under torch.profiler for `busy_share`: the card's kernel and copy
  time over that run's `total_ms` (null where the profiler shows no device
  time, and on the CPU).  A K whose plans are structured (above
  `cache.WPATH_MAX_KP`) prints the device line with `"plan": "structured"`
  and no steps.

One JSON line per K and arm, {"cold": {...}, "warm": {...}}, each with
`total_ms` and `mbps` (8 * bytes / (2**20 * s)), and the card's name and
power limit.  Every run must restore the object bit for bit.  On `--device
cpu` the plain versions stand in for the kernels: a rehearsal at a tiny
size, no device number.  The host arms need the native library: without
it the tool raises.
"""

import argparse
import contextlib
import gc
import os
import re
import tempfile
import time

import numpy as np
import torch

from nanorq_tpu_torch.codec import cache as cc
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.ops import wpath
from nanorq_tpu_torch.parallel import mesh as lanes
from nanorq_tpu_torch.tools import _sweep
from nanorq_tpu_torch.utils import stats

BLOCKS = {100: 128, 500: 64, 1000: 64, 5000: 16, 10000: 8, 50000: 4}  # tools/hostarm_prof.py's NB
ARMS = ("host", "res_host", "device")
STAGES = ("solve", "s1", "s2", "s3", "s4", "s5")
HOST_COLUMNS = ("total_ms", "ingest_ms", "prep_ms", "batch_ms", "native_ms", "py_build_ms", "finish_ms", "mbps")
DEVICE_STEPS = ("prep_ms", "plan_ms", "stage_ms", "upload_ms", "wstack_ms", "apply_ms", "fetch_ms")
COLUMNS = {"host": HOST_COLUMNS + ("native_split",), "res_host": HOST_COLUMNS,
           "device": ("total_ms", "ingest_ms") + DEVICE_STEPS + ("apply_ms_by_kind", "batches", "busy_share",
                                                                "mbps")}
_NATIVE_TIMER = {"host": "host_repair", "res_host": "host_residual"}
_SPLIT = re.compile(r"nrq_host_repair2? \(thread 0\): solve ([\d.]+) s1 ([\d.]+) s2 ([\d.]+) s3 ([\d.]+) "
                    r"s4 ([\d.]+) s5 ([\d.]+) ms")


def blocks_for(K: int, T: int) -> int:
    """The block count at a K outside the JAX tools' table: the largest
    power of two of blocks (1 to 128) whose object stays within 128 MiB."""
    n = max(1, min(128, (128 << 20) // (K * T)))
    return 1 << (n.bit_length() - 1)


class _Object:
    """The object, its loss patterns and repair payloads, and fresh decoders fed them."""

    def __init__(self, K: int, T: int, nb: int, dev):
        rng = np.random.default_rng(7)
        self.K, self.T, self.nb, self.dev = K, T, nb, dev
        self.F = K * T * nb
        self.data = rng.integers(0, 256, self.F, dtype=np.uint8)
        self.enc = Encoder(self.F, T, Al=8, Z=nb, device=dev)
        if self.enc.num_blocks != nb or any(self.enc.block_symbols(b) != K for b in range(nb)):
            raise ValueError(f"K={K} T={T}: the object does not cut into {nb} blocks of K symbols")
        src = MemoryIO(self.data)
        self.blocks = []
        for sbn in range(nb):
            gaps = np.nonzero(rng.random(K) < 0.06)[0]
            rep = np.arange(K, K + gaps.size + max(1, int(0.05 * K)))
            self.blocks.append((gaps, rep, self.enc.encode_batch(sbn, rep, src)))
        self.sends = [(np.setdiff1d(np.arange(K), gaps), rep, pl) for gaps, rep, pl in self.blocks]

    def fresh(self):
        """(decoder fed every block's symbols, its output, its io, the
        ms its add_symbols calls took)."""
        dec = Decoder(self.enc.oti_common(), self.enc.oti_scheme_specific(), device=self.dev)
        out = np.zeros(self.F, np.uint8)
        io = MemoryIO(out)
        rows = self.data.reshape(self.nb * self.K, self.T)
        sends = [(sbn, rows[sbn * self.K + keep], [make_tag(sbn, int(e)) for e in keep], pl,
                  [make_tag(sbn, int(e)) for e in rep])
                 for sbn, (keep, rep, pl) in enumerate(self.sends)]
        t = time.perf_counter()
        for _, src, src_tags, pl, rep_tags in sends:
            dec.add_symbols(src, src_tags, io)
            dec.add_symbols(pl, rep_tags, io)
        return dec, out, io, 1e3 * (time.perf_counter() - t)


def _timer_s(name: str) -> float:
    return stats.snapshot()["timers"].get(name, {}).get("total_s", 0.0)


@contextlib.contextmanager
def _native_stderr(into: list):
    """NRQ_TIMING=1 and the process's stderr (fd 2, where the native library
    prints) in a file inside; its text appended to `into` on leaving."""
    old_env = os.environ.get("NRQ_TIMING")
    os.environ["NRQ_TIMING"] = "1"
    with tempfile.TemporaryFile(mode="w+") as f:
        saved = os.dup(2)
        try:
            os.dup2(f.fileno(), 2)
            yield
        finally:
            os.dup2(saved, 2)
            os.close(saved)
            if old_env is None:
                os.environ.pop("NRQ_TIMING", None)
            else:
                os.environ["NRQ_TIMING"] = old_env
            f.seek(0)
            into.append(f.read())


def _prepare(dec: Decoder, nb: int) -> list:
    """`Decoder._repair_prepare` over the blocks: the work of those with gaps."""
    work = []
    for sbn in range(nb):
        prep = dec._repair_prepare(sbn)
        if prep is False:
            raise AssertionError(f"block {sbn} has fewer repair symbols than gaps")
        if prep is not True:  # True: nothing was lost
            work.append((sbn, *prep))
    return work


def _host_run(obj: _Object, arm: str) -> dict:
    """One decode through a native arm, split (see the module's doc)."""
    dec, out, io, ingest = obj.fresh()
    t0 = time.perf_counter()
    work = _prepare(dec, obj.nb)
    t1 = time.perf_counter()
    native0, printed = _timer_s(_NATIVE_TIMER[arm]), []
    batch = dec._repair_host_batch if arm == "host" else dec._repair_residual_host_batch
    with _native_stderr(printed) if arm == "host" else contextlib.nullcontext():
        res = batch(work, io)
    t2 = time.perf_counter()
    if res is None:
        raise RuntimeError(f"the {arm} arm needs the port's native library (nanorq_tpu_torch/native), "
                           "which is unavailable")
    ok, results = res
    for sbn, gaps, sym in results:
        ok = dec._repair_finish(io, sbn, gaps, sym) and ok
    t3 = time.perf_counter()
    if not (ok and np.array_equal(out, obj.data)):
        raise AssertionError(f"K={obj.K}: the {arm} arm did not restore the object")
    native = 1e3 * (_timer_s(_NATIVE_TIMER[arm]) - native0)
    run = {"total_ms": 1e3 * (t3 - t0), "ingest_ms": ingest, "prep_ms": 1e3 * (t1 - t0), "batch_ms": 1e3 * (t2 - t1),
           "native_ms": native, "py_build_ms": 1e3 * (t2 - t1) - native, "finish_ms": 1e3 * (t3 - t2)}
    if arm == "host":
        m = _SPLIT.search(printed[0])
        if m is None:
            raise AssertionError("the native host arm printed no stage split under NRQ_TIMING=1: "
                                 f"{printed[0][-300:]!r}")
        run["native_split"] = dict(zip(STAGES, map(float, m.groups())))
    return run


def _device_run(obj: _Object) -> dict:
    """One decode through the dense-W device arm, step by step (see the
    module's doc); {"plan": "structured"} where a plan is not dense-W."""
    dev, cuda = obj.dev, obj.dev.type == "cuda"
    on = lanes.local_mesh(dev)
    lane = on.lanes[0]
    ms = dict.fromkeys(DEVICE_STEPS, 0.0)
    by_kind = {}

    def step(name, fn):
        if cuda:
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        ms[name] += 1e3 * (time.perf_counter() - t)
        return res

    dec, out, io, ingest = obj.fresh()
    P, T = dec.P, obj.T
    t0 = time.perf_counter()
    work = step("prep_ms", lambda: _prepare(dec, obj.nb))
    plans = step("plan_ms", lambda: [cc.decoder_plan(P, isis, ov) for _, _, isis, ov in work])
    if any(p is None for p in plans):
        raise AssertionError(f"K={obj.K}: a pattern did not solve")
    if not all(isinstance(p, cc.WSchedule) for p in plans):
        return {"plan": "structured"}
    groups = {}
    for (sbn, gaps, _, ov), plan in zip(work, plans):
        groups.setdefault((plan.Wbits is not None, plan.M_pad), []).append((sbn, gaps, ov, plan))
    batches = [items[i : i + dec._BATCH_FLUSH] for items in groups.values()
               for i in range(0, len(items), dec._BATCH_FLUSH)]
    for items in batches:  # Decoder._repair_launch_batch, one step at a time
        M_pad = items[0][3].M_pad
        live = min(P.Kp + max(ov for _, _, ov, _ in items), M_pad - 1)
        plans_b = [p for _, _, _, p in items]
        gf2 = plans_b[0].Wbits is not None
        s0 = _timer_s("host_stage")
        D = step("upload_ms", lambda: lanes.shard_assemble(
            len(items), on, (live + 1, T), lambda lo, hi: dec._repair_parts([it[:3] for it in items[lo:hi]], live + 1)))
        staged = 1e3 * (_timer_s("host_stage") - s0)
        ms["stage_ms"] += staged
        ms["upload_ms"] -= staged
        t = ms["apply_ms"]
        if gf2:
            def wstack():
                bits, rows = wpath.w_stack_gf2(plans_b)
                return lanes.shard_blocks(bits, on), lanes.shard_blocks(np.minimum(rows, live)[..., None], on)

            bits, rows = step("wstack_ms", wstack)
            res = step("apply_ms", lambda: wpath.w_apply_gf2_batch(bits.parts[0], rows.parts[0], D.parts[0]))
        else:
            W = step("wstack_ms", lambda: lanes.shard_blocks(wpath.w_stack_gf256(plans_b)[:, :, : live + 1], on))
            res = step("apply_ms", lambda: wpath.w_apply_gf256_batch(W.parts[0], D.parts[0]))
        kind = "gf2" if gf2 else "gf256"
        by_kind[kind] = by_kind.get(kind, 0.0) + ms["apply_ms"] - t
        rows_out = step("fetch_ms", lambda: lanes.fetch([(lane, res)])[0])
        for j, (sbn, gaps, _, _) in enumerate(items):
            dec._repair_finish(io, sbn, gaps, rows_out[j])
    ms["total_ms"] = 1e3 * (time.perf_counter() - t0)
    if not np.array_equal(out, obj.data):
        raise AssertionError(f"K={obj.K}: the device arm did not restore the object")
    return {**ms, "ingest_ms": ingest, "apply_ms_by_kind": by_kind, "batches": len(batches)}


def _busy_share(obj: _Object, cold: bool) -> float | None:
    """The card's kernel and copy time over the `total_ms` of one more
    device-arm run under torch.profiler, device activity only as chip_smoke's
    phase 5 takes it (None on the CPU, or where it shows none).  The
    decoder's ingestion before the run is not part of either."""
    if obj.dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    if cold:
        cc.clear_decoder_cache()
    torch.cuda.synchronize(obj.dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = _device_run(obj)
    stats.take_spans()  # what the profile turned on: nothing here reads it
    device_ms = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                    if not stats.is_range(e.key)) / 1e3
    return device_ms / run["total_ms"] if device_ms > 0 else None


def prof_arm(obj: _Object, arm: str, iters: int) -> dict:
    """{"cold": ..., "warm": ...}: per state the fastest of `iters` runs."""
    got = {}
    for state in ("cold", "warm"):
        runs = []
        for _ in range(iters):
            if state == "cold":
                cc.clear_decoder_cache()
            runs.append(_host_run(obj, arm) if arm != "device" else _device_run(obj))
        if "total_ms" not in runs[0]:
            got[state] = runs[0]
            continue
        best = min(runs, key=lambda r: r["total_ms"])
        best["mbps"] = 8 * obj.F / (2**20 * best["total_ms"] * 1e-3)
        if arm == "device":
            best["busy_share"] = _busy_share(obj, state == "cold")
        got[state] = best
    return got


def _host_bytes() -> dict:
    """The torch's host allocator account, its byte counts now (empty where
    this torch has none)."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        return {}
    return {k: v for k, v in torch.cuda.host_memory_stats().items() if "bytes" in k and k.endswith(".current")}


def _first(obj: _Object) -> dict:
    """A first decoder of the object before any run, as a one-shot user
    meets it: its ingestion's and its cold default decode's ms, the bytes of
    its ingestion matrices and what they pin (`Decoder.ingest_bytes`, where
    the package has it), and on a card what the host allocator's byte
    counts gained over its life, read after it died."""
    cuda = obj.dev.type == "cuda"
    before = _host_bytes() if cuda else {}
    slabs = getattr(lanes, "HostSlab", None)
    reg0 = slabs.registered if slabs is not None else None
    cc.clear_decoder_cache()
    dec, out, io, ingest = obj.fresh()
    t = time.perf_counter()
    if not (dec.repair_all(io) and np.array_equal(out, obj.data)):
        raise AssertionError(f"K={obj.K}: the first decoder did not restore the object")
    line = {"ingest_first_ms": ingest, "decode_first_ms": 1e3 * (time.perf_counter() - t),
            "ingest_bytes": None, "pinned_bytes": None, "host_memory_kept": None, "registered_kept": None}
    if hasattr(dec, "ingest_bytes"):
        line["ingest_bytes"], line["pinned_bytes"] = dec.ingest_bytes()
    del dec, io
    gc.collect()
    if cuda and before:
        line["host_memory_kept"] = {k: v - before.get(k, 0) for k, v in _host_bytes().items()}
    if reg0 is not None:
        line["registered_kept"] = slabs.registered - reg0
    return line


def prof_k(K: int, nb: int, T: int, iters: int, dev, fields: dict, arms=ARMS) -> list:
    if not native_available():
        raise RuntimeError("hostarm_prof needs the port's native library (nanorq_tpu_torch/native): the host arms "
                           "and the dense-W plans are built by it, and it is unavailable")
    obj = _Object(K, T, nb, dev)
    first = _first(obj)
    lines = []
    for arm in arms:
        line = {"tool": "hostarm_prof", "K": K, "Kp": obj.enc.P.Kp, "T": T, "blocks": nb, "bytes": obj.F,
                "arm": arm, "loss": 0.06, "overhead": 0.05, "iters": iters, **first, **prof_arm(obj, arm, iters)}
        if arm == "device":
            line["plan"] = line["cold"].pop("plan", "dense-W")
            line["warm"].pop("plan", None)
        lines.append(_sweep.emit(line, fields))
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", type=int, nargs="*", help="default: 100 500 1000 5000 10000")
    ap.add_argument("--blocks", type=int, default=None, help="default: the JAX tools' table, else blocks_for(K, T)")
    ap.add_argument("--iters", type=int, default=3, help="fresh decoders per arm and state; the fastest is printed")
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--arms", nargs="+", choices=ARMS, default=list(ARMS))
    _sweep.add_device(ap)
    args = ap.parse_args(argv)
    dev, fields = _sweep.device(args)
    fields = {**fields, "timing": "perf_counter"}
    return [line for K in args.ks or [100, 500, 1000, 5000, 10000]
            for line in prof_k(K, args.blocks or BLOCKS.get(K) or blocks_for(K, args.T), args.T, args.iters, dev,
                               fields, tuple(args.arms))]


if __name__ == "__main__":
    main()
