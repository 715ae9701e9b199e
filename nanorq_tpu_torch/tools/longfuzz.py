"""A long soak of the port: randomized round trips well beyond the pytest
grid (counterpart of `tools/longfuzz.py`, `make soak`).

    python -m nanorq_tpu_torch.tools.longfuzz [--minutes M] [--trials N] [--seed S] [--device cuda]

Trials run from seed S (default 7000000) up, until M minutes (default 30)
or N trials have passed, whichever comes first.  Each trial draws the JAX
tool's fields first, from its generator and in its order: the size, T, Al,
Z, N, the loss, the overhead, per-symbol or batched ingestion, the delivery
order, duplicates (and two malformed packets, which must be refused), the
IO backend (memory / file / mmap), the plan path (`force_structured` drops
both dense-W gates, `cache.WPATH_MAX_KP` and `WPATH_GF256_MAX_KP`, for the
trial) and the entry point (`repair_all` or `repair_block`).  So a seed
gives the JAX tool's configuration, its object and its packets.  Then it
draws the port's own fields from a generator of their own:

- `arm`: the backend of `repair_all` -- auto, device, res (only where the
  native factorization exists: without it the port's `res` raises by
  design), res_host or host;
- `lanes`: none, or a mesh of 1-4 lanes of the device
  (`parallel.mesh.make_mesh`), for the object path
  (`codec.batch.repair_symbols(mesh=)`, whose repair symbols must equal
  the per-block ones sent) and for `repair_all(mesh=)` (a mesh forces the
  device arm);
- `budget`: on a card, the byte budget of the device's replay program
  cache (`ops/program.py`) for the trial: the default, 4 MB or 1 byte (the
  cache keeps one program, so at 1 byte every new key evicts the one
  before).

A trial passes only if the decoded bytes equal the object; a failure
prints the whole configuration and the command that replays its seed.
Every 25 trials, and at the end, one JSON line: the trials, the program
counters (`replay_program_capture` / `_replay` / `_shared` / `_evict`,
`replay_compile_new` / `_hit`), the blocks per arm, and the card's name and
power limit.  On `--device cpu` the plain versions run in place of the
kernels and nothing is captured: a rehearsal.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

from nanorq_tpu_torch.bench import device_fields
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as cc
from nanorq_tpu_torch.codec.api import SYM_ERR, Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.device import resolve
from nanorq_tpu_torch.io.ioctx import FileIO, MemoryIO, MmapIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.ops import program
from nanorq_tpu_torch.parallel import mesh as lanes
from nanorq_tpu_torch.utils import stats

BASE_SEED = 7_000_000  # the JAX tool's
SHARED = ("seed", "size", "T", "Al", "Z", "N", "loss", "overhead", "batched", "shuffle", "dup_rate", "backend",
          "force_structured", "use_repair_all")  # the JAX tool's configuration
ARMS = ("auto", "device", "res", "res_host", "host")
BUDGETS = (None, 4 << 20, 1)  # bytes; None: the cache's own (env NANORQ_PROGRAM_CACHE_MB)
COUNTERS = ("replay_program_capture", "replay_program_replay", "replay_program_shared", "replay_program_evict",
            "replay_compile_new", "replay_compile_hit")
ARM_BLOCKS = {"device": "repair_device_blocks", "res": "repair_res_blocks", "res_host": "repair_res_host_blocks",
              "host": "repair_host_blocks"}
EVERY = 25  # trials between two counter lines


def _need(cond: bool, msg: str) -> None:
    """A trial's check: raises AssertionError, also under `python -O`."""
    if not cond:
        raise AssertionError(msg)


def draw(seed: int, device="cpu", **force) -> tuple[dict, np.random.Generator, float, float]:
    """(the trial's configuration, the generator its object and packets come
    from, the loss and the duplicate rate unrounded).  The JAX tool's fields come first, from its generator in its
    order; the port's (`arm`, `lanes`, `budget`) from a generator of their
    own, so that the object and the packets are the JAX tool's too.
    `force` sets port fields (chip_smoke's phase 13 asks for a 1-byte budget
    and for two lanes)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    size = int(rng.integers(1, 120_000))
    T = int(rng.choice([8, 17, 64, 100, 256, 512, 1280, 2048]))
    Al = int(rng.choice([1, 2, 4, 8]))
    Z = int(rng.choice([0, 1, 2, 3, 5]))
    N = int(rng.choice([1, 1, 1, 2, 4]))
    N = max(1, min(N, T // Al))  # sub-blocking needs N sub-symbols per symbol
    loss = float(rng.uniform(0, 0.45))
    overhead = int(rng.integers(0, 9))
    batched = bool(rng.random() < 0.5)
    shuffle = bool(rng.random() < 0.5)
    dup_rate = float(rng.uniform(0, 0.15))
    backend = str(rng.choice(["mem", "file", "mmap"]))
    force_structured = bool(rng.random() < 0.3)
    use_repair_all = bool(rng.random() < 0.4)
    cfg = dict(seed=seed, size=size, T=T, Al=Al, Z=Z, N=N, loss=round(loss, 3), overhead=overhead,
               batched=batched, shuffle=shuffle, dup_rate=round(dup_rate, 3), backend=backend,
               force_structured=force_structured, use_repair_all=use_repair_all)
    own = np.random.default_rng((seed, 1))
    arms = ARMS if native_available() else tuple(a for a in ARMS if a != "res")
    cfg["arm"] = str(own.choice(arms))
    cfg["lanes"] = int(own.integers(0, 5))
    budget = BUDGETS[int(own.integers(len(BUDGETS)))]
    cfg["budget"] = budget if dev.type == "cuda" else None
    cfg["device"] = str(dev)
    unknown = set(force) - {"arm", "lanes", "budget"}
    if unknown:
        raise ValueError(f"only the port's fields can be forced, not {sorted(unknown)}")
    cfg.update(force)
    return cfg, rng, loss, dup_rate


def run_trial(seed: int, device="cpu", **force) -> dict:
    """One round trip; returns its configuration, raises AssertionError
    where the port fails it."""
    cfg, rng, loss, dup_rate = draw(seed, device, **force)
    dev = resolve(device)
    size, T, overhead = cfg["size"], cfg["T"], cfg["overhead"]
    mesh = lanes.make_mesh([dev] * cfg["lanes"]) if cfg["lanes"] else None
    lru = program._lru(dev) if dev.type == "cuda" and cfg["budget"] is not None else None
    old = (cc.WPATH_MAX_KP, cc.WPATH_GF256_MAX_KP, None if lru is None else lru.budget)
    if cfg["force_structured"]:  # both W gates drop: hdpc-pivot patterns too take the structured path
        cc.WPATH_MAX_KP = cc.WPATH_GF256_MAX_KP = 0
    if lru is not None:
        lru.budget = cfg["budget"]
    tmp = None
    try:
        data = rng.integers(0, 256, size, dtype=np.uint8)
        enc = Encoder(size, T, Al=cfg["Al"], Z=cfg["Z"], N=cfg["N"], device=dev)
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=dev)
        # tiny blocks with heavy loss, overhead and retries can push repair
        # ESIs past the default max_esi = 2*K': raise it as a receiver would
        _need(dec.set_max_esi(min((1 << 24) - 1, 8 * dec.P.Kp + 256)), "max_esi refused")
        io_in = MemoryIO(data)
        if cfg["backend"] == "mem":
            out = np.zeros(size, np.uint8)
            io_out = MemoryIO(out)
        else:
            tmp = tempfile.NamedTemporaryFile(delete=False)
            tmp.close()
            io_out = (FileIO(tmp.name, write=True, create_size=size) if cfg["backend"] == "file"
                      else MmapIO(tmp.name, write=True, create_size=size))

        packets, drops, sent = [], {}, []  # (tag, payload); sbn -> (dropped, dropped + overhead)
        for sbn in range(enc.num_blocks):
            K = enc.block_symbols(sbn)
            kept = [e for e in range(K) if rng.random() >= loss]
            dropped = K - len(kept)
            esis = kept + list(range(K, K + dropped + overhead))
            pl = enc.encode_batch(sbn, np.array(esis), io_in)
            sent.append((sbn, np.array(esis, np.int64), pl))
            for esi, p in zip(esis, pl):
                packets.append((make_tag(sbn, esi), p))
                if rng.random() < dup_rate:
                    packets.append((make_tag(sbn, esi), p))
            drops[sbn] = (dropped, dropped + overhead)
        if cfg["shuffle"]:
            order = rng.permutation(len(packets))
            packets = [packets[i] for i in order]
        bad = [(make_tag(enc.num_blocks + 3, 0), packets[0][1]),  # a block past the object
               (packets[0][0], packets[0][1][: max(1, enc.symbol_size // 2)])]  # a short payload

        _object_repairs(enc, data, sent, dev, mesh)

        if cfg["batched"]:
            tags = np.array([t for t, _ in packets], np.int64)
            sts = dec.add_symbols(np.stack([p for _, p in packets]), tags, io_out)
            _need(all(s != SYM_ERR for s in sts), "a valid packet was refused")
            for t, p in bad:
                _need(dec.add_symbol(np.ascontiguousarray(p), t, io_out) == SYM_ERR, "a malformed packet was taken")
        else:
            for t, p in packets:
                _need(dec.add_symbol(p.tobytes(), t, io_out) != SYM_ERR, "a valid packet was refused")
            for t, p in bad:
                _need(dec.add_symbol(p.tobytes(), t, io_out) == SYM_ERR, "a malformed packet was taken")

        def feed_more(sbn, start, n):
            esis = list(range(start, start + n))
            for esi, p in zip(esis, enc.encode_batch(sbn, np.array(esis), io_in)):
                dec.add_symbol(p.tobytes(), make_tag(sbn, esi), io_out)

        if cfg["use_repair_all"]:
            def repair():
                return dec.repair_all(io_out, mesh=mesh, backend=cfg["arm"])

            ok, tries = repair(), 0
            while not ok and tries < 5:  # the fountain: more repair symbols for the blocks short of them
                for sbn in range(enc.num_blocks):
                    if dec.num_missing(sbn):
                        feed_more(sbn, enc.block_symbols(sbn) + drops[sbn][1] + 4 * tries, 4)
                ok, tries = repair(), tries + 1
            _need(ok, "repair_all unrecoverable")
        else:
            for sbn in range(enc.num_blocks):
                ok, tries = dec.repair_block(io_out, sbn), 0
                while not ok and tries < 5:
                    feed_more(sbn, enc.block_symbols(sbn) + drops[sbn][1] + 4 * tries, 4)
                    ok, tries = dec.repair_block(io_out, sbn), tries + 1
                _need(ok, f"sbn={sbn} unrecoverable")

        if cfg["backend"] == "mem":
            got = out
        else:
            io_out.close()
            got = np.fromfile(tmp.name, np.uint8)
        _need(got.size == size and np.array_equal(got, data), "the decoded bytes differ from the object")
        return cfg
    finally:
        cc.WPATH_MAX_KP, cc.WPATH_GF256_MAX_KP = old[:2]
        if lru is not None:
            lru.budget = old[2]
        if tmp is not None:
            os.unlink(tmp.name)


def _object_repairs(enc: Encoder, data: np.ndarray, sent: list, dev, mesh) -> None:
    """The object path (`codec.batch`, over the mesh's lanes where there is
    one) gives every block the repair symbols its `encode_batch` sent."""
    n = max((int(e.max()) - enc.block_symbols(s) + 1 for s, e, _ in sent), default=0)
    if n <= 0:
        return
    reps = tbatch.repair_symbols(tbatch.load_object(enc, MemoryIO(data)), n, dev, mesh=mesh)
    for sbn, esis, pl in sent:
        rep = esis >= enc.block_symbols(sbn)
        _need(np.array_equal(reps[sbn][esis[rep] - enc.block_symbols(sbn)], pl[rep]),
              f"sbn={sbn}: the object path's repair symbols differ from encode_batch's")


def counters() -> dict:
    """The program counters and the blocks each arm repaired, from `utils.stats`."""
    c = stats.snapshot()["counters"]
    return {**{k: c.get(k, 0) for k in COUNTERS},
            "blocks_per_arm": {arm: c.get(name, 0) for arm, name in ARM_BLOCKS.items()}}


def soak(seed: int, device, minutes: float | None = None, trials: int | None = None, forced=(),
         quiet: bool = False) -> dict:
    """Trials from `seed` up until `minutes` or `trials` have passed; the
    `forced` port fields go to the first trials in turn.  Returns the last
    counter line (every trial bit-exact); raises at the first failure."""
    dev = resolve(device)
    fields = device_fields(dev)
    before = counters()
    end = None if minutes is None else time.monotonic() + 60 * minutes
    t0, n = time.perf_counter(), 0

    def emit(last: bool) -> dict:
        now = counters()
        d = {k: now[k] - before[k] for k in COUNTERS}
        arms = {a: now["blocks_per_arm"][a] - before["blocks_per_arm"][a] for a in ARM_BLOCKS}
        out = {"tool": "longfuzz", "trials": n, "first_seed": seed, "bit_exact": True, "done": last,
               "seconds": round(time.perf_counter() - t0, 2), **d, "blocks_per_arm": arms, **fields}
        if not quiet:
            print(json.dumps(out), flush=True)
        return out

    while (trials is None or n < trials) and (end is None or time.monotonic() < end):
        s = seed + n
        force = forced[n] if n < len(forced) else {}
        try:
            run_trial(s, dev, **force)
        except Exception as e:
            cfg = draw(s, dev, **force)[0]
            print(f"FUZZ FAILURE at seed={s}: {e!r}\n  config: {json.dumps(cfg)}\n  replay: python -m "
                  f"nanorq_tpu_torch.tools.longfuzz --seed {s} --trials 1 --device {device}"
                  + "".join(f" (forced {k}={v})" for k, v in force.items()), flush=True)
            raise
        n += 1
        if n % EVERY == 0:
            emit(False)
    return emit(True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=None, help="default 30, unless --trials is given")
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--seed", type=int, default=BASE_SEED)
    ap.add_argument("--device", default="cuda", help="cuda (the kernels, the program cache) or cpu (a rehearsal)")
    args = ap.parse_args(argv)
    minutes = 30.0 if args.minutes is None and args.trials is None else args.minutes
    return soak(args.seed, args.device, minutes, args.trials)


if __name__ == "__main__":
    main()
