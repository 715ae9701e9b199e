"""The default path's width slices: a warm object encode over S slices against
the unsliced one, per object shape, and where the copies overlap the kernels.

    NANORQ_PROGRAM_CACHE_MB=16384 python -m nanorq_tpu_torch.tools.pipe_sweep \
        [--points 1000:8 1000:209 50000:4] [--slices 1 2 4] [--rounds 5] [--profile]

A point K:Z is an object of Z blocks of K symbols of T bytes (width t = Z*T),
held as `codec.batch.load_object` holds it (pinned [K, t] on a card).  For
each S, `codec.batch.generate` + `repair_symbols` (K // 5 repair symbols a
block) over `parallel.mesh.slice_mesh(dev, S)` (S = 1: the one lane of
`local_mesh`, the unsliced default path) -- the lanes the default path takes
where its rule says S -- twice to warm (the first runs eagerly, the second
captures each lane's program), then `--rounds` rounds of one encode per S,
each round starting one S later, host clock with a wait after each.  Every
S must give the unsliced path's repair symbols bit for bit (raises if not).
S values whose slices would not be whole blocks (t // T < S) are skipped.
`rule` is the S the default path takes for the object on a card
(`parallel.mesh.slice_count`).

One JSON line per point: `ms` per S (every round), `median_ms`, `spread`
((max - min) / median), `best` (the S of the least median), `evicted` (the
program evictions during the timed rounds: give the cache room, as above,
or they are captures inside the timing), `programs_MB` after the point, and
the card's name and power limit.  With `--profile`, per S one more warm
encode under torch.profiler: `htod_ms` (the union of the host-to-device
copies), `htod_overlap_ms` (the part of it during which a kernel ran),
`device_ms` (the union of all device activity) and `kernel_sum_ms` (kernel
durations summed, which counts overlapping kernels twice).

On `--device cpu` a rehearsal at a tiny size with the host clock: CPU lanes
run one after another, so nothing overlaps and no number is a device one.
"""

import argparse
import json
import time

import numpy as np
import torch

from nanorq_tpu_torch.bench import device_fields
from nanorq_tpu_torch.device import resolve

SEED = 15
POINTS = ("1000:8", "1000:32", "1000:64", "1000:128", "1000:209", "10000:4", "50000:4")
SLICES = (1, 2, 3, 4, 6, 8)


def _union(spans) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _length(spans) -> float:
    return sum(b - a for a, b in spans)


def _meet(xs, ys) -> float:
    """The length of the intersection of two merged interval lists."""
    i = j = 0
    got = 0.0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        got += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return got


def overlap(events) -> dict:
    """Of a torch.profiler trace's device events (`prof.events()`), in ms:
    `htod_ms`, the union of the host-to-device copies; `htod_overlap_ms`,
    the part of it during which a kernel ran; `device_ms`, the union of all
    device activity; `kernel_sum_ms`, the kernels' durations summed."""
    copies, kernels_, every = [], [], []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        every.append(span)
        if e.name.startswith("Memcpy HtoD"):
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels_.append(span)
    htod, kern = _union(copies), _union(kernels_)
    return {"htod_ms": _length(htod) / 1e3, "htod_overlap_ms": _meet(htod, kern) / 1e3,
            "device_ms": _length(_union(every)) / 1e3,
            "kernel_sum_ms": sum(b - a for a, b in kernels_) / 1e3}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _evictions() -> int:
    from nanorq_tpu_torch.utils import stats

    return stats.snapshot()["counters"].get("replay_program_evict", 0)


def point(K: int, Z: int, T: int, slices, rounds: int, dev, profile: bool = False) -> dict:
    """One point's line (see the module's doc)."""
    from nanorq_tpu_torch.codec import batch as tbatch
    from nanorq_tpu_torch.codec import cache as tcache
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.ops import program
    from nanorq_tpu_torch.parallel import mesh as lanes

    t = Z * T
    enc = Encoder(Z * K * T, T, Al=8, Z=Z, device=dev)
    if enc.num_blocks != Z or any(enc.block_symbols(b) != K for b in range(Z)):
        raise ValueError(f"the scheme of {Z} x {K} x {T} is not {Z} blocks of K={K}")
    ds = tcache.encoder_schedule(enc.P.Kp)
    D = lanes.host_matrix(K, ds.M_pad, t, dev)
    D[:K] = np.random.default_rng(SEED + K + Z).integers(0, 256, (K, t), dtype=np.uint8)
    batch = tbatch.ObjectBatch(enc=enc, sbns=list(range(Z)), Ks=np.full(Z, K, np.int64), D=D)
    n_repair = max(1, K // 5)
    ss = [s for s in slices if t // T >= s]
    meshes = {s: lanes.local_mesh(dev) if s == 1 else lanes.slice_mesh(dev, s) for s in ss}

    def encode(s):
        batch.C = None
        tbatch.generate(batch, dev, mesh=meshes[s])
        return tbatch.repair_symbols(batch, n_repair, dev, mesh=meshes[s])

    want = None
    for s in ss:  # cold (eager) and the programs' capture, each checked
        for _ in range(2):
            got = encode(s)
            if want is None:
                want = got
            if not all(np.array_equal(got[b], want[b]) for b in range(Z)):
                raise AssertionError(f"K={K} Z={Z}: {s} slices give other repair symbols than 1")
    evict0 = _evictions()
    ms = {s: [] for s in ss}
    for r in range(rounds):
        for s in ss[r % len(ss):] + ss[: r % len(ss)]:
            _sync(dev)
            t0 = time.perf_counter()
            encode(s)
            _sync(dev)
            ms[s].append(round((time.perf_counter() - t0) * 1e3, 4))
    line = {"tool": "pipe_sweep", "K": K, "Kp": enc.P.Kp, "Z": Z, "T": T, "t": t, "n_repair": n_repair,
            "slices": ss, "ms": {str(s): v for s, v in ms.items()},
            "median_ms": {str(s): float(np.median(v)) for s, v in ms.items()},
            "spread": {str(s): round((max(v) - min(v)) / float(np.median(v)), 4) for s, v in ms.items()}}
    line["best"] = int(min(ss, key=lambda s: line["median_ms"][str(s)]))
    line["rule"] = lanes.slice_count(t, T, K)  # what the default path takes on a card
    line["evicted"] = _evictions() - evict0
    if profile and dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as _profile

        prof = {}
        for s in ss:
            p = _profile(activities=[ProfilerActivity.CUDA])
            _sync(dev)
            with p:
                encode(s)
                _sync(dev)
            prof[str(s)] = {k: round(v, 4) for k, v in overlap(p.events()).items()}
        line["profile"] = prof
    batch.C = None
    line["programs_MB"] = round(program.cached_bytes() / 2**20, 1)
    return line


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", nargs="+", default=list(POINTS), help="K:Z of each object")
    ap.add_argument("--slices", nargs="+", type=int, default=list(SLICES))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--T", type=int, default=1280)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (timed on the card) or cpu (a rehearsal, host clock)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    fields = device_fields(dev)
    lines = []
    for spec in args.points:
        K, Z = (int(x) for x in spec.split(":"))
        line = {**point(K, Z, args.T, args.slices, args.rounds, dev, args.profile), **fields}
        print(json.dumps(line), flush=True)
        lines.append(line)
        if dev.type == "cuda":
            from nanorq_tpu_torch.ops import program

            program.release(dev)  # the next point's programs start from an empty cache
            torch.cuda.empty_cache()
    return lines


if __name__ == "__main__":
    main()
