"""One cell, run once: set-up, the measured window, and the check.

A cell is a configuration (`rqbench/configs/<config>.json`: K, T, Al and the
bulk object's blocks) under a traffic mix (`rqbench/traffic/<mix>.json`, read
by `traffic.py`).  The window drives nanorq_tpu_torch through its public
entries with its defaults, one caller back to back (a closed loop):

- a sender: `Encoder`, `codec.batch.load_object`, `generate`,
  `repair_symbols`;
- a receiver: a fresh `Decoder` an object and, block by block, `add_symbols`
  a burst, then `repair_block`, writing the object into host memory (a
  `MemoryIO`): the per-block receive loop of the project's README.

Objects cycle through a pool made from the seed in set-up.  The window
opens after the warm-up and closes when the last object begun before
`seconds` had passed is done, so rates are over whole objects.  Every timed
call sits in a span of its own (`Run.spans`); with `trace`, the same spans are
`record_function` ranges of torch.profiler's trace (`trace.py`).

The check (`Cell.check`), once the window has closed: every object's sender
output is sampled (the first and last block and a draw of others from the
seed, copied out as the object is done) and the last object kept whole;
every object's receiver output is sampled (lost and received rows of a like
draw of blocks) and the last three kept whole, in a ring of three output
buffers, so that an object never finds its own bytes left from before.  The
pool objects are the decoded bytes' reference.  The repair symbols'
reference is the plain reference (`reference/rfc6330.py`) where it solves
the block itself (`solvable`: up to L = SOLVE_MAX_L); above, the program's
sender encodes each pool object once more after the window, and the
reference proves its intermediate symbols the RFC's by the constraint rows
and takes their LT symbols (`Cell.certify`: a certificate checked, not an
input trusted).  A receiver's packets come from the program's sender in
set-up and are held to the RFC the same way, so that a sender and a
receiver that are wrong in the same way do not pass.
"""

import json
import time
import traceback
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from rqbench import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
RING = 3  # output buffers of a receiver: each gets the pool's objects in turn
SAMPLE_BLOCKS = 16  # blocks of every object sampled for the check, beyond the first and last
SAMPLE_LOST = 64  # lost rows of a sampled block that a receiver's output is checked at
SAMPLE_KEPT = 16  # rows of a sampled block drawn from all of them, received or lost
SOLVE_MAX_L = 4096  # the reference's Gauss-Jordan (O(L^3)) serves blocks up to this L


def solvable(K: int) -> bool:
    """Whether the reference solves a block of K itself; above, the check
    proves the program's intermediate symbols instead (`Cell.certify`)."""
    from rqbench.reference import rfc6330

    return rfc6330.params(K).L <= SOLVE_MAX_L


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(spec: dict, workload: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(the workload's entry, its configuration, its traffic mix)."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = traffic.load(root / c["file"])
    mix = traffic.load(HERE / "traffic" / f"{w['traffic']}.json")
    return w, cfg, mix


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    cfg: dict
    mix: dict
    K: int
    T: int
    Z: int  # blocks an object
    n_repair: int
    overhead: int
    objects: list = field(default_factory=list)  # per object: a dict
    spans: list = field(default_factory=list)  # (name, object, t0, t1), host seconds
    counters: dict = field(default_factory=dict)  # program counters, the window's increase
    trace: object = None  # trace.Trace of a --trace 1 run
    setup_s: float = 0.0
    window_s: float = 0.0

    def per_object_s(self, names) -> list:
        tot: dict = {}
        for n, i, t0, t1 in self.spans:
            if n in names:
                tot[i] = tot.get(i, 0.0) + t1 - t0
        return [tot[i] for i in sorted(tot)]


class Cell:
    """Set-up, window and check of one cell on one device.  `encode` and
    `decode` are the sender and receiver under test (the program's by
    default; the control and the fault tests put others in their place)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, trace: bool = False):
        from nanorq_tpu_torch.codec import batch as tbatch
        from nanorq_tpu_torch.codec.api import Decoder, Encoder
        from nanorq_tpu_torch.io.ioctx import MemoryIO

        self.tbatch, self.Encoder, self.Decoder, self.MemoryIO = tbatch, Encoder, Decoder, MemoryIO
        self.device = torch.device(device)
        self.cfg, self.mix, self.seed, self.trace = cfg, mix, seed, trace
        self.K, self.T, self.Al = cfg["K"], cfg["T"], cfg["Al"]
        self.Z = cfg["bulk_blocks"]
        self.F = self.Z * self.K * self.T
        self.role = mix["role"]
        if self.role not in ("send", "receive"):
            raise ValueError(f"unknown role {self.role!r}")
        self.n = traffic.n_repair(mix, self.K)
        self.ov = traffic.overhead(mix, self.K)
        self.burst = mix.get("burst")  # a receiver's
        self.lost = traffic.lost_esis(mix, self.K, np.random.default_rng([seed, 1]))
        self.sampler = np.random.default_rng([seed, 2])
        self.run = Run(cfg=cfg, mix=mix, K=self.K, T=self.T, Z=self.Z, n_repair=self.n, overhead=self.ov)
        self.encode, self.decode = self.program_encode, self.program_decode
        self.enc_samples, self.dec_samples, self.held = [], [], {}
        self.failed_objects: set = set()
        self.errors: list = []
        self.seq = 0  # objects begun, warm-up included: picks the pool object and the output buffer
        self._nb = None  # the reference's neighbours of ISIs 0 .. K'+n-1, once the check needs them

    # --- set-up -------------------------------------------------------------

    def make_pool(self) -> None:
        """The pool's objects, from the seed, made on the device in one call each."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed)
        self.pool = [torch.randint(0, 256, (self.F,), dtype=torch.uint8, device=self.device, generator=g)
                     .cpu().numpy() for _ in range(self.mix["pool"])]
        enc = self.Encoder(self.F, self.T, Al=self.Al, Z=self.Z, device=self.device)
        if enc.num_blocks != self.Z or any(enc.block_symbols(b) != self.K for b in range(self.Z)):
            raise ValueError(f"the scheme is not {self.Z} blocks of K={self.K}")
        self.oti = (enc.oti_common(), enc.oti_scheme_specific())
        if self.role == "receive":
            self.ring = [np.zeros(self.F, np.uint8) for _ in range(RING)]
            self.streams, self.pool_C, self.pool_rep = [], [], []
            for obj in self.pool:
                rep, C = self.pool_encode(obj)
                s = traffic.Stream(self.Z, self.K, self.n, [self.lost] * self.Z, self.ov)
                self.streams.append((s, s.payloads(np.concatenate([obj.reshape(-1, self.T), rep]))))
                self.pool_C.append(C)
                self.pool_rep.append(rep)

    def pool_encode(self, obj: np.ndarray):
        """A pool object through the program's sender, outside the window:
        (repair rows [Z*n, T], block-major; the intermediate symbols C
        [L, Z*T], block b in columns b*T.., for the check)."""
        enc = self.Encoder(self.F, self.T, Al=self.Al, Z=self.Z, device=self.device)
        batch = self.tbatch.load_object(enc, self.MemoryIO(obj))
        C = self.tbatch.generate(batch, self.device)
        rep = _Blocks(self.tbatch.repair_symbols(batch, self.n, self.device), self.Z).reshape(-1, self.T)
        C = C if isinstance(C, torch.Tensor) else C.gather(self.device)  # a Sharded over slices
        return rep, C.cpu().numpy()

    def warm_up(self) -> None:
        for i in range(self.mix["warmup"]):
            self.one(i, check=False)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # --- the sender and receiver under test ----------------------------------

    @contextmanager
    def span(self, name: str, i):
        rec = torch.profiler.record_function("rq." + name) if self.trace else nullcontext()
        with rec:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if i is not None:
                    self.run.spans.append((name, i, t0, time.perf_counter()))

    def program_encode(self, enc, obj: np.ndarray, i):
        """The program's sender: repair symbols [Z, n, T] in host memory."""
        with self.span("load", i):
            batch = self.tbatch.load_object(enc, self.MemoryIO(obj))
        with self.span("generate", i):
            self.tbatch.generate(batch, self.device)
        with self.span("repair_symbols", i):
            rep = self.tbatch.repair_symbols(batch, self.n, self.device)
        return _Blocks(rep, self.Z)

    def program_decode(self, dec, stream, payloads, out: np.ndarray, i) -> bool:
        """The program's receiver: the object written into `out`, block by block."""
        io = self.MemoryIO(out)
        ok = True
        for sbn, bursts in stream.blocks(payloads, self.burst):
            with self.span("ingest", i):
                for p, t in bursts:
                    dec.add_symbols(p, t, io)
            with self.span("repair", i):
                ok = dec.repair_block(io, sbn) and ok
        return ok

    # --- one object ---------------------------------------------------------

    def one(self, i: int, check: bool = True) -> dict:
        """Object i of the window (or of the warm-up, `check` False).  The
        pool's objects take turns, and so do the RING output buffers: as RING
        is odd, a buffer's last object is always another pool object."""
        seq, self.seq = self.seq, self.seq + 1
        p = seq % len(self.pool)
        obj = self.pool[p]
        rec = {"i": i, "pool": p, "bytes": self.F}
        key = i if check else None
        if self.role == "send":
            with self.span("new_encoder", key):
                enc = self.Encoder(self.F, self.T, Al=self.Al, Z=self.Z, device=self.device)
            t0 = time.perf_counter()
            rep = self.encode(enc, obj, key)
            rec["enc_s"] = time.perf_counter() - t0
            if check:
                self.sample_sender(i, p, rep)
        else:
            stream, payloads = self.streams[p]
            rec["lost"] = [g.size for g in stream.lost]
            slot = seq % RING
            out = self.ring[slot]
            with self.span("new_decoder", key):
                dec = self.Decoder(*self.oti, device=self.device)
            t0 = time.perf_counter()
            ok = self.decode(dec, stream, payloads, out, key)
            rec["dec_s"] = time.perf_counter() - t0
            rec["ok"] = bool(ok)
            if check:
                if not ok:
                    self.failed_objects.add(i)
                self.sample_receiver(i, p, stream, out, slot)
        return rec

    # --- samples for the check ------------------------------------------------

    def pick_blocks(self) -> np.ndarray:
        """The first and last block and SAMPLE_BLOCKS more, drawn from the seed."""
        inner = np.arange(1, self.Z - 1)
        return np.unique(np.r_[0, self.Z - 1, self.sampler.choice(inner, min(SAMPLE_BLOCKS, inner.size), replace=False)])

    def sample_sender(self, i: int, p: int, rep) -> None:
        pick = self.pick_blocks()
        self.enc_samples.append((i, p, pick, np.stack([np.asarray(rep[b]) for b in pick])))
        self.held["enc"] = (i, p, rep)  # the last object's output, checked whole

    def sample_receiver(self, i: int, p: int, stream, out: np.ndarray, slot: int) -> None:
        rows = out.reshape(self.Z, self.K, self.T)
        for b in self.pick_blocks():
            lost = stream.lost[b]
            la = lost if lost.size <= SAMPLE_LOST else self.sampler.choice(lost, SAMPLE_LOST, replace=False)
            esis = np.concatenate([la, self.sampler.integers(0, self.K, SAMPLE_KEPT)])
            self.dec_samples.append((i, p, b, esis, rows[b, esis]))
        self.held[("dec", slot)] = (i, p)

    # --- the window -----------------------------------------------------------

    def window(self, seconds: float) -> None:
        from nanorq_tpu_torch.utils import stats

        before = dict(stats.snapshot()["counters"])
        i = 0
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
        try:
            with torch.profiler.record_function("rq.window") if self.trace else nullcontext():
                t_open = time.perf_counter()
                deadline = t_open + seconds
                while time.perf_counter() < deadline:
                    try:
                        self.run.objects.append(self.one(i))
                    except Exception:  # a crash is a failed object; the run stops and reports it
                        self.failed_objects.add(i)
                        self.errors.append(traceback.format_exc())
                        self.run.objects.append({"i": i, "bytes": 0, "crashed": True})
                        break
                    i += 1
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.run.window_s = time.perf_counter() - t_open
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        after = stats.snapshot()["counters"]
        self.run.counters = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        if prof is not None:
            self.run.trace = _read_trace(prof)

    # --- the check ------------------------------------------------------------

    def release(self) -> None:
        """Drop what the program holds, once the peak has been read."""
        self.streams = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """{name: (value, limit)} of the numbers compared."""
        out = {}
        if self.role == "send":
            if solvable(self.K):
                want = self.expected_repair()
            else:  # the program's intermediate symbols of each pool object, proven the RFC's
                c_miss, want = self.certified_repair()
                out["enc_c_wrong_bytes"] = (c_miss, 0)
            out["enc_wrong_bytes"] = (self.check_sender(want), 0)
        else:
            out["packet_c_wrong_bytes"], out["packet_wrong_bytes"] = ((v, 0) for v in self.check_packets())
            out["dec_wrong_bytes"] = (self.check_receiver(), 0)
            out["dec_false"] = (sum(1 for o in self.run.objects if o.get("ok") is False), 0)
        out["crashed"] = (sum(1 for o in self.run.objects if o.get("crashed")), 0)
        return out

    def verdict(self, checks: dict) -> bool:
        """`correct`: objects were done, none failed, every number within its limit."""
        return bool(self.run.objects) and not self.failed_objects and all(v <= lim for v, lim in checks.values())

    def expected_repair(self) -> list:
        """The reference's repair symbols [Z, n, T] of each pool object, from its encoding map."""
        from rqbench.reference import rfc6330

        P = rfc6330.params(self.K)
        M = rfc6330.encoding_map(P, self.n, self.device)
        return [rfc6330.repair_symbols(P, obj.reshape(self.Z, self.K, self.T), self.n, self.device, M)
                for obj in self.pool]

    def certified_repair(self) -> tuple[int, list]:
        """Where the reference cannot solve the block: (the bytes by which the
        program's intermediate symbols of the pool objects miss the RFC's
        constraint rows, the RFC's repair symbols [Z, n, T] of each object,
        the LT symbols of those intermediate symbols)."""
        miss, want = 0, []
        for obj in self.pool:
            _, C = self.pool_encode(obj)
            m, lt = self.certify(obj, C)
            miss += m
            want.append(lt)
        return miss, want

    def certify(self, obj: np.ndarray, C: np.ndarray) -> tuple[int, np.ndarray]:
        """(the bytes of A C that miss what RFC 6330 s5.3.3.3 requires of the
        object's source symbols, the LT symbols [Z, n, T] of C at the repair
        ISIs K' .. K'+n-1).  A is regular, so a miss of 0 proves C the RFC's
        intermediate symbols, and the LT symbols then the RFC's repair symbols."""
        from rqbench.reference import rfc6330

        P = rfc6330.params(self.K)
        if self._nb is None:
            self._nb = rfc6330.neighbors(P, np.arange(P.Kp + self.n))
        src = np.ascontiguousarray(obj.reshape(self.Z, self.K, self.T).transpose(1, 0, 2)).reshape(self.K, -1)
        C = torch.from_numpy(C).to(self.device)
        miss = rfc6330.constraint_misses(P, C, torch.from_numpy(src).to(self.device), self._nb[: P.Kp])
        lt = rfc6330.xor_rows(C, self._nb[P.Kp :]).cpu().numpy()
        return miss, lt.reshape(self.n, self.Z, self.T).transpose(1, 0, 2)

    def check_sender(self, want: list) -> int:
        wrong = 0
        for i, p, pick, got in self.enc_samples:
            bad = int((got != want[p][pick]).sum())
            wrong += bad
            if bad:
                self.failed_objects.add(i)
        if "enc" in self.held:
            i, p, rep = self.held["enc"]
            bad = sum(int((np.asarray(rep[b]) != want[p][b]).sum()) for b in range(self.Z))
            wrong += bad
            if bad:
                self.failed_objects.add(i)
        return wrong

    def check_packets(self) -> tuple[int, int]:
        """(the bytes by which the pool's intermediate symbols miss the RFC's
        constraint rows, the bytes of its repair packets that differ from
        the RFC's LT symbols of those intermediate symbols), over every block
        of every pool object."""
        c_miss = rep_miss = 0
        for obj, C, rep in zip(self.pool, self.pool_C, self.pool_rep):
            m, lt = self.certify(obj, C)
            c_miss += m
            rep_miss += int((lt != rep.reshape(self.Z, self.n, self.T)).sum())
        return c_miss, rep_miss

    def check_receiver(self) -> int:
        wrong = 0
        for i, p, b, esis, got in self.dec_samples:
            bad = int((got != self.pool[p].reshape(self.Z, self.K, self.T)[b, esis]).sum())
            wrong += bad
            if bad:
                self.failed_objects.add(i)
        for k, v in self.held.items():
            if isinstance(k, tuple) and k[0] == "dec":
                i, p = v
                bad = int((self.ring[k[1]] != self.pool[p]).sum())
                wrong += bad
                if bad:
                    self.failed_objects.add(i)
        return wrong


class _Blocks:
    """A sender's output {block: [n, T]} (the program's `repair_symbols`
    dict), indexable by block and reshapable to [Z, n, T] for the packets."""

    def __init__(self, rep, Z: int):
        self.rep, self.Z = rep, Z

    def __getitem__(self, b):
        return self.rep[int(b)]

    def reshape(self, *shape):
        return np.stack([np.asarray(self.rep[b]) for b in range(self.Z)]).reshape(*shape)


def _read_trace(prof):
    import os
    import tempfile

    from rqbench.trace import Trace

    fd, path = tempfile.mkstemp(suffix=".json", prefix="rqbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_file(path)
    finally:
        os.unlink(path)
