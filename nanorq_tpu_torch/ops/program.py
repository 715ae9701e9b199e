"""The structured replay as one captured CUDA graph per schedule: the port's
counterpart of the JAX package's compiled replay program (`_replay_jit`).

JAX compiles the replay of a schedule into one XLA program and dispatches it
once.  The counterpart on the card is a CUDA graph replayed once: `replay`
runs `ops/replay.prologue` (the two gathers that read D, into buffers the
program owns), one `graph.replay()` of the captured `ops/replay.body`
(stages 1-4: the trisolve, the bsel plan, HDPC, Vinv, Wut) and
`ops/replay.epilogue` (stage 5, into a fresh C).  Neither D nor C is an
address of the graph, so a caller may pass any D and keeps its own C; the
prologue and the epilogue are 3 launches outside it.

A program belongs to (the schedule's per-device arrays, the width t, the
stream).  It is kept in the arrays dict (`arr["programs"]`), so it dies with
them; and two lanes of one card, a stream each, never replay one graph and
its buffers at once.  Every schedule is captured at the second replay of a
(t, stream) key: repeated traffic (warm encodes, the per-block
`Encoder.generate_symbols` at t = T, a warm decode pattern) gets its program
after one eager call, and a call met once (a one-shot encode of an object,
whose width is Z*T; a cold decode pattern) runs eagerly and captures
nothing.  The JAX package shares one program across the decode patterns of
one canonical signature; the port captures one per schedule
(`replay_compile_new` / `replay_compile_hit` count how often signatures
repeat).

The call that captures runs the body eagerly into the program's buffers (the
warm call, and this call's result), then captures the body on a side stream.
Nothing is created inside the capture: `kernels.prepare` runs first.  The
captured launches do not count where they are captured (`kernels.tape`);
each replay adds them (`kernels.play`), so the launch counts are those of
the eager replay.

A program holds its buffers (y and z are [~L, t] each: about 0.7 GB at
K=1000, t = 256000) and its graph's private pool for as long as it is
cached.  Each device's programs together are bounded by bytes (env
NANORQ_PROGRAM_CACHE_MB per device, default 4096): the least recently
replayed is evicted first, and an evicted program frees its graph, pool and
buffers.  When a card runs out of memory in a replay or in an upload of the
lanes (`parallel/mesh.stage`, `upload`), that card's other programs are
evicted and the call is made once more (`reclaiming`); an allocation
elsewhere may call `release(device)` first.  Counters in `utils.stats`:
replay_program_capture, replay_program_replay, replay_program_evict; the
capture's host time is the timer replay_program_capture_s.

Nothing is captured on the CPU: the replay runs eagerly there (JAX on the
CPU, too, dispatches the same ops).  A caller that is capturing a graph
itself (`torch.cuda.is_current_stream_capturing()`) gets the eager replay,
in its own graph.  A failed capture or replay raises: nothing runs eagerly in
place of a program.  The LT combine (2 launches an encode), the dense-W step
(one K1 and one K2, `ops/wpath.w_apply_gf2_batch`) and the residual product
(K3) stay eager: a few launches each.
"""

import contextlib
import functools
import itertools
import os
import time
import weakref

import torch

from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.ops import replay as _replay
from nanorq_tpu_torch.utils import stats
from nanorq_tpu_torch.utils.lru import ByteLRU

BUDGET = int(float(os.environ.get("NANORQ_PROGRAM_CACHE_MB", 4096)) * (1 << 20))  # per device


class Program:
    """One schedule's body captured at one width for one stream: the buffers
    it owns, its graph, the launches each replay runs (`kernels.Tape`), its
    bytes and the host seconds its capture took."""

    __slots__ = ("graph", "buf", "tape", "nbytes", "capture_s", "token", "__weakref__")


class Programs(dict):
    """(t, stream) -> Program, kept in a schedule's per-device arrays.
    `calls` counts each key's replays before its capture."""

    def __init__(self):
        super().__init__()
        self.calls = {}


def _evicted(token, entry) -> None:
    """Drop an evicted program from its arrays' programs: the last reference."""
    owner, key = entry
    progs = owner()
    if progs is not None:
        progs.pop(key, None)


_caches: dict = {}  # device -> ByteLRU: token -> (weakref to Programs, key)
_tokens = itertools.count()
_side: dict = {}  # device -> the stream captures run on


def _lru(device: torch.device) -> ByteLRU:
    lru = _caches.get(device)
    if lru is None:
        lru = _caches[device] = ByteLRU(BUDGET, "replay_program", on_evict=_evicted)
    return lru


def _dev(device) -> torch.device:
    dev = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


def cached_bytes(device=None) -> int:
    """Bytes the cached programs hold on `device` (default: on every device)."""
    return sum(lru.bytes for dev, lru in list(_caches.items()) if device is None or dev == _dev(device))


def release(device, keep: int | None = None) -> int:
    """Evict every program on `device` but the one whose token is `keep`;
    returns the bytes they held."""
    lru = _caches.get(_dev(device))
    return 0 if lru is None else lru.evict(keep)


def reclaiming(fn, device: torch.device, keep: int | None = None):
    """fn(), and where the card is out of memory, fn() once more after
    `release(device, keep)`; raises when there was nothing to release."""
    try:
        return fn()
    except torch.OutOfMemoryError:
        if not release(device, keep):
            raise
    return fn()  # outside the handler: the failed call's frames, and what they held, are gone


def empty(shape: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.empty on `device`, reclaiming the card's programs where it is
    out of memory."""
    return reclaiming(lambda: torch.empty(shape, dtype=dtype, device=device), device)


def capture(fn, device: torch.device) -> tuple:
    """fn()'s launches on `device` captured into a CUDA graph on a side
    stream: (graph, bytes its private pool reserved)."""
    side = _side.get(device)
    if side is None:
        side = _side[device] = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        except BaseException:
            with contextlib.suppress(Exception):  # end the broken capture; raise what broke it
                graph.capture_end()
            raise
        graph.capture_end()
    return graph, max(0, torch.cuda.memory_reserved(device) - reserved)


def replay(arr: dict, D: torch.Tensor) -> torch.Tensor:
    """C [L, t] = the structured replay of D [M_pad, t]: through the
    schedule's program on a card, eagerly on the CPU or inside a capture."""
    if D.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _replay.replay(arr, D)
    return run(arr, D, torch.cuda.current_stream(D.device).cuda_stream)


def run(arr: dict, D: torch.Tensor, stream: int) -> torch.Tensor:
    """The program path of D on `stream` (the id of the stream the call
    runs on): replay the key's program, or capture it at the key's second
    call, or run eagerly at its first; each `reclaiming` the card's other
    programs where it runs out of memory."""
    progs = arr.get("programs")
    if progs is None:
        progs = arr["programs"] = Programs()
    key = (D.shape[1], stream)
    prog = progs.get(key)
    if prog is not None:
        return reclaiming(lambda: _play(prog, arr, D), D.device, keep=prog.token)
    n = progs.calls[key] = progs.calls.get(key, 0) + 1
    if n < 2:
        return reclaiming(lambda: _replay.replay(arr, D), D.device)
    return reclaiming(lambda: _build(arr, D, progs, key), D.device)


def _build(arr: dict, D: torch.Tensor, progs: Programs, key: tuple) -> torch.Tensor:
    dev = D.device
    kernels.prepare(dev)
    buf = _replay.buffers(arr, D.shape[1], dev)
    _replay.prologue(arr, D, buf)
    _replay.body(arr, buf)  # the warm call: this call's result
    # the body sees the arrays without their programs: a graph holds no reference to its owner
    body = functools.partial(_replay.body, {k: v for k, v in arr.items() if k != "programs"}, buf)
    t0 = time.perf_counter()
    with stats.timer("replay_program_capture_s"), kernels.tape() as tp:
        graph, pool = capture(body, dev)
    prog = Program()
    prog.graph, prog.buf, prog.tape, prog.token = graph, buf, tp, next(_tokens)
    prog.nbytes = pool + sum(b.numel() for b in buf.values())
    prog.capture_s = time.perf_counter() - t0
    progs[key] = prog
    lru = _lru(dev)
    weakref.finalize(prog, lru.discard, prog.token)
    lru.put(prog.token, (weakref.ref(progs), key), prog.nbytes)
    stats.count("replay_program_capture")
    return _replay.epilogue(arr, buf)


def _play(prog: Program, arr: dict, D: torch.Tensor) -> torch.Tensor:
    _replay.prologue(arr, D, prog.buf)
    prog.graph.replay()
    kernels.play(prog.tape)
    _lru(D.device).get(prog.token)  # now the most recently replayed
    stats.count("replay_program_replay")
    return _replay.epilogue(arr, prog.buf)


def programs(arr: dict) -> dict:
    """The arrays' programs: {(t, stream): Program}."""
    return dict(arr.get("programs") or {})
