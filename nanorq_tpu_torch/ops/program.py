"""The structured replay as one captured CUDA graph per shape signature: the
port's counterpart of the JAX package's compiled replay program
(`_replay_jit`, one executable per DeviceSchedule shape signature).

JAX compiles the replay of a signature into one XLA program and dispatches
it once.  The counterpart on the card is a CUDA graph replayed once: `replay`
runs `ops/replay.prologue` (the two gathers that read D, into buffers the
program owns), copies the schedule's packed arrays into the program's slot,
replays the captured `ops/replay.body` (stages 1-4: the trisolve, the bsel
plan, HDPC, Vinv, Wut) with one `graph.replay()`, and runs
`ops/replay.epilogue` (stage 5, into a fresh C).  Neither D nor C nor a
schedule's arrays is an address of the graph, so a caller may pass any D,
keeps its own C, and every schedule of the program's signature replays it.

A program belongs to (the signature, the width t, the stream, the device of
the schedule's arrays): its key.  The device is part of it because the id of
every card's default stream is 0 and signature numbers are global: a key's
calls on one card do not count toward its capture on another.  It
owns its graph, its buffers (y, z, zsel) and its slot, one flat uint8 buffer
of the signature's layout (`ops/replay.views`) that the body was captured
over; a replay copies the calling schedule's `packed` buffer into the slot
(one device-to-device copy on the call's stream, ordered after the key's
last replay; skipped when the slot holds that schedule's bytes already).
Two lanes of one card, a stream each, never replay one graph and its
buffers at once.  Canonical decode schedules of one K' share their
signature once the layout has frozen, as they share one executable in the
JAX package; an encoder schedule has a signature of its own.  A key is
captured at its second call: repeated traffic (warm encodes, the per-block
`Encoder.generate_symbols` at t = T, a stream of decode patterns of one
signature) gets its program after one eager call, and a key met once (a
one-shot encode of an object, whose width is Z*T; a signature met once)
runs eagerly and captures nothing.

The call that captures copies the schedule into the slot, captures the
body over the slot and the program's buffers on a side stream, and then
replays the graph once after its prologue for this call's result.  The
key's first call ran the same body eagerly, so every kernel it launches has
launched before (no module loads inside a capture), and `kernels.prepare`
creates what the wrappers keep per device first.  The captured launches do
not count where they are captured (`kernels.tape`); each replay adds them
(`kernels.play`), so the launch counts are those of the eager replay.

The cache owns the programs: a program outlives the schedule that captured
it and serves the next schedule of its signature.  A program holds its
buffers (y and z are [~L, t] each: about 0.7 GB at K=1000, t = 256000), its
slot and its graph's private pool for as long as it is cached.  Each device's
programs together are bounded by bytes (env NANORQ_PROGRAM_CACHE_MB per
device, default 4096): the least recently replayed is evicted first, and an
evicted program frees its graph, pool, slot and buffers.  When a card runs
out of memory in a replay, in an upload of a schedule's arrays
(`ops/replay.device_arrays`) or of the lanes (`parallel/mesh.stage`,
`upload`), in a kernel's fresh output (`ops/kernels.py`), in the LT
combine's output, the W products' operands or a dense-W plan's upload, that
card's other programs are evicted and the call is made once more
(`reclaiming`, `empty`); nothing is evicted inside a stream capture, whose
caller reclaims once the capture has ended (`run`).  Counters in
`utils.stats`: replay_program_capture, replay_program_replay,
replay_program_shared (a replay by another schedule than the one that
captured the program), replay_program_evict; while tracing is on, the
capture is the span replay_program_capture.

Nothing is captured on the CPU: the replay runs eagerly there (JAX on the
CPU, too, dispatches the same ops).  A caller that is capturing a graph
itself (`torch.cuda.is_current_stream_capturing()`) gets the eager replay,
in its own graph.  A failed capture, copy-in or replay raises: nothing runs
eagerly in place of a program.  The LT combine (2 launches an encode), the
dense-W step (one K1 and one K2, `ops/wpath.w_apply_gf2_batch`) and the
residual product (K3) stay eager: a few launches each.
"""

import contextlib
import functools
import os
import time
from collections import OrderedDict

import torch

from nanorq_tpu_torch.ops import kernels
from nanorq_tpu_torch.ops import replay as _replay
from nanorq_tpu_torch.utils import stats
from nanorq_tpu_torch.utils.lru import ByteLRU

BUDGET = int(float(os.environ.get("NANORQ_PROGRAM_CACHE_MB", 4096)) * (1 << 20))  # per device
CALLS_KEPT = 1 << 12  # keys whose calls before their capture are remembered


class Program:
    """One signature's body captured at one width for one stream: its key,
    the buffers and the slot it owns, its graph, the launches each replay
    runs (`kernels.Tape`), its bytes, the host seconds its capture took, the
    arrays that captured it (`owner`, their `uid`) and the arrays whose
    bytes the slot holds (`last`)."""

    __slots__ = ("key", "graph", "buf", "slot", "tape", "nbytes", "capture_s", "owner", "last")


_caches: dict = {}  # device -> ByteLRU: key -> Program
_calls: OrderedDict = OrderedDict()  # key -> its calls before its capture
_side: dict = {}  # device -> the stream captures run on


def _lru(device: torch.device) -> ByteLRU:
    lru = _caches.get(device)
    if lru is None:
        lru = _caches[device] = ByteLRU(BUDGET, "replay_program")
    return lru


def _dev(device) -> torch.device:
    dev = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


def cached_bytes(device=None) -> int:
    """Bytes the cached programs hold on `device` (default: on every device)."""
    return sum(lru.bytes for dev, lru in list(_caches.items()) if device is None or dev == _dev(device))


def release(device, keep: tuple | None = None) -> int:
    """Evict every program on `device` but the one whose key is `keep`;
    returns the bytes they held."""
    lru = _caches.get(_dev(device))
    return 0 if lru is None else lru.evict(keep)


def reclaiming(fn, device: torch.device, keep: tuple | None = None):
    """fn(), and where the card is out of memory, fn() once more after
    `release(device, keep)`; raises when there was nothing to release.
    Inside a stream capture, fn() alone: no graph is freed while one is
    being captured, and the capture's caller reclaims after it (`run`)."""
    if torch.device(device).type == "cuda" and torch.cuda.is_current_stream_capturing():
        return fn()
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
    program of the schedule's signature on a card, eagerly on the CPU or
    inside a capture."""
    if D.device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return _replay.replay(arr, D)
    return run(arr, D, torch.cuda.current_stream(D.device).cuda_stream)


def _key(arr: dict, t: int, stream: int) -> tuple:
    return arr["sig"], t, stream, arr["packed"].device


def lookup(arr: dict, t: int, stream: int) -> Program | None:
    """The cached program a replay of the arrays at width t on `stream`
    (the stream's id) would run, or None; the cache's order is left as it
    is."""
    lru = _caches.get(_dev(arr["packed"].device))
    return None if lru is None else lru.peek(_key(arr, t, stream))


def run(arr: dict, D: torch.Tensor, stream: int) -> torch.Tensor:
    """The program path of D on `stream` (the id of the stream the call
    runs on): replay the key's program, or capture it at the key's second
    call, or run eagerly at its first; each `reclaiming` the card's other
    programs where it runs out of memory."""
    key = _key(arr, D.shape[1], stream)
    hit, prog = _lru(D.device).get(key)
    if hit:
        return reclaiming(lambda: _play(prog, arr, D), D.device, keep=key)
    n = _calls[key] = _calls.pop(key, 0) + 1
    while len(_calls) > CALLS_KEPT:
        _calls.popitem(last=False)
    if n < 2:
        return reclaiming(lambda: _replay.replay(arr, D), D.device)
    return reclaiming(lambda: _build(arr, D, key), D.device)


def _copy_in(prog: Program, arr: dict) -> None:
    """The schedule's packed arrays into the program's slot, on the current
    stream, unless the slot holds them already.  On a card the packed buffer
    is marked used by this stream, so that its memory is not reused before
    the copy has read it, whichever stream uploaded it."""
    if prog.last == arr["uid"]:
        return
    prog.slot.copy_(arr["packed"])
    if prog.slot.is_cuda:
        arr["packed"].record_stream(torch.cuda.current_stream(prog.slot.device))
    prog.last = arr["uid"]


def _build(arr: dict, D: torch.Tensor, key: tuple) -> torch.Tensor:
    dev = D.device
    kernels.prepare(dev)
    prog = Program()
    prog.key, prog.owner, prog.last = key, arr["uid"], None
    prog.buf = _replay.buffers(arr, D.shape[1], dev)
    prog.slot = torch.empty_like(arr["packed"])
    _copy_in(prog, arr)
    view = _replay.views(arr, prog.slot)
    t0 = time.perf_counter()
    with stats.span("replay_program_capture"), kernels.tape() as tp:
        prog.graph, pool = capture(functools.partial(_replay.body, view, prog.buf), dev)
    prog.tape, prog.capture_s = tp, time.perf_counter() - t0
    prog.nbytes = pool + prog.slot.numel() + sum(b.numel() for b in prog.buf.values())
    _lru(dev).put(key, prog, prog.nbytes)
    stats.count("replay_program_capture")
    _replay.prologue(arr, D, prog.buf)  # this call's result: the graph's first replay
    prog.graph.replay()
    kernels.play(prog.tape)
    return _replay.epilogue(arr, prog.buf)


def _play(prog: Program, arr: dict, D: torch.Tensor) -> torch.Tensor:
    _replay.prologue(arr, D, prog.buf)
    _copy_in(prog, arr)
    prog.graph.replay()
    kernels.play(prog.tape)
    stats.count("replay_program_replay")
    if arr["uid"] != prog.owner:
        stats.count("replay_program_shared")
    return _replay.epilogue(arr, prog.buf)
