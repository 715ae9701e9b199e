"""The replay's program layer (`nanorq_tpu_torch/ops/program.py`) and the
split replay it captures (`ops/replay.py`: prologue, body, epilogue).

On the CPU: the split replay against the JAX package's `replay_device` (JAX
on the CPU, xla backend) byte for byte, on encoder and decode schedules; the
signature counters; the program cache's policy, with the capture replaced by
a stub that replays the body eagerly over the program's slot (capture at the
second call of every key, one program per (signature, t, stream), eviction
by bytes within one device's budget, release and the retry after an
out-of-memory error, a program outlives the schedule that captured it, a CPU
tensor never reaches the cache, a failed capture raises); the launch tape;
K1's `overwrite`; the ByteLRU's eviction hooks.  On the card (`cuda`): the
program against the eager replay bit for bit, C that outlives the next
replay, two lanes of one card at once, the launch counts, a capture inside a
capture, the memory an eviction returns, and a replay, an upload and a
schedule's arrays that need the memory a full cache holds.  The sharing of
one program by the schedules of a signature: tests/test_torch_shared_program.py."""

import contextlib
import copy
import dataclasses
import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec.cache import encoder_schedule as jax_encoder_schedule
from nanorq_tpu.ops.replay import device_arrays as jax_device_arrays
from nanorq_tpu.ops.replay import replay_device
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.ops import kernels, program
from nanorq_tpu_torch.ops import replay as treplay
from nanorq_tpu_torch.precode.device_schedule import compile_device
from nanorq_tpu_torch.precode.matrix import binary_rows
from nanorq_tpu_torch.precode.solver import _solve_core
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.utils import stats
from nanorq_tpu_torch.utils.lru import ByteLRU


def _encoder(K: int):
    return tcache.encoder_schedule(params_init(K).Kp)


def _decode_schedule(K: int, ov: int, seed: int, CB: int | None = None):
    """A canonical decode schedule of a patched system, built as
    tests/test_torch_replay.py builds one, and a D for it."""
    rng = np.random.default_rng(seed)
    P = params_init(K)
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    gaps = rng.choice(K, size=min(ov, K), replace=False)
    isis[gaps] = np.arange(K, K + len(gaps)) + (P.Kp - K)
    isis[P.Kp:] = np.arange(K + len(gaps), K + len(gaps) + ov) + (P.Kp - K)
    st = _solve_core(P, binary_rows(P, isis, overhead=ov), ov)
    assert st is not None
    return compile_device(st, CB=CB, canonical=True), rng


def _payload(ds, live: int, T: int, rng) -> np.ndarray:
    D = np.zeros((ds.M_pad, T), np.uint8)
    D[:live] = rng.integers(0, 256, (live, T), dtype=np.uint8)
    return D


def _split(arr: dict, D: torch.Tensor) -> torch.Tensor:
    buf = treplay.buffers(arr, D.shape[1], D.device)
    treplay.prologue(arr, D, buf)
    treplay.body(arr, buf)
    return treplay.epilogue(arr, buf)


def _jax(ds, D: np.ndarray) -> np.ndarray:
    return np.asarray(replay_device(jax_device_arrays(ds, "xla"), jnp.asarray(D)))


# --- the split replay against the JAX package --------------------------------

@pytest.mark.parametrize("K,T", [(10, 8), (100, 32), (1000, 16)])
def test_split_replay_matches_jax_on_encoder_schedules(K, T):
    ds = _encoder(K)
    D = _payload(ds, K, T, np.random.default_rng(K))
    want = _jax(jax_encoder_schedule(params_init(K).Kp), D)
    got = _split(treplay.device_arrays(ds, "cpu"), torch.from_numpy(D)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("K,ov,CB,T", [(10, 3, 64, 8), (100, 10, 64, 32), (1000, 30, 256, 13)])
def test_split_replay_matches_jax_on_decode_schedules(K, ov, CB, T):
    ds, rng = _decode_schedule(K, ov, K + ov, CB)
    Kp = params_init(K).Kp
    D = _payload(ds, Kp + ov, T, rng)
    D[K:Kp] = 0  # padding symbols are zero
    want = _jax(ds, D)
    got = _split(treplay.device_arrays(ds, "cpu"), torch.from_numpy(D)).numpy()
    assert np.array_equal(got, want)


def test_prologue_overwrites_what_the_buffers_held():
    """The buffers are reused from call to call: the prologue writes y and
    zsel, the body zeroes z, so what a buffer held before changes nothing."""
    ds = _encoder(100)
    arr = treplay.device_arrays(ds, "cpu")
    D = torch.from_numpy(_payload(ds, 100, 24, np.random.default_rng(1)))
    buf = treplay.buffers(arr, 24, "cpu")
    for b in buf.values():
        b.fill_(0xA5)
    treplay.prologue(arr, D, buf)
    treplay.body(arr, buf)
    assert torch.equal(treplay.epilogue(arr, buf), treplay.replay(arr, D))


# --- the signature counters --------------------------------------------------

def _counts(*names) -> dict:
    c = stats.snapshot()["counters"]
    return {n: c.get(n, 0) for n in names}


def _delta(before: dict) -> dict:
    after = _counts(*before)
    return {n: after[n] - before[n] for n in before}


SIG = ("replay_compile_new", "replay_compile_hit")


def test_signature_counted_new_then_hit(monkeypatch):
    monkeypatch.setattr(treplay, "_signatures", {})
    ds = _encoder(100)
    before = _counts(*SIG)
    treplay.device_arrays(dataclasses.replace(ds), "cpu")
    assert _delta(before) == {"replay_compile_new": 1, "replay_compile_hit": 0}
    treplay.device_arrays(dataclasses.replace(ds), "cpu")  # the same schedule, arrays built again
    assert _delta(before) == {"replay_compile_new": 1, "replay_compile_hit": 1}
    a = treplay.device_arrays(ds, "cpu")
    n = _counts(*SIG)
    for _ in range(3):  # counted once per schedule, where its arrays are built, not per replay
        assert treplay.device_arrays(ds, "cpu") is a
        program.replay(a, torch.zeros((ds.M_pad, 8), dtype=torch.uint8))
    assert _counts(*SIG) == n


def test_signature_of_encoder_and_decode_schedules_of_one_kp_differ(monkeypatch):
    monkeypatch.setattr(treplay, "_signatures", {})
    before = _counts(*SIG)
    treplay.device_arrays(dataclasses.replace(_encoder(100)), "cpu")
    treplay.device_arrays(_decode_schedule(100, 10, 5)[0], "cpu")
    assert _delta(before) == {"replay_compile_new": 2, "replay_compile_hit": 0}


# --- the program cache, with a stub capture ------------------------------------

class _Graph:
    """What the stub capture gives: replay() runs the captured body eagerly."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


POOL = 4096  # bytes the stub says each capture's pool took


CPU = torch.device("cpu")


@pytest.fixture
def cache(monkeypatch):
    """Fresh program caches (no budget to speak of) and the stub capture;
    yields (the CPU's cache, the graphs captured)."""
    made = []

    def capture(fn, device):
        made.append(_Graph(fn))
        return made[-1], POOL

    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "_calls", type(program._calls)())
    monkeypatch.setattr(program, "BUDGET", 1 << 40)
    monkeypatch.setattr(program, "capture", capture)
    return program._lru(CPU), made


def _copy(ds):
    """A copy of ds (its fields and its canonical flag) with no arrays cached on it."""
    ds = copy.copy(ds)
    ds.__dict__.pop("_torch_arrays", None)
    return ds


def _fresh(ds) -> dict:
    """CPU arrays of a copy of ds that no other test holds."""
    return treplay.device_arrays(_copy(ds), "cpu")


PROG = ("replay_program_capture", "replay_program_replay", "replay_program_evict")


def _D(ds, K, t, seed):
    return torch.from_numpy(_payload(ds, K, t, np.random.default_rng(seed)))


def _schedule(kind: str):
    """(schedule, live rows) of K=100: the encoder's, or a decode pattern's."""
    if kind == "encoder":
        return _encoder(100), 100
    ds, _ = _decode_schedule(100, 10, 3)
    return ds, params_init(100).Kp + 10


@pytest.mark.parametrize("kind", ["encoder", "decode"])
def test_capture_at_the_second_replay_of_every_schedule(cache, kind):
    _, made = cache
    ds, live = _schedule(kind)
    arr = _fresh(ds)
    before = _counts(*PROG)
    for call in range(1, 5):
        D = _D(ds, live, 16, call)
        got = program.run(arr, D, stream=7)
        assert torch.equal(got, treplay.replay(arr, D)), call  # every call's own result
        captured = int(call >= 2)
        assert len(made) == captured and (program.lookup(arr, 16, 7) is not None) == captured
        assert [g.replays for g in made] == [call - 1] * captured  # the capturing call replays it too
    assert _delta(before) == {"replay_program_capture": 1, "replay_program_replay": 2, "replay_program_evict": 0}


@pytest.mark.parametrize("kind", ["encoder", "decode"])
def test_a_width_met_once_captures_nothing(cache, kind):
    """A one-shot encode (one object, one width) or a cold pattern: every
    call at a width of its own runs eagerly, and nothing is cached."""
    lru, made = cache
    ds, live = _schedule(kind)
    arr = _fresh(ds)
    before = _counts(*PROG)
    for t in (8, 16, 24, 40):
        D = _D(ds, live, t, t)
        assert torch.equal(program.run(arr, D, stream=7), treplay.replay(arr, D))
        program.run(arr, D, stream=8)  # another stream: a key of its own
    assert not made and len(lru) == 0 and _delta(before) == dict.fromkeys(PROG, 0)
    assert not any(program.lookup(arr, t, s) for t in (8, 16, 24, 40) for s in (7, 8))


def test_one_program_per_arrays_width_and_stream(cache):
    """A key is (the arrays' signature, t, stream): two arrays of one
    schedule (one signature) share their keys' programs, a width or a
    stream of its own opens a key, and a schedule of another K' too."""
    _, made = cache
    ds = _encoder(100)
    arr, other = _fresh(ds), _fresh(ds)
    small = _encoder(10)
    ten = _fresh(small)
    keys = [(arr, 16, 1), (arr, 16, 2), (arr, 32, 1), (other, 16, 1), (ten, 16, 1)]
    for a, t, s in keys + keys + keys:
        d = small if a is ten else ds
        D = _D(d, 10 if a is ten else 100, t, t + s)
        assert torch.equal(program.run(a, D, stream=s), treplay.replay(a, D))
    assert arr["sig"] == other["sig"] != ten["sig"]
    assert len(made) == 4 and [g.replays for g in made] == [5, 2, 2, 2]  # (16, 1): its second call (other's) captured
    got = {(t, s): program.lookup(arr, t, s) for t, s in ((16, 1), (16, 2), (32, 1))}
    assert all(got.values()) and program.lookup(other, 16, 1) is got[(16, 1)]
    assert program.lookup(ten, 16, 1) not in (None, got[(16, 1)]) and program.lookup(ten, 32, 1) is None


STREAMS = (1, 2, 3)


def test_programs_evicted_by_bytes_oldest_replayed_first(cache):
    lru, made = cache
    ds = _encoder(100)
    arr = _fresh(ds)
    D = _D(ds, 100, 16, 0)
    for s in STREAMS:
        program.run(arr, D, stream=s)  # each key's first call: eager
    program.run(arr, D, stream=1)
    one = lru.bytes
    prog = program.lookup(arr, 16, 1)
    assert one == POOL + prog.slot.numel() + sum(b.numel() for b in prog.buf.values())
    assert prog.slot.numel() == arr["packed"].numel() and prog.slot.data_ptr() != arr["packed"].data_ptr()
    del prog
    lru.budget = 2 * one  # room for two programs
    before = _counts(*PROG)
    program.run(arr, D, stream=2)
    program.run(arr, D, stream=1)  # stream 1's program is now the most recently replayed
    program.run(arr, D, stream=3)  # evicts stream 2's
    assert _delta(before)["replay_program_evict"] == 1 and lru.bytes == 2 * one and len(lru) == 2
    assert [bool(program.lookup(arr, 16, s)) for s in STREAMS] == [True, False, True]
    gone = weakref.ref(made[1])
    assert gone() is not None
    made.clear()
    assert gone() is None  # the evicted program held the last reference to its graph
    assert torch.equal(program.run(arr, D, stream=2), treplay.replay(arr, D))  # captured again
    assert _delta(before) == {"replay_program_capture": 3, "replay_program_replay": 1, "replay_program_evict": 2}
    assert [bool(program.lookup(arr, 16, s)) for s in STREAMS] == [False, True, True]


def test_a_program_outlives_the_schedule_that_captured_it(cache):
    """The cache owns the programs: a schedule that captured one and is
    dropped leaves it cached, and the next schedule of its signature replays
    it (through its own arrays, copied into the slot) without a capture."""
    lru, made = cache
    ds = dataclasses.replace(_encoder(100))
    arr = treplay.device_arrays(ds, "cpu")
    for seed in range(2):
        program.run(arr, _D(ds, 100, 16, seed), stream=1)
    prog = program.lookup(arr, 16, 1)
    assert len(lru) == 1 and lru.bytes > 0
    sig = arr["sig"]
    del arr
    ds.__dict__.pop("_torch_arrays")  # the schedule drops its arrays (an evicted decode plan drops all)
    gc.collect()
    assert len(lru) == 1 and lru.peek(prog.key) is prog  # the cache holds it, not the arrays
    nxt = _fresh(ds)
    assert nxt["sig"] == sig and program.lookup(nxt, 16, 1) is prog
    before = _counts(*PROG, "replay_program_shared")
    D = _D(ds, 100, 16, 5)
    assert torch.equal(program.run(nxt, D, stream=1), treplay.replay(nxt, D))
    assert _delta(before) == {"replay_program_capture": 0, "replay_program_replay": 1, "replay_program_evict": 0,
                              "replay_program_shared": 1}
    assert len(made) == 1 and made[0].replays == 2 and prog.last == nxt["uid"] != prog.owner


def test_a_cpu_tensor_never_reaches_the_cache(cache):
    lru, made = cache
    ds = _encoder(100)
    arr = _fresh(ds)
    before = _counts(*PROG)
    for seed in range(3):
        D = _D(ds, 100, 16, seed)
        assert torch.equal(program.replay(arr, D), treplay.replay(arr, D))
    assert program.lookup(arr, 16, 0) is None and not made and len(lru) == 0 and _delta(before) == dict.fromkeys(PROG, 0)


def test_a_failed_capture_raises_and_caches_nothing(cache, monkeypatch):
    lru, _ = cache

    def broken(fn, device):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(program, "capture", broken)
    ds = _encoder(100)
    arr = _fresh(ds)
    D = _D(ds, 100, 16, 0)
    program.run(arr, D, stream=1)  # the first call: eager, nothing to capture yet
    launches = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="capture failed"):
        program.run(arr, D, stream=1)
    assert program.lookup(arr, 16, 1) is None and len(lru) == 0 and kernels.LAUNCHES == launches


def _captured(ds, n: int, t: int = 16) -> dict:
    """Fresh CPU arrays of ds with a program at width t on each of streams 1..n."""
    arr = _fresh(ds)
    D = _D(ds, 100, t, 0)
    for s in list(range(1, n + 1)) * 2:
        program.run(arr, D, stream=s)
    return arr


def test_each_device_has_a_budget_of_its_own(cache):
    lru, _ = cache
    _captured(_encoder(100), 1)
    card = program._lru(torch.device("cuda", 0))
    assert card is not lru and card.budget == lru.budget == program.BUDGET and len(card) == 0
    assert program.cached_bytes(CPU) == program.cached_bytes() == lru.bytes > 0
    assert program.cached_bytes("cuda:0") == 0 and program.release(torch.device("cuda", 0)) == 0


def test_release_evicts_the_programs_of_the_device_but_the_one_kept(cache):
    lru, _ = cache
    arr = _captured(_encoder(100), 3)
    keep = program.lookup(arr, 16, 2)
    before = _counts(*PROG)
    assert program.release(CPU, keep=keep.key) == 2 * keep.nbytes
    assert lru.bytes == keep.nbytes and len(lru) == 1 and _delta(before)["replay_program_evict"] == 2
    assert [bool(program.lookup(arr, 16, s)) for s in STREAMS] == [False, True, False]
    assert program.release(CPU) == keep.nbytes and len(lru) == 0 and program.release(CPU) == 0


def _oom():
    raise torch.OutOfMemoryError("out of memory")


def test_reclaiming_retries_once_after_releasing_and_raises_when_nothing_is_left(cache):
    lru, _ = cache
    arr = _captured(_encoder(100), 2)
    seen = []

    def fn():
        seen.append(len(lru))
        if len(seen) == 1:
            _oom()
        return "done"

    assert program.reclaiming(fn, CPU) == "done" and seen == [2, 0]  # the retry found the cache empty
    assert not any(program.lookup(arr, 16, s) for s in STREAMS)
    with pytest.raises(torch.OutOfMemoryError):  # nothing left to release: the error stands
        program.reclaiming(_oom, CPU)
    arr = _captured(_encoder(100), 1)
    kept = program.lookup(arr, 16, 1).key
    with pytest.raises(torch.OutOfMemoryError):  # only the program kept is left
        program.reclaiming(_oom, CPU, keep=kept)
    assert len(lru) == 1
    with pytest.raises(ValueError):  # any other error is not caught
        program.reclaiming(lambda: int("x"), CPU)
    assert len(lru) == 1 and program.empty((3, 5), torch.uint8, CPU).shape == (3, 5)


def test_a_capture_out_of_memory_gets_the_room_of_the_other_programs(cache, monkeypatch):
    """The key's second call runs out of memory making its buffers: the
    other programs are evicted, and the capture is made once more."""
    lru, made = cache
    ds = _encoder(100)
    arr = _captured(ds, 2)
    D = _D(ds, 100, 24, 5)
    program.run(arr, D, stream=3)  # eager
    buffers, fails = treplay.buffers, []

    def short(*args):
        if not fails:
            fails.append(1)
            _oom()
        return buffers(*args)

    monkeypatch.setattr(treplay, "buffers", short)
    before = _counts(*PROG)
    assert torch.equal(program.run(arr, D, stream=3), treplay.replay(arr, D))
    assert fails and _delta(before) == {"replay_program_capture": 1, "replay_program_replay": 0,
                                        "replay_program_evict": 2}
    assert [bool(program.lookup(arr, t, s)) for t, s in ((16, 1), (16, 2), (24, 3))] == [False, False, True]
    assert len(lru) == 1


def test_save_schedule_keeps_the_fields_alone(cache, tmp_path):
    """A schedule whose arrays hold a program pickles as its fields."""
    ds = dataclasses.replace(_encoder(100))
    arr = treplay.device_arrays(ds, "cpu")
    for _ in range(2):
        program.run(arr, _D(ds, 100, 16, 0), stream=1)
    assert program.lookup(arr, 16, 1)
    path = tmp_path / "enc.sched"
    tcache.save_schedule(ds, str(path))
    back = tcache.load_schedule(str(path))
    assert "_torch_arrays" not in back.__dict__
    assert np.array_equal(back.out_sel, ds.out_sel) and back.Lpad == ds.Lpad



# --- a key holds its device; every allocation on a card can reclaim -----------

class _On:
    """What `program.run` reads of a tensor before it runs anything, on a
    device of our choosing: its device and its shape (no card needed)."""

    def __init__(self, device: str, shape: tuple = (0,)):
        self.device, self.shape = torch.device(device), shape


def test_a_keys_calls_on_one_card_do_not_count_on_another(cache, monkeypatch):
    """The default stream of every card has the id 0 and signature numbers
    are global: the same signature, width and stream on cuda:1 is a key of
    its own, whose first call runs eagerly (it captures at its second)."""
    ran = []
    monkeypatch.setattr(treplay, "replay", lambda arr, D: ran.append(("eager", str(D.device))))
    monkeypatch.setattr(program, "_build", lambda arr, D, key: ran.append(("capture", str(D.device))))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)  # no card, no capture
    arr = {d: {"sig": 7, "packed": _On(d)} for d in ("cuda:0", "cuda:1")}
    for d in ("cuda:0", "cuda:0", "cuda:1", "cuda:1"):
        program.run(arr[d], _On(d, (12, 16)), stream=0)
    assert ran == [("eager", "cuda:0"), ("capture", "cuda:0"), ("eager", "cuda:1"), ("capture", "cuda:1")]
    assert program._key(arr["cuda:0"], 16, 0) != program._key(arr["cuda:1"], 16, 0)
    assert program._key(arr["cuda:0"], 16, 0)[:3] == program._key(arr["cuda:1"], 16, 0)[:3]


@contextlib.contextmanager
def _card_branch(monkeypatch):
    """The wrappers take their card branch on CPU tensors, launching a stub
    library that computes nothing: what runs is each wrapper's own
    allocation of its output."""
    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(kernels, "_device_kind", lambda *xs: "cuda")
    monkeypatch.setattr(kernels._build, "load", lambda: _Lib())
    monkeypatch.setattr(kernels, "_stream", lambda dev: 0)
    monkeypatch.setattr(kernels, "_flag", lambda flags, dev: torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(kernels, "LAUNCHES", dict(kernels.LAUNCHES))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    yield


class _OOMOnce:
    """`fn` raising torch.OutOfMemoryError at its first call after `arm()`."""

    def __init__(self, fn):
        self.fn, self.armed, self.raised = fn, False, 0

    def arm(self):
        self.armed = True

    def __call__(self, *args, **kw):
        if self.armed:
            self.armed = False
            self.raised += 1
            _oom()
        return self.fn(*args, **kw)


def _step(name: str):
    """A call of `name` whose first allocation on the device is its output
    (or, for `w_upload`, a dense-W plan's first upload), and the shape of
    what it gives."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.integers(0, 256, (24, 40), dtype=np.uint8))
    if name == "gather_xor":
        idx = torch.from_numpy(rng.integers(0, 24, (9, 3)).astype(np.int32))
        return lambda: kernels.gather_xor(X, idx).shape, (9, 40)
    if name == "gf2_matmul":
        bits = torch.from_numpy(rng.integers(0, 256, (5, 3), dtype=np.uint8))
        return lambda: kernels.gf2_matmul(bits, X).shape, (5, 40)
    if name == "gf256_matmul":
        M = torch.from_numpy(rng.integers(0, 256, (6, 24), dtype=np.uint8))
        return lambda: kernels.gf256_matmul(M, X).shape, (6, 40)
    if name == "lt_combine":  # the systematic window's sorted plan: its output is zeroed first
        from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan

        P = params_init(10)
        plan = lt_plan(np.arange(P.Kp, dtype=np.uint32), P, "cpu")
        C = torch.from_numpy(rng.integers(0, 256, (P.L, 40), dtype=np.uint8))
        assert not plan.passes
        return lambda: lt_combine(C, plan).shape, (plan.n_pad, 40)
    W = tcache.WSchedule(64, 5, Wbits=rng.integers(0, 256, (5, 8), dtype=np.uint8),
                         rows=np.arange(64, dtype=np.int32))
    return lambda: tuple(W.staged("cpu")["bits"].shape), (8, 8)


F9_STEPS = ("gather_xor", "gf2_matmul", "gf256_matmul", "lt_combine", "w_upload")


@pytest.mark.parametrize("name", F9_STEPS)
def test_an_output_out_of_memory_releases_the_programs_and_succeeds(cache, monkeypatch, name):
    """K1, K2 and K3's fresh outputs, the LT combine's and a dense-W plan's
    uploads: where the device is out of memory, its programs are evicted and
    the allocation succeeds at the second try; with nothing cached, the
    error stands."""
    lru, _ = cache
    alloc = _OOMOnce(torch.from_numpy if name == "w_upload" else torch.empty)
    monkeypatch.setattr(torch, alloc.fn.__name__, alloc)
    with _card_branch(monkeypatch) if name in F9_STEPS[:3] else contextlib.nullcontext():
        fn, shape = _step(name)
        arr = _captured(_encoder(100), 2)
        before = _counts(*PROG)
        alloc.arm()
        assert fn() == shape and alloc.raised == 1
        assert len(lru) == 0 and _delta(before)["replay_program_evict"] == 2
        assert not any(program.lookup(arr, 16, s) for s in (1, 2))
        fn, _ = _step(name)
        alloc.arm()
        with pytest.raises(torch.OutOfMemoryError):
            fn()
        assert alloc.raised == 2

# --- the tape, K1's overwrite, the LRU's hook ---------------------------------

def test_tape_keeps_captured_launches_out_and_play_adds_them():
    before = dict(kernels.LAUNCHES)
    with kernels.record_gathers(limit=3) as rec:
        with kernels.tape() as tp:
            kernels.LAUNCHES["gather_xor"] += 4  # what four captured K1 launches count
            kernels.LAUNCHES["gf2_matmul"] += 1
            kernels._RECORD.extend([{"n": i} for i in range(4)])
        assert kernels.LAUNCHES == before and rec == []
        assert tp.launches == {"gather_xor": 4, "gf2_matmul": 1} and len(tp.gathers) == 4
        kernels.play(tp)
        kernels.play(tp)
        assert rec == [{"n": 0}, {"n": 1}, {"n": 2}]  # the recording's limit holds
    assert kernels.LAUNCHES["gather_xor"] == before["gather_xor"] + 8
    assert kernels.LAUNCHES["gf2_matmul"] == before["gf2_matmul"] + 2
    kernels.LAUNCHES.update(before)


def test_gather_xor_overwrite_writes_out():
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.integers(0, 256, (9, 40), dtype=np.uint8))
    idx = torch.from_numpy(rng.integers(0, 10, (5, 2)).astype(np.int32))
    out = torch.full((5, 40), 0x5A, dtype=torch.uint8)
    got = kernels.gather_xor(src, idx, out=out, zero_index=9, overwrite=True)
    assert got is out and torch.equal(out, kernels.gather_xor(src, idx, zero_index=9))
    with pytest.raises(ValueError, match="overwrite"):
        kernels.gather_xor(src, idx, overwrite=True)
    with pytest.raises(ValueError, match="overwrite"):
        kernels.gather_xor(src, idx, out=out, rows=torch.arange(5, dtype=torch.int32), overwrite=True)


def test_byte_lru_peek_leaves_the_order_and_evict_keeps_one():
    lru = ByteLRU(1000, "t_lru")
    before = _counts("t_lru_evict")
    for k in (1, 2, 3):
        lru.put(k, -k, 100)
    assert lru.peek(1) == -1 and lru.peek(9) is None
    lru.put(4, -4, 800)  # over budget: the oldest goes first, and a peek did not refresh 1
    assert [lru.peek(k) for k in (1, 2, 3, 4)] == [None, -2, -3, -4] and lru.bytes == 1000
    assert lru.evict(keep=3) == 900 and len(lru) == 1 and lru.bytes == 100
    assert _delta(before) == {"t_lru_evict": 3} and lru.evict() == 100 and len(lru) == 0


# --- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    """Empty program caches: no program another test captured is found."""
    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "_calls", type(program._calls)())


def _on_card(ds, live: int, t: int, seed: int, dev):
    arr = treplay.device_arrays(ds, dev)
    D = _payload(ds, live, t, np.random.default_rng(seed))
    return arr, torch.from_numpy(D).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("K,B", [(10, 4), (100, 4), (1000, 8), (10000, 2)])
def test_cuda_program_equals_eager_on_encoder_schedules(K, B):
    dev = _card()
    ds = _encoder(K)
    arr, D = _on_card(ds, K, B * 1280, K, dev)
    want = treplay.replay(arr, D)
    for _ in range(4):  # eager, the capture, then two replays
        assert torch.equal(program.replay(arr, D), want)
    assert not kernels.take_index_errors(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("K,ov,CB", [(100, 10, 64), (1000, 30, 256)])
def test_cuda_program_equals_eager_on_decode_schedules(K, ov, CB, fresh):
    dev = _card()
    ds, rng = _decode_schedule(K, ov, K + ov, CB)
    Kp = params_init(K).Kp
    D = _payload(ds, Kp + ov, 2 * 1280, rng)
    D[K:Kp] = 0
    arr, Dd = treplay.device_arrays(ds, dev), torch.from_numpy(D).to(dev)
    want = treplay.replay(arr, Dd)
    for call in range(3):  # eager, the capture, a replay
        assert torch.equal(program.replay(arr, Dd), want), call
        assert (program.lookup(arr, Dd.shape[1], torch.cuda.current_stream(dev).cuda_stream) is not None) == (call >= 1)
    assert np.array_equal(want.cpu().numpy(), _jax(ds, D))


@pytest.mark.cuda
def test_cuda_c_of_one_block_outlives_the_next_replay():
    """Two blocks of one K' encoded in turn: the first C, read after the
    second block's replay, is still the first block's (a C that aliased a
    buffer of the graph would hold the second's)."""
    dev = _card()
    ds = _encoder(1000)
    arr, D1 = _on_card(ds, 1000, 1280, 1, dev)
    _, D2 = _on_card(ds, 1000, 1280, 2, dev)
    for _ in range(2):
        program.replay(arr, D1)  # eager, then the capture
    C1 = program.replay(arr, D1)
    C2 = program.replay(arr, D2)
    assert torch.equal(C1, treplay.replay(arr, D1)) and torch.equal(C2, treplay.replay(arr, D2))
    assert not torch.equal(C1, C2)


@pytest.mark.cuda
def test_cuda_two_lanes_of_one_card_replay_one_schedule_at_once(fresh):
    dev = _card()
    ds = _encoder(1000)
    arr = treplay.device_arrays(ds, dev)
    Ds = [_on_card(ds, 1000, 8 * 1280, s, dev)[1] for s in range(2)]
    want = [treplay.replay(arr, D) for D in Ds]
    streams = [torch.cuda.Stream(dev) for _ in Ds]
    for rnd in range(3):
        got = []
        for s, D in zip(streams, Ds):
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                got.append(program.replay(arr, D))
        for s in streams:
            torch.cuda.current_stream(dev).wait_stream(s)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), rnd
    mine = [program.lookup(arr, 8 * 1280, s.cuda_stream) for s in streams]  # a program of its own on each lane's stream
    assert mine[0] is not mine[1] and mine[0].buf["z"].data_ptr() != mine[1].buf["z"].data_ptr()


@pytest.mark.cuda
def test_cuda_launch_counts_of_program_replays_equal_eager_ones():
    dev = _card()
    ds = _encoder(1000)
    arr, D = _on_card(ds, 1000, 4 * 1280, 3, dev)
    for _ in range(2):
        program.replay(arr, D)  # eager, then the capture
    n = 5
    kernels.reset_launches()
    for _ in range(n):
        treplay.replay(arr, D)
    eager = dict(kernels.LAUNCHES)
    kernels.reset_launches()
    with kernels.record_gathers() as rec:
        for _ in range(n):
            program.replay(arr, D)
    assert kernels.LAUNCHES == eager and eager["gather_xor"] == len(rec) and eager["gf256_matmul"] > 0


@pytest.mark.cuda
def test_cuda_a_program_inside_an_outer_capture_runs_inline():
    dev = _card()
    ds = _encoder(1000)
    arr, D = _on_card(ds, 1000, 2 * 1280, 4, dev)
    want = treplay.replay(arr, D)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    g = torch.cuda.CUDAGraph()
    before = _counts(*PROG)
    with torch.cuda.graph(g, stream=side):
        C = program.replay(arr, D)
    assert _delta(before) == dict.fromkeys(PROG, 0) and program.lookup(arr, 2 * 1280, side.cuda_stream) is None
    g.replay()
    torch.cuda.synchronize(dev)
    assert torch.equal(C, want)


@pytest.mark.cuda
def test_cuda_eviction_returns_the_memory(fresh):
    dev = _card()
    ds = dataclasses.replace(_encoder(1000))
    arr, D = _on_card(ds, 1000, 16 * 1280, 5, dev)
    treplay.replay(arr, D)
    program.replay(arr, D)  # eager: nothing is kept
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    C = program.replay(arr, D)  # the capture
    del C
    held = torch.cuda.memory_allocated(dev) - base
    prog = program.lookup(arr, 16 * 1280, torch.cuda.current_stream(dev).cuda_stream)
    assert held >= sum(b.numel() for b in prog.buf.values())
    del prog
    program._lru(dev).budget = 0
    small = dataclasses.replace(_encoder(10))
    other, D10 = _on_card(small, 10, 1280, 6, dev)
    for _ in range(2):
        program.replay(other, D10)  # a new program: the first is evicted
    gc.collect()
    torch.cuda.synchronize(dev)
    assert program.lookup(arr, 16 * 1280, torch.cuda.current_stream(dev).cuda_stream) is None
    assert torch.cuda.memory_allocated(dev) - base < held / 4


def _fill(ds, arr, dev, n: int, B: int) -> None:
    """Programs of arr at n widths from B blocks up, captured on the card."""
    for i in range(n):
        _, D = _on_card(ds, 1000, (B + i) * 1280, i, dev)
        for _ in range(2):
            program.replay(arr, D)


@contextlib.contextmanager
def _squeezed(dev, margin: int):
    """The card's memory taken but for about `margin` bytes -- its free
    memory and the allocator's cached blocks alike, down to 1 MiB pieces, so
    that no request of more than `margin` finds room without an eviction --
    and given back on leaving, also when the body fails."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reserve = torch.empty(margin, dtype=torch.uint8, device=dev)
    held, size = [], 1 << 40
    try:
        while size >= (1 << 20):
            try:
                held.append(torch.empty(size, dtype=torch.uint8, device=dev))
            except torch.OutOfMemoryError:
                size //= 2
        del reserve
        yield
    finally:
        held.clear()
        torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_a_replay_and_an_upload_find_the_memory_a_full_cache_holds(monkeypatch):
    """The card full but for less than a step needs, and a cache full to its
    budget (2 GiB): a replay at a new width, a lane's upload and the packed
    arrays of a cold K=50000 decode pattern (each given half of what it
    takes) evict the card's programs, then run, bit for bit; the cold
    pattern's program is captured after it (its slot).  Each allocation of a
    step is smaller than any program's buffer, so the room an eviction
    returns serves it whatever the allocator's segments hold."""
    from nanorq_tpu_torch.parallel import mesh as lanes

    dev = _card()
    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "BUDGET", 2 << 30)
    ds = dataclasses.replace(_encoder(1000))
    arr = treplay.device_arrays(ds, dev)
    lru = program._lru(dev)
    t = 32 * 1280  # y, z and C at this width: ~40 MB each, under a program's y at 40 blocks
    _, D = _on_card(ds, 1000, t, 99, dev)
    want = treplay.replay(arr, D)
    host = torch.empty((1000, t), dtype=torch.uint8, pin_memory=True)
    host.copy_(D[:1000].cpu())
    cold, rng = _decode_schedule(50000, 2500, 7)
    Dc = torch.from_numpy(_payload(cold, params_init(50000).Kp + 2500, 1280, rng)).to(dev)
    want_cold = treplay.replay(treplay.device_arrays(_copy(cold), dev), Dc)
    packed = treplay._layout(treplay._body_parts(cold)[1])[1]
    assert packed > (4 << 20)
    margins = {"replay": ds.Lpad * t, "upload": ds.M_pad * t // 2, "arrays": packed // 2}
    for step, margin in margins.items():
        _fill(ds, arr, dev, 12, 40)
        assert lru.bytes > (3 << 29) and len(lru) >= 4
        with _squeezed(dev, margin):
            before = _counts(*PROG)
            if step == "replay":
                got = program.replay(arr, D)  # the width's first call: eager, in the room the programs held
                assert torch.equal(got, want)
            elif step == "upload":
                got = lanes.upload(lanes.local_mesh(dev).lanes[0], host, ds.M_pad, 1000)
                assert torch.equal(got, D)
            else:
                got = treplay.device_arrays(cold, dev)["packed"]
                assert got.numel() == packed
            assert _delta(before)["replay_program_evict"] >= 4 and len(lru) == 0, step
            del got
    carr = treplay.device_arrays(cold, dev)
    for _ in range(3):  # eager, the capture (its slot), a replay
        assert torch.equal(program.replay(carr, Dc), want_cold)


@pytest.mark.cuda
def test_cuda_the_first_call_of_a_key_on_a_second_card_captures_nothing(fresh):
    """One schedule's key, captured on cuda:0 at its second call: its first
    call on cuda:1 (the same signature, width and default stream id) runs
    eagerly, and its second captures a program of cuda:1's own."""
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    ds = _encoder(1000)
    got = {}
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        arr, D = _on_card(ds, 1000, 2 * 1280, 8, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        want = treplay.replay(arr, D)
        calls = []
        for _ in range(2):
            before = _counts(*PROG)
            with torch.cuda.device(dev):
                assert torch.equal(program.replay(arr, D), want)
            calls.append(_delta(before)["replay_program_capture"])
        got[dev.index] = (calls, program.lookup(arr, 2 * 1280, stream))
    assert got[0][0] == got[1][0] == [0, 1]
    assert got[1][1] is not None and got[1][1] is not got[0][1] and got[1][1].key[3] == torch.device("cuda", 1)


@pytest.mark.cuda
def test_cuda_the_lt_combine_a_dense_w_decode_and_a_res_product_find_the_memory_a_full_cache_holds(monkeypatch):
    """The card full but for less than a step's first output needs, and a
    cache full to its budget (2 GiB): the LT combine of 1000 repair ISIs, a
    dense-W plan's decode (K1's gather of the payload rows, then K2) and a
    residual product (the copy of y, then two K3) evict the card's programs,
    then give the bytes they gave before the card was full."""
    from nanorq_tpu_torch.native import native_available
    from nanorq_tpu_torch.ops import wpath
    from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan

    dev = _card()
    if not native_available():
        pytest.skip("the dense-W plan needs the native solver")
    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "BUDGET", 2 << 30)
    ds = dataclasses.replace(_encoder(1000))
    arr = treplay.device_arrays(ds, dev)
    lru = program._lru(dev)
    t = 32 * 1280
    _, D = _on_card(ds, 1000, t, 98, dev)
    C = treplay.replay(arr, D)
    P = params_init(1000)
    plan = lt_plan(np.arange(P.Kp, P.Kp + 1000, dtype=np.uint32), P, dev)
    rng = np.random.default_rng(5)
    gaps = np.sort(rng.choice(1000, 60, replace=False))
    isis = np.arange(P.Kp + 10, dtype=np.uint32)
    isis[gaps] = np.arange(P.Kp, P.Kp + 60, dtype=np.uint32)
    isis[P.Kp:] = np.arange(P.Kp + 60, P.Kp + 70, dtype=np.uint32)
    tcache.clear_decoder_cache()
    wplan = tcache.decoder_plan(P, isis, 10)
    assert isinstance(wplan, tcache.WSchedule) and wplan.Wbits is not None
    wplan.staged(dev)
    Dw = torch.zeros((wplan.M_pad, t), dtype=torch.uint8, device=dev)
    Dw[: P.Kp + 10] = torch.from_numpy(rng.integers(0, 256, (P.Kp + 10, t), dtype=np.uint8)).to(dev)
    nb, nr, k, g = 4, 80, 1100, 60
    res = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
           for shape in ((nb, nr, k), (nb, k, 1280 * 8), (nb, g, nr), (nb, nr, 1280 * 8))]
    steps = {"lt": (lambda: lt_combine(C, plan), plan.n_pad * t // 2),
             "dense_w": (lambda: wplan.apply(Dw), wplan.rows.size * t // 2),
             "res": (lambda: wpath.res_apply_batch(*res), res[3].numel() // 2)}
    want = {name: fn() for name, (fn, _) in steps.items()}
    for name, (fn, margin) in steps.items():
        _fill(ds, arr, dev, 12, 40)
        assert lru.bytes > (3 << 29) and len(lru) >= 4
        with _squeezed(dev, margin):
            before = _counts(*PROG)
            got = fn()
            assert torch.equal(got, want[name]), name
            assert _delta(before)["replay_program_evict"] >= 4 and len(lru) == 0, name
            del got
