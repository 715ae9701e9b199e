"""One replay program per canonical decode signature (`ops/program.py`,
`ops/replay.signature`): the counterpart of the JAX package's one
`_replay_jit` executable per DeviceSchedule shape signature.

On the CPU: over a stream of canonical decode patterns (K=1800, the seeds of
tests/test_canonical_layout.py), the port numbers its signatures where the
JAX package's `_count_signature` counts them -- the same new / seen
sequence and the same partition of the patterns -- and opens a program key
exactly where the JAX package counts a new signature; a schedule replayed
through a program another schedule of its signature captured equals the
eager replay of its own arrays and the JAX package's `replay_device` (xla,
CPU), bit for bit (the capture is a stub that replays the body eagerly over
the program's slot); a schedule of another signature opens another key; a
placed class padded to its class's rows gives the same zsel as unpadded.
On the card (`cuda`): the shared program against the eager replay on cold
K=50000 patterns, and two lanes of one card replaying one signature's
schedules at once."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.ops import replay as jreplay
from nanorq_tpu.utils import stats as jstats
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.cache import encoder_schedule
from nanorq_tpu_torch.ops import kernels, program
from nanorq_tpu_torch.ops import replay as treplay
from nanorq_tpu_torch.precode import device_schedule as dsm
from nanorq_tpu_torch.precode.solver import solve_state
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.utils import stats

K, N = 1800, 14  # tests/test_canonical_layout.py's stream
SEED0 = 400


def _pattern(P, K, ov, seed):
    """(gaps, isis) of a ~6% loss pattern, as tests/test_canonical_layout.py draws it."""
    rng = np.random.default_rng(seed)
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (np.arange(K, K + gaps.size + ov) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp:] = rep[gaps.size:]
    return gaps, isis


def _copy(ds):
    """A copy of ds with its fields and its canonical flag, and no arrays
    cached on it by either package."""
    ds = copy.copy(ds)
    ds.__dict__.pop("_torch_arrays", None)
    ds.__dict__.pop("_dev_arrays", None)
    return ds


def _schedules(K: int, seeds) -> list:
    """Canonical decode schedules of a fresh per-K' layout, one per seed, in order."""
    P = params_init(K)
    ov = max(1, int(0.05 * K))
    out = []
    for s in seeds:
        _, isis = _pattern(P, K, ov, s)
        st = solve_state(P, tcache._patched_rows(P, isis, ov), ov)
        assert st is not None
        out.append(dsm.compile_device(st, canonical=True))
    return out


@pytest.fixture(scope="module")
def stream():
    dsm.clear_layout_cache()
    try:
        yield _schedules(K, range(SEED0, SEED0 + N))
    finally:
        dsm.clear_layout_cache()


def _payload(ds, seed: int, t: int = 8) -> np.ndarray:
    """D [M_pad, t]: K source rows, zero padding symbols, then the repair rows."""
    P = params_init(K)
    rng = np.random.default_rng(seed)
    D = np.zeros((ds.M_pad, t), np.uint8)
    D[: ds.M] = rng.integers(0, 256, (ds.M, t), dtype=np.uint8)
    D[K : P.Kp] = 0
    return D


def _counts(*names, of=stats) -> dict:
    c = of.snapshot()["counters"]
    return {n: c.get(n, 0) for n in names}


SIG = ("replay_compile_new", "replay_compile_hit")
PROG = ("replay_program_capture", "replay_program_replay", "replay_program_shared")


class _Graph:
    """What the stub capture gives: replay() runs the captured body eagerly."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0

    def replay(self):
        self.replays += 1
        self.fn()


@pytest.fixture
def cache(monkeypatch):
    """Fresh program caches and the stub capture; yields the graphs captured."""
    made = []

    def capture(fn, device):
        made.append(_Graph(fn))
        return made[-1], 0

    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "_calls", type(program._calls)())
    monkeypatch.setattr(program, "capture", capture)
    return made


class _Seen(set):
    """The JAX package's set of signatures, recording each one it is asked about."""

    def __init__(self):
        super().__init__()
        self.asked = []

    def __contains__(self, sig):
        self.asked.append(sig)
        return super().__contains__(sig)


def _partition(sigs: list) -> list:
    first = {}
    return [first.setdefault(s, i) for i, s in enumerate(sigs)]


# --- (a) the signature stream against the JAX package's ------------------------

def test_signatures_and_program_keys_follow_the_jax_package_over_a_pattern_stream(stream, cache, monkeypatch):
    seen = _Seen()
    monkeypatch.setattr(jreplay, "_seen_signatures", seen)
    monkeypatch.setattr(treplay, "_signatures", {})
    got, want, keys, sigs = [], [], [], []
    for i, ds in enumerate(stream):
        ds = _copy(ds)  # fresh arrays in both packages
        before, jbefore = _counts(*SIG), _counts(*SIG, of=jstats)
        jreplay.device_arrays(ds, "xla")
        arr = treplay.device_arrays(ds, "cpu")
        after, jafter = _counts(*SIG), _counts(*SIG, of=jstats)
        want.append(tuple(jafter[n] - jbefore[n] for n in SIG))
        got.append(tuple(after[n] - before[n] for n in SIG))
        sigs.append(arr["sig"])
        program.run(arr, torch.from_numpy(_payload(ds, i)), stream=1)
        keys.append(len(program._calls))
    assert got == want and sum(n for n, _ in want) < N  # some patterns share, as in the JAX package
    assert _partition(sigs) == _partition(seen.asked)  # the same patterns share a signature
    new = [n for n, _ in want]
    assert np.diff([0] + keys).tolist() == new  # a key opens exactly where JAX counts a new signature
    assert sigs[-1] == sigs[-2] == sigs[-3]  # converged, as tests/test_canonical_layout.py holds


def test_a_stream_of_cold_patterns_replays_the_programs_of_their_signatures(stream, cache):
    """Every pattern replayed once, as a receiver decodes each block once:
    a signature's second pattern captures, every later one replays that
    program, and each result is its own schedule's eager replay."""
    before = _counts(*PROG)
    arrs = [treplay.device_arrays(_copy(ds), "cpu") for ds in stream]
    for i, (ds, arr) in enumerate(zip(stream, arrs)):
        D = torch.from_numpy(_payload(ds, 100 + i))
        assert torch.equal(program.run(arr, D, stream=1), treplay.replay(arr, D)), i
    per_sig = {}
    for arr in arrs:
        per_sig[arr["sig"]] = per_sig.get(arr["sig"], 0) + 1
    d = {n: _counts(*PROG)[n] - before[n] for n in PROG}
    assert d["replay_program_capture"] == len(cache) == sum(n >= 2 for n in per_sig.values())
    assert d["replay_program_replay"] == d["replay_program_shared"] == sum(max(0, n - 2) for n in per_sig.values()) > 0


# --- (b) A captures, B of its signature replays it -------------------------------

def _jax(ds, D: np.ndarray) -> np.ndarray:
    return np.asarray(jreplay.replay_device(jreplay.device_arrays(_copy(ds), "xla"), jnp.asarray(D)))


def test_a_program_captured_by_one_schedule_replays_another_of_its_signature(stream, cache):
    A, B = stream[-2], stream[-1]
    a, b = treplay.device_arrays(_copy(A), "cpu"), treplay.device_arrays(_copy(B), "cpu")
    assert a["sig"] == b["sig"] and a["uid"] != b["uid"] and a["layout"] == b["layout"]
    assert not torch.equal(a["packed"], b["packed"])  # two patterns: other arrays, one layout
    before = _counts(*PROG)
    for call, (ds, arr) in enumerate([(A, a), (A, a), (B, b), (A, a), (B, b), (A, a)]):
        D = _payload(ds, 200 + call)
        got = program.run(arr, torch.from_numpy(D), stream=3).numpy()
        assert np.array_equal(got, treplay.replay(arr, torch.from_numpy(D)).numpy()), call
        assert np.array_equal(got, _jax(ds, D)), call
    d = {n: _counts(*PROG)[n] - before[n] for n in PROG}
    assert d["replay_program_capture"] == 1 and d["replay_program_shared"] >= 2 and d["replay_program_replay"] == 4
    prog = program.lookup(b, 8, 3)
    assert prog is program.lookup(a, 8, 3) and prog.owner == a["uid"] and prog.last == a["uid"]
    assert len(cache) == 1 and cache[0].replays == 5  # the capturing call's, then four


# --- (c) another signature, another key ----------------------------------------

def test_a_schedule_of_another_signature_opens_another_key(stream, cache):
    first, last = (treplay.device_arrays(_copy(ds), "cpu") for ds in (stream[0], stream[-1]))
    eds = encoder_schedule(params_init(K).Kp)
    enc = treplay.device_arrays(_copy(eds), "cpu")
    assert len({first["sig"], last["sig"], enc["sig"]}) == 3
    for arr, ds in ((first, stream[0]), (last, stream[-1]), (enc, eds)):
        for seed in range(2):
            D = torch.from_numpy(_payload(ds, seed))
            assert torch.equal(program.run(arr, D, stream=1), treplay.replay(arr, D))
    progs = [program.lookup(arr, 8, 1) for arr in (first, last, enc)]
    assert all(progs) and len({id(p) for p in progs}) == 3 and len(cache) == 3


def test_canonical_arrays_keep_the_padded_shapes_and_the_encoder_its_extents(stream):
    ds = stream[-1]
    arr = treplay.device_arrays(_copy(ds), "cpu")
    assert ds.canonical and tuple(arr["wut"].shape) == ds.wut.shape and arr["wut_k"] == ds.u_pad
    for (ix, rows), (cix, sel) in zip(arr["bsel_placed"], ds.bsel.overflow):
        assert ix.shape == (min(cix.shape[0], ds.u_pad), cix.shape[1]) and rows.shape == (ix.shape[0],)
        kernels.check_rows(rows, ds.u_pad)
    enc = encoder_schedule(params_init(1000).Kp)
    e = treplay.device_arrays(_copy(enc), "cpu")
    assert not enc.canonical and e["mhd"].shape[0] < enc.mhd.shape[0] and e["wut_k"] < enc.u_pad
    offs = [off for _, _, off in arr["layout"]]
    assert all(off % treplay.ALIGN == 0 for off in offs) and offs == sorted(offs)


# --- (d) a padded placed class ---------------------------------------------------

@pytest.mark.parametrize("nb,w,n_out,taken", [(8, 3, 20, 5), (16, 1, 40, 16), (32, 4, 32, 9), (64, 2, 40, 7),
                                              (4, 5, 9, 0)])
def test_a_padded_placed_class_gives_the_unpadded_zsel(nb, w, n_out, taken):
    """A class of nb rows, `taken` of them placed into n_out output rows,
    padded to min(nb, n_out) rows: the same zsel on K1's plain path, the
    rows distinct and in range, every added row reading the zero index."""
    rng = np.random.default_rng(nb * n_out + taken)
    S = 50
    ix = rng.integers(0, S, (nb, w)).astype(np.int32)
    sel = np.full(n_out, nb, np.int32)
    sel[rng.permutation(n_out)[:taken]] = rng.permutation(nb)[:taken]
    src = torch.from_numpy(rng.integers(0, 256, (S, 24), dtype=np.uint8))
    base = rng.integers(0, 256, (n_out, 24), dtype=np.uint8)
    i0, r0 = treplay.compose(ix, sel, zero_index=S)
    i1, r1 = treplay.compose(ix, sel, n_rows=min(nb, n_out), zero_index=S)
    assert i0.shape[0] == taken and i1.shape == (min(nb, n_out), w)
    kernels.check_rows(r1, n_out)
    assert (i1[taken:] == S).all() and not np.isin(r1[taken:], r0).any()
    want = kernels.gather_xor(src, torch.from_numpy(i0), out=torch.from_numpy(base.copy()),
                              rows=torch.from_numpy(r0), zero_index=S)
    got = kernels.gather_xor(src, torch.from_numpy(i1), out=torch.from_numpy(base.copy()),
                             rows=torch.from_numpy(r1), zero_index=S)
    assert torch.equal(got, want)


def test_a_padded_hdpc_placement_gives_the_unpadded_zsel():
    """The HDPC products' placement padded to H_pad rows reads the product
    buffer's zero index on every row it adds."""
    rng = np.random.default_rng(3)
    H, u_pad = 32, 64
    hd_sel = np.full(u_pad, H, np.int32)
    hd_sel[rng.permutation(u_pad)[:10]] = np.arange(10)  # H rows of products, 10 of them placed
    prod = torch.from_numpy(rng.integers(0, 256, (H, 16), dtype=np.uint8))
    base = rng.integers(0, 256, (u_pad, 16), dtype=np.uint8)
    ar = np.arange(H, dtype=np.int32)[:, None]
    outs = []
    for n_rows in (None, min(H, u_pad)):
        idx, rows = treplay.compose(ar, hd_sel, n_rows=n_rows, zero_index=H)
        outs.append(kernels.gather_xor(prod, torch.from_numpy(idx), out=torch.from_numpy(base.copy()),
                                       rows=torch.from_numpy(rows), zero_index=H))
    assert torch.equal(*outs)


# --- (e) on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(program, "_caches", {})
    monkeypatch.setattr(program, "_calls", type(program._calls)())


def _cold_k50000(n: int) -> list:
    """_FREEZE_AFTER + 1 patterns that freeze the K=50000 layout, then n fresh ones."""
    dsm.clear_layout_cache()
    return _schedules(50000, range(900, 900 + dsm._FREEZE_AFTER + 1 + n))[-n:]


@pytest.mark.cuda
def test_cuda_the_shared_program_equals_eager_on_cold_k50000_patterns(fresh):
    dev = _card()
    P = params_init(50000)
    scheds = _cold_k50000(6)
    before = _counts(*PROG)
    for i, ds in enumerate(scheds):
        arr = treplay.device_arrays(ds, dev)
        D = torch.zeros((ds.M_pad, 1280), dtype=torch.uint8, device=dev)
        D[: ds.M] = torch.from_numpy(np.random.default_rng(i).integers(0, 256, (ds.M, 1280), dtype=np.uint8)).to(dev)
        D[50000 : P.Kp] = 0
        want = treplay.replay(arr, D)
        assert torch.equal(program.replay(arr, D), want), i  # each pattern once
    d = {n: _counts(*PROG)[n] - before[n] for n in PROG}
    assert d["replay_program_capture"] >= 1 and d["replay_program_shared"] >= 1
    assert not kernels.take_index_errors(dev)
    dsm.clear_layout_cache()


@pytest.mark.cuda
def test_cuda_two_lanes_of_one_card_replay_one_signature_at_once(fresh):
    """Two schedules of one signature, each on a lane (a stream) of its own,
    replayed at once round after round: a program per lane, each copying its
    schedule into its own slot."""
    dev = _card()
    dsm.clear_layout_cache()
    scheds = _schedules(K, range(SEED0, SEED0 + N))[-2:]
    dsm.clear_layout_cache()
    arrs = [treplay.device_arrays(ds, dev) for ds in scheds]
    assert arrs[0]["sig"] == arrs[1]["sig"]
    t = 8 * 1280
    Ds = [torch.from_numpy(_payload(ds, 50 + j, t)).to(dev) for j, ds in enumerate(scheds)]
    want = [treplay.replay(a, D) for a, D in zip(arrs, Ds)]
    streams = [torch.cuda.Stream(dev) for _ in Ds]
    for rnd in range(4):
        got = []
        for j, s in enumerate(streams):
            k = (j + rnd) % 2  # each lane takes either schedule in turn
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                got.append((k, program.replay(arrs[k], Ds[k])))
        for s in streams:
            torch.cuda.current_stream(dev).wait_stream(s)
        assert all(torch.equal(g, want[k]) for k, g in got), rnd
    mine = [program.lookup(arrs[0], t, s.cuda_stream) for s in streams]
    assert mine[0] is not mine[1] and mine[0].slot.data_ptr() != mine[1].slot.data_ptr()
    assert not kernels.take_index_errors(dev)
