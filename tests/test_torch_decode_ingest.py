"""The decoder's ingestion matrices and the device arm built from them.

A decoder keeps each block's received source symbols in its ingestion matrix
b.D [K, T], a slot of a host slab (`Decoder._source_rows`;
`parallel.mesh.host_zeros`: pinned on a card, plain numpy on the CPU), and
the device arm builds every block's patched matrix on the device from b.D
and the repair payloads (`Decoder._repair_parts`, `parallel.mesh.assemble`:
b.D uploaded as it is, the repair rows placed into the gap and overhead rows
by K1 with output rows).  Here, on the CPU with the kernels' plain versions:
the helpers, and `repair_all(backend="device")` restoring the object byte
for byte, equal to what `nanorq_tpu`'s Decoder (its default arm) makes of
the same deliveries, made from a numpy seed, for each plan kind (dense-W
GF(2), dense-W GF(256), structured) and each way of delivering: symbol by
symbol, a batched partial burst, the in-order fast path with a partial last
block, duplicates, sub-blocks (N > 1), and a repair that fails for lack of
repair symbols and succeeds once more arrive, with b.D unchanged by the
failure.  The slabs: pageable `parallel.mesh.HostSlab`s, page-aligned, unless
the device arm may read the decoder (`codec.api._device_may_read`).  On the
card (`cuda`): a warm decoder's b.D is pinned and its device decode copies
nothing through pageable memory; a decoder that "auto" sends to a host arm
pins nothing; a cold device decode page-locks its slabs in place, copies
nothing through pageable memory, and unpins them when the decoder dies."""

import gc
import weakref

import numpy as np
import pytest
import torch

from nanorq_tpu.codec.api import Decoder as JDecoder
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.parallel import mesh as tmesh

KINDS = ("gf2_w", "gf256_w", "structured")
OVERHEAD = {"gf2_w": 15, "gf256_w": 2, "structured": 5}  # overhead < H forces HDPC pivots: GF(256) W
MODES = ("single", "burst", "fast", "dups", "subblocks")


def test_pinned_class_and_slab_blocks(monkeypatch):
    assert [tmesh.pinned_class(n) for n in (1, 2, 3, 1 << 20, (1 << 20) + 1)] == [1, 2, 4, 1 << 20, 1 << 21]
    one = 1000 * 1280  # K = 1000, T = 1280: 2 MiB pinned for 1.28 MB
    assert tmesh.slab_blocks(1, one) == 1
    g = tmesh.slab_blocks(64, one)
    assert g == 13 and g * one <= 16 << 20
    assert tmesh.slab_blocks(128, 100 * 1280) == 1  # 128000 in 131072: no slab pins less
    monkeypatch.setattr(tmesh, "SLAB_MOST", 2)
    assert tmesh.slab_blocks(3, one) in (1, 2)


def test_host_slab_is_page_aligned_and_lives_with_its_views():
    """A HostSlab is zeroed, writable, starts on a page and fills whole pages;
    a view keeps it alive after the array is gone; nothing is pinned on the
    CPU."""
    import mmap

    a = np.asarray(tmesh.HostSlab((3, 1000, 48)))
    slab = tmesh.slab_of(a)
    assert isinstance(slab, tmesh.HostSlab) and a.shape == (3, 1000, 48) and a.dtype == np.uint8
    assert a.ctypes.data % mmap.PAGESIZE == 0 and slab.nbytes % mmap.PAGESIZE == 0 and slab.nbytes >= a.nbytes
    assert not a.any() and a.flags.writeable and tmesh.pinned_bytes(a) == 0 and slab.pinned_on is None
    view = a[1, 5:9]
    del a
    view[:] = 7
    assert tmesh.slab_of(view) is slab and np.asarray(slab)[1, 5:9].all()
    assert tmesh.slab_of(np.zeros(4, np.uint8)) is None and tmesh.HostSlab.registered == 0


def test_device_may_read_follows_the_rule(monkeypatch):
    """A decoder's slabs are pinned from the start only where the device arm
    is likely to read it: under "auto", where the cold rule sends K' to the
    device, or where a device plan of K' was built (the device arm read a
    decoder of K' before); "device" always; a host arm never."""
    from nanorq_tpu_torch.codec import api

    monkeypatch.delenv("NANORQ_DECODE_BACKEND", raising=False)
    tcache.clear_decoder_cache()
    rule = api.auto_rule()
    Kp = next(k for k in (1002, 5008, 10017, 20152, 50511) if api.auto_arm(k, False) != "device")
    assert not api._device_may_read(Kp) and not api._device_may_read(rule["res_host_max"])
    monkeypatch.setattr(tcache, "_planned_kps", {Kp})  # as decoder_plan leaves it
    assert api._device_may_read(Kp) and tcache.has_device_plans(Kp)
    tcache.clear_decoder_cache()
    assert not tcache.has_device_plans(Kp)
    monkeypatch.setenv("NANORQ_DECODE_BACKEND", "device")
    assert api._device_may_read(rule["res_host_max"])
    monkeypatch.setenv("NANORQ_DECODE_BACKEND", "host")
    monkeypatch.setattr(tcache, "_planned_kps", {Kp})
    assert not api._device_may_read(Kp)
    monkeypatch.delenv("NANORQ_DECODE_BACKEND")
    rng, data, (jenc, oc, osch) = _case("burst")
    steps, _ = _plan(jenc, data, rng, "burst", "gf2_w")
    dec, out = Decoder(oc, osch, device="cpu"), np.zeros(data.size, np.uint8)
    assert not dec._pin  # nothing is pinned on the CPU
    _feed(dec, MemoryIO(out), steps)
    assert dec.repair_all(MemoryIO(out), backend="device") and np.array_equal(out, data)
    assert tcache.has_device_plans(dec.P.Kp)  # decoder_plan built them


def test_host_zeros_on_the_cpu():
    a = tmesh.host_zeros((2, 3, 5), "cpu")
    assert isinstance(a, np.ndarray) and a.shape == (2, 3, 5) and a.dtype == np.uint8 and not a.any()


def _assemble_want(shape, heads, extra, places):
    n, rows, w = shape
    want = np.zeros((n * rows, w), np.uint8)
    for j, h in enumerate(heads):
        if h is not None:
            want[j * rows : j * rows + h.shape[0]] = h
    want[places] ^= np.concatenate(extra)
    return want.reshape(shape)


def test_assemble_on_the_cpu():
    """Heads of unequal rows and a missing one, the rows past them zero, the
    extra rows placed where `places` says; over three lanes each run alike."""
    rng = np.random.default_rng(3)
    shape = (4, 9, 7)
    heads = [rng.integers(0, 256, (5, 7), dtype=np.uint8), rng.integers(0, 256, (5, 7), dtype=np.uint8), None,
             rng.integers(0, 256, (4, 7), dtype=np.uint8)]
    for h in heads:
        if h is not None:
            h[1] = 0  # a gap: zero, as in b.D
    extra = [rng.integers(0, 256, (2, 7), dtype=np.uint8), rng.integers(0, 256, (4, 7), dtype=np.uint8)]
    places = np.array([1, 6, 9 + 1, 18 + 0, 18 + 8, 27 + 2])
    lane = tmesh.local_mesh("cpu").lanes[0]
    got = tmesh.assemble(lane, shape, heads, extra, places)
    assert np.array_equal(got.numpy(), _assemble_want(shape, heads, extra, places))

    def part(lo, hi):  # places counted in each run's own stack
        mask = [lo <= p // 9 < hi for p in places]
        return heads[lo:hi], [np.concatenate(extra)[mask]], places[mask] - lo * 9

    sh = tmesh.shard_assemble(4, tmesh.make_mesh(["cpu"] * 3), shape[1:], part)
    assert sh.ranges == [(0, 2), (2, 3), (3, 4)]
    assert np.array_equal(torch.cat(sh.parts).numpy(), got.numpy())


def _encoders(F, T, **kw):
    jenc = JEncoder(F, T, **kw)
    return jenc, jenc.oti_common(), jenc.oti_scheme_specific()


def _symbols(jenc, data, sbn, esis):
    """The JAX package's encoder's payloads of `esis` (source and repair)."""
    return jenc.encode_batch(sbn, np.asarray(esis, np.int64), JMemoryIO(data))


def _plan(jenc, data, rng, mode, kind):
    """(steps, gaps per block): the deliveries of `mode`, each step ("one",
    payload, tag) or ("many", payloads, tags).  Every block that loses
    source symbols gets gaps + OVERHEAD[kind] repair symbols."""
    ov = OVERHEAD[kind]
    Z = jenc.num_blocks
    steps, lost = [], {}
    per = []
    for sbn in range(Z):
        K = jenc.block_symbols(sbn)
        if mode == "fast" and sbn < Z - 1:
            gaps = np.zeros(0, np.int64)  # complete in the fast path: never repaired
        else:
            gaps = np.nonzero(rng.random(K) < 0.08)[0]
            if gaps.size == 0:
                gaps = np.array([K // 2])
        kept = np.setdiff1d(np.arange(K), gaps)
        rep = np.arange(K, K + gaps.size + ov) if gaps.size else np.zeros(0, np.int64)
        lost[sbn] = gaps
        per.append((sbn, kept, rep))
    if mode == "fast":  # one in-order burst of every source received, then the last block's repair
        pl = np.concatenate([_symbols(jenc, data, s, kept) for s, kept, _ in per])
        tags = [make_tag(s, int(e)) for s, kept, _ in per for e in kept]
        s, _, rep = per[-1]
        return [("many", pl, tags), ("many", _symbols(jenc, data, s, rep), [make_tag(s, int(e)) for e in rep])], lost
    for sbn, kept, rep in per:
        esis = np.concatenate([kept, rep])
        if mode == "single":
            for e in rng.permutation(esis):
                steps.append(("one", _symbols(jenc, data, sbn, [e])[0], make_tag(sbn, int(e))))
            continue
        if mode == "dups":  # repeats within one batch and across batches
            esis = np.concatenate([esis, kept[:5], rep[:3]])
        esis = rng.permutation(esis)
        steps.append(("many", _symbols(jenc, data, sbn, esis), [make_tag(sbn, int(e)) for e in esis]))
    if mode == "dups":
        s, kept, rep = per[0]
        again = np.concatenate([kept[:4], rep[:2]])
        steps.append(("many", _symbols(jenc, data, s, again), [make_tag(s, int(e)) for e in again]))
        steps.append(("one", _symbols(jenc, data, s, [kept[0]])[0], make_tag(s, int(kept[0]))))
    return steps, lost


def _feed(dec, io, steps) -> list:
    st = []
    for how, pl, tags in steps:
        if how == "one":
            st.append(dec.add_symbol(pl.tobytes(), tags, io))
        else:
            st.extend(dec.add_symbols(pl, tags, io))
    return st


def _case(mode):
    """(data, JAX encoder, oti) of a mode: K ~ 100 blocks at T = 48, the last
    symbol short; sub-blocks: N = 4 at T = 256."""
    rng = np.random.default_rng(MODES.index(mode) + 40)
    if mode == "subblocks":
        F, T, kw = 2 * 100 * 256 - 29, 256, {"Al": 4, "Z": 2, "N": 4}
    else:
        F, T, kw = 3 * 100 * 48 - 37, 48, {"Al": 8, "Z": 3}  # three blocks share one slab
    data = rng.integers(0, 256, F, dtype=np.uint8)
    return rng, data, _encoders(F, T, **kw)


def _kind(plan) -> str:
    if isinstance(plan, tcache.WSchedule):
        return "gf2_w" if plan.Wbits is not None else "gf256_w"
    return "structured"


def _force(kind, monkeypatch):
    if kind != "structured" and not native_available():
        pytest.skip("W plans need the native solver")
    if kind == "structured":  # as parallel/_dryrun.py does
        monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
        monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_device_decode_equals_jax(mode, kind, monkeypatch):
    _force(kind, monkeypatch)
    rng, data, (jenc, oc, osch) = _case(mode)
    steps, lost = _plan(jenc, data, rng, mode, kind)
    dec, jdec = Decoder(oc, osch, device="cpu"), JDecoder(oc, osch)
    out, jout = np.zeros(data.size, np.uint8), np.zeros(data.size, np.uint8)
    io, jio = MemoryIO(out), JMemoryIO(jout)
    assert _feed(dec, io, steps) == _feed(jdec, jio, steps)  # statuses too
    if mode == "fast":  # the fast path kept rows for the partial last block alone
        assert [dec._block(s).D is None for s in range(dec.num_blocks)] == [True] * (dec.num_blocks - 1) + [False]
    for sbn, gaps in lost.items():
        b = dec._block(sbn)
        if gaps.size:
            assert b.D.shape == (b.K, dec.scheme.T) and not b.D[gaps].any()
    preps = {s: dec._repair_prepare(s) for s, g in lost.items() if g.size}
    held = {s: dec._block(s).D.copy() for s in preps}
    assert dec.repair_all(io, backend="device") and jdec.repair_all(jio)
    assert np.array_equal(out, data) and np.array_equal(out, jout)
    for s, (_, isis, ov) in preps.items():
        assert _kind(tcache.decoder_plan(dec.P, isis, ov)) == kind
        assert np.array_equal(dec._block(s).D, held[s])  # repair wrote nothing into b.D
    if mode == "burst":  # the same deliveries over two lanes: each lane assembles its run
        dec2, out2 = Decoder(oc, osch, device="cpu"), np.zeros(data.size, np.uint8)
        _feed(dec2, MemoryIO(out2), steps)
        assert dec2.repair_all(MemoryIO(out2), mesh=tmesh.make_mesh(["cpu"] * 2))
        assert np.array_equal(out2, data)


@pytest.mark.parametrize("kind", KINDS)
def test_repair_fails_then_succeeds(kind, monkeypatch):
    """One block gets one repair symbol fewer than its gaps: repair_all fails
    for it, repairs the others, and leaves every b.D as it was; once more
    repair symbols arrive it succeeds.  The JAX package's decoder, fed the
    same, writes the same bytes at each step."""
    _force(kind, monkeypatch)
    rng, data, (jenc, oc, osch) = _case("burst")
    steps, lost = _plan(jenc, data, rng, "burst", kind)
    short = 1
    K = jenc.block_symbols(short)
    ng = lost[short].size
    have = np.nonzero(~np.isin(np.arange(K), lost[short]))[0]
    first = np.concatenate([have, np.arange(K, K + ng - 1)])  # one repair symbol short
    steps[short] = ("many", _symbols(jenc, data, short, first), [make_tag(short, int(e)) for e in first])
    dec, jdec = Decoder(oc, osch, device="cpu"), JDecoder(oc, osch)
    out, jout = np.zeros(data.size, np.uint8), np.zeros(data.size, np.uint8)
    io, jio = MemoryIO(out), JMemoryIO(jout)
    assert _feed(dec, io, steps) == _feed(jdec, jio, steps)
    held = {s: dec._block(s).D.copy() for s in lost}
    assert not dec.repair_all(io, backend="device") and not jdec.repair_all(jio)
    assert np.array_equal(out, jout) and dec.num_missing(short) == ng
    assert all(np.array_equal(dec._block(s).D, held[s]) for s in lost)
    more = np.arange(K + ng - 1, K + ng + OVERHEAD[kind])
    late = [("many", _symbols(jenc, data, short, more), [make_tag(short, int(e)) for e in more])]
    assert _feed(dec, io, late) == _feed(jdec, jio, late)
    assert dec.repair_all(io, backend="device") and jdec.repair_all(jio)
    assert np.array_equal(out, data) and np.array_equal(out, jout)


def test_slab_slots_and_reset():
    """Blocks share slabs (`_slab_g` a slab); a slot handed out again after
    reset() or cleanup() starts from zero, and the slab stays while other
    blocks hold slots of it; `ingest_bytes` counts the slabs."""
    rng, data, (jenc, oc, osch) = _case("burst")
    steps, lost = _plan(jenc, data, rng, "burst", "gf2_w")
    dec = Decoder(oc, osch, device="cpu")
    io = MemoryIO(np.zeros(data.size, np.uint8))
    _feed(dec, io, steps)
    g = dec._slab_g
    assert g == dec.num_blocks == 3  # 4800-byte blocks: three fill 16 KiB, one alone pins 8 KiB
    bases = {s: dec._block(s).D.base is not None for s in lost}
    assert all(bases.values()) and len(dec._slabs) == -(-dec.num_blocks // g)
    held, pinned = dec.ingest_bytes()
    assert held == pinned == sum(s.nbytes for s in dec._slabs.values())
    b0 = dec._block(0)
    assert b0.D.any()
    dec.reset(0)
    assert dec._block(0).D is None
    dec.add_symbol(_symbols(jenc, data, 0, [3])[0].tobytes(), make_tag(0, 3), io)
    D = dec._block(0).D
    assert D[3].any() and not np.delete(D, 3, axis=0).any()  # the old rows are gone
    dec.cleanup(1)
    assert len(dec._slabs) == 1
    dec.add_symbol(_symbols(jenc, data, 1, [0])[0].tobytes(), make_tag(1, 0), io)
    assert not dec._block(1).D[1:].any()


@pytest.mark.parametrize("how", ["cleanup", "reset"])
def test_slabs_are_freed_once_no_block_holds_them(how, monkeypatch):
    """With one block a slab, cleaning up (or resetting) a block frees its
    slab and no other; once every block is done the decoder holds no slab
    and `ingest_bytes` is zero.  A block fed again gets a fresh slab."""
    monkeypatch.setattr(tmesh, "SLAB_MOST", 1)
    rng, data, (jenc, oc, osch) = _case("burst")
    steps, _ = _plan(jenc, data, rng, "burst", "gf2_w")
    dec = Decoder(oc, osch, device="cpu")
    io = MemoryIO(np.zeros(data.size, np.uint8))
    _feed(dec, io, steps)
    assert dec._slab_g == 1 and len(dec._slabs) == dec.num_blocks == 3
    refs = {i: weakref.ref(s) for i, s in dec._slabs.items()}
    getattr(dec, how)(0)
    gc.collect()
    assert refs[0]() is None and all(refs[i]() is not None for i in (1, 2))
    for sbn in (1, 2):
        getattr(dec, how)(sbn)
    gc.collect()
    assert dec._slabs == {} and dec.ingest_bytes() == (0, 0) and all(r() is None for r in refs.values())
    dec.add_symbol(_symbols(jenc, data, 2, [1])[0].tobytes(), make_tag(2, 1), io)
    assert list(dec._slabs) == [2] and dec._block(2).D[1].any()


def _card_object(K=1000, T=1280, Z=8, seed=5):
    """(data, encoder of the card, deliveries, feed): Z blocks at 6% loss and
    50 repair symbols more than the gaps; feed(dec) ingests them."""
    from nanorq_tpu_torch.codec.api import Encoder

    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=Z, device="cuda")
    sends = []
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < 0.06)[0]
        rep = np.arange(K, K + gaps.size + 50)
        sends.append((sbn, np.setdiff1d(np.arange(K), gaps), rep, enc.encode_batch(sbn, rep, MemoryIO(data))))
    rows = data.reshape(Z * K, T)

    def decoder():
        dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cuda")
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn, keep, rep, pl in sends:
            dec.add_symbols(rows[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(pl, [make_tag(sbn, int(e)) for e in rep], io)
        return dec, io, out

    return data, enc, decoder


def _copies(prof) -> list:
    return [e.key for e in prof.key_averages() if e.key.startswith("Memcpy")]


def _allocated() -> int:
    """What PyTorch's pinned host cache holds (0 where this torch has no count)."""
    if not hasattr(torch.cuda, "host_memory_stats"):
        return 0
    return torch.cuda.host_memory_stats()["allocated_bytes.current"]


@pytest.mark.cuda
def test_pinned_ingestion_and_no_pageable_copy_on_card(monkeypatch):
    """On the card a decoder of a K' whose device plans were built (the device
    arm read a decoder of K' before) has every ingestion matrix pinned from the start,
    and a warm device decode (K = 1000, 8 blocks) copies nothing from or into
    pageable memory and restores the object.  The slabs die with their
    decoder, and the next decoder of the size takes them back from PyTorch's
    host cache: it pins nothing new."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from torch.profiler import ProfilerActivity, profile

    from nanorq_tpu_torch.codec.api import auto_arm

    monkeypatch.delenv("NANORQ_DECODE_BACKEND", raising=False)
    data, enc, decoder = _card_object()
    Z = enc.num_blocks

    def decode(pinned: bool):
        dec, io, out = decoder()
        assert [torch.from_numpy(dec._block(s).D).is_pinned() for s in range(Z)] == [pinned] * Z
        return dec, io, out

    tcache.clear_decoder_cache()
    dec, io, out = decode(auto_arm(enc.P.Kp, False) == "device")
    assert dec.repair_all(io, backend="device") and np.array_equal(out, data)  # cold: plans cached
    assert tcache.has_device_plans(enc.P.Kp)
    dec, io, out = decode(True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert dec.repair_all(io, backend="device")
    assert np.array_equal(out, data)
    copies = _copies(prof)
    assert copies and not [k for k in copies if "Pageable" in k], copies
    refs = [weakref.ref(s) for s in dec._slabs.values()]
    del dec, io
    gc.collect()
    assert refs and all(r() is None for r in refs)
    if hasattr(torch.cuda, "host_memory_stats"):
        held = _allocated()
        dec, io, out = decode(True)
        assert _allocated() == held


@pytest.mark.cuda
def test_host_routed_decoder_pins_nothing_on_card(monkeypatch):
    """A fresh process's decoder at K = 1000, which "auto" sends to a host arm
    cold: its slabs are pageable `HostSlab`s and stay so through the
    decode, `ingest_bytes()` counts nothing pinned, and once it dies neither
    PyTorch's host cache nor the registered pages hold anything of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from nanorq_tpu_torch.codec.api import auto_arm
    from nanorq_tpu_torch.utils import stats

    monkeypatch.delenv("NANORQ_DECODE_BACKEND", raising=False)
    data, enc, decoder = _card_object(seed=6)
    arm = auto_arm(enc.P.Kp, False)
    assert arm in ("host", "res_host")
    tcache.clear_decoder_cache()
    held, registered = _allocated(), tmesh.HostSlab.registered
    dec, io, out = decoder()
    assert not dec._pin and all(tmesh.slab_of(s) is not None for s in dec._slabs.values())
    assert dec.ingest_bytes()[1] == 0
    before = stats.snapshot()["counters"].get(f"repair_{arm}_blocks", 0)
    assert dec.repair_all(io) and np.array_equal(out, data)
    assert stats.snapshot()["counters"][f"repair_{arm}_blocks"] - before == enc.num_blocks
    assert dec.ingest_bytes()[1] == 0 and tmesh.HostSlab.registered == registered
    del dec, io
    gc.collect()
    assert _allocated() == held and tmesh.HostSlab.registered == registered


@pytest.mark.cuda
def test_cold_device_decode_pins_in_place_and_unpins_on_card(monkeypatch):
    """A decoder built with no device plan of its K' (pageable slabs) that the
    device arm reads anyway (backend "device", cold): its upload page-locks
    each slab in place, copies nothing through pageable memory and restores
    the object; `ingest_bytes` counts the pages; once the decoder dies the
    pages are unregistered and PyTorch's host cache holds no more than
    before (the staging buffers of a first such decode stay cached)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.delenv("NANORQ_DECODE_BACKEND", raising=False)
    data, enc, decoder = _card_object(seed=7)
    registered = tmesh.HostSlab.registered
    for turn in range(2):  # the first decode leaves its staging in the host cache
        tcache.clear_decoder_cache()
        held = _allocated()
        dec, io, out = decoder()
        assert not dec._pin and dec.ingest_bytes()[1] == 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            assert dec.repair_all(io, backend="device")
        assert np.array_equal(out, data)
        copies = _copies(prof)
        assert copies and not [k for k in copies if "Pageable" in k], copies
        slabs = [tmesh.slab_of(s) for s in dec._slabs.values()]
        assert all(s.pinned_on is not None for s in slabs)
        assert dec.ingest_bytes()[1] == sum(s.nbytes for s in slabs) == tmesh.HostSlab.registered - registered
        del dec, io, slabs
        gc.collect()
        assert tmesh.HostSlab.registered == registered
        if turn:
            assert _allocated() == held
