"""The port's encode + device-decode slice vs nanorq_tpu (JAX on CPU) and the
original bytes: Encoder.encode_batch, codec.batch, and Decoder round trips
through every decode plan kind."""

import dataclasses

import numpy as np
import pytest
import torch

from nanorq_tpu.codec import batch as jbatch
from nanorq_tpu.codec import cache as jcache
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.codec.oti import make_tag
from nanorq_tpu.io.ioctx import MemoryIO
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder, Encoder

K, T, Z = 100, 64, 3


def _object(seed=1):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, 256, K * T * Z, dtype=np.uint8)


def test_encode_batch_equals_jax():
    _, data = _object()
    esis = np.r_[np.arange(0, K, 7), np.arange(K, K + 40)]
    for sbn in range(Z):
        want = JEncoder(data.size, T, Al=8, Z=Z).encode_batch(sbn, esis, MemoryIO(data))
        got = Encoder(data.size, T, Al=8, Z=Z, device="cpu").encode_batch(sbn, esis, MemoryIO(data))
        assert np.array_equal(got, want)


def test_codec_batch_equals_jax():
    _, data = _object(2)
    jb = jbatch.load_object(JEncoder(data.size, T, Al=8, Z=Z), MemoryIO(data))
    want = jbatch.repair_symbols(jb, 25)
    tb = tbatch.load_object(Encoder(data.size, T, Al=8, Z=Z, device="cpu"), MemoryIO(data))
    got = tbatch.repair_symbols(tb, 25, "cpu")
    assert np.array_equal(tb.C.numpy(), np.asarray(jb.C))
    assert sorted(got) == sorted(want)
    for b in got:
        assert np.array_equal(got[b], want[b])


def _lossy_decoder(data, rng, loss=0.06, overhead=None, device="cpu"):
    """A port Decoder fed with the bench loss model: ~6% of source ESIs lost,
    gaps + 5% repair symbols delivered (or gaps + `overhead`)."""
    enc = Encoder(data.size, T, Al=8, Z=Z, device=device)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=device)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    payloads = data.reshape(Z * K, T)
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < loss)[0]
        nrep = gaps.size + (max(1, int(0.05 * K)) if overhead is None else overhead)
        keep = np.setdiff1d(np.arange(K), gaps)
        rep_esis = np.arange(K, K + nrep)
        dec.add_symbols(payloads[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
        dec.add_symbols(enc.encode_batch(sbn, rep_esis, MemoryIO(data)),
                        [make_tag(sbn, int(e)) for e in rep_esis], io)
    return dec, io, out


@pytest.mark.parametrize("case", ["gf2_w", "gf256_w", "structured"])
def test_decode_round_trip_device(case, monkeypatch):
    """repair_all(backend="device") restores the object through each plan
    kind: GF(2) W (overhead > H), GF(256) W (overhead < H forces HDPC
    pivots) and the structured replay (W path cut off, the bench's 5%
    overhead)."""
    from nanorq_tpu.native import native_available

    if case != "structured" and not native_available():
        pytest.skip("W plans need the native solver")
    if case == "structured":
        monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
        monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()
    rng, data = _object(3)
    dec, io, out = _lossy_decoder(data, rng, overhead={"gf2_w": 15, "gf256_w": 2}.get(case))
    preps = [dec._repair_prepare(sbn) for sbn in range(Z)]
    assert dec.repair_all(io, backend="device")
    assert np.array_equal(out, data)
    for gaps, isis, ov in preps:
        assert _kind(tcache.decoder_plan(dec.P, isis, ov)) == case


def _kind(plan) -> str:
    if isinstance(plan, (jcache.WSchedule, tcache.WSchedule)):
        return "gf2_w" if plan.Wbits is not None else "gf256_w"
    return "structured"


def _same(a, b) -> bool:
    """Field-for-field equality of decode plans (arrays by dtype and value);
    the two packages' classes of one name count as one type."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b)
    if type(a).__name__ != type(b).__name__:
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if isinstance(a, tcache.WSchedule):
        return all(_same(getattr(a, f), getattr(b, f)) for f in ("M_pad", "n_out", "Wbits", "rows", "W"))
    return a == b


@pytest.mark.parametrize("case", ["gf2_w", "gf256_w", "structured"])
def test_decoder_plan_equals_jax(case, monkeypatch):
    """The port's decoder_plan (with its own W constructors) returns the plan
    nanorq_tpu.codec.cache.decoder_plan returns, field for field."""
    from nanorq_tpu.native import native_available

    if case != "structured" and not native_available():
        pytest.skip("W plans need the native solver")
    if case == "structured":
        for cache in (jcache, tcache):
            monkeypatch.setattr(cache, "WPATH_MAX_KP", 0)
            monkeypatch.setattr(cache, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()
    rng, data = _object(9)
    dec, _, _ = _lossy_decoder(data, rng, overhead={"gf2_w": 15, "gf256_w": 2}.get(case))
    for sbn in range(Z):
        _gaps, isis, ov = dec._repair_prepare(sbn)
        got, want = tcache.decoder_plan(dec.P, isis, ov), jcache.decoder_plan(dec.P, isis, ov)
        assert _kind(got) == case and _same(got, want)


def test_repair_block_and_host_arm():
    rng, data = _object(4)
    dec, io, out = _lossy_decoder(data, rng)
    for sbn in range(Z):
        assert dec.repair_block(io, sbn)
    assert np.array_equal(out, data)
    rng, data = _object(5)
    dec, io, out = _lossy_decoder(data, rng)
    assert dec.repair_all(io, backend="host")
    assert np.array_equal(out, data)


def test_decode_equals_jax_decoder():
    """The JAX Decoder and the port's recover the same bytes from the same packets."""
    from nanorq_tpu.codec.api import Decoder as JDecoder

    rng, data = _object(6)
    enc = JEncoder(data.size, T, Al=8, Z=Z)
    packets = []
    for sbn in range(Z):
        gaps = np.nonzero(rng.random(K) < 0.1)[0]
        keep = np.setdiff1d(np.arange(K), gaps)
        rep = np.arange(K, K + gaps.size + 6)
        packets.append((sbn, keep, rep, enc.encode_batch(sbn, rep, MemoryIO(data))))
    outs = []
    for dec in (JDecoder(enc.oti_common(), enc.oti_scheme_specific()),
                Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")):
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn, keep, rep, pl in packets:
            dec.add_symbols(data.reshape(Z * K, T)[sbn * K + keep], [make_tag(sbn, int(e)) for e in keep], io)
            dec.add_symbols(pl, [make_tag(sbn, int(e)) for e in rep], io)
        assert dec.repair_all(io, backend="device")
        outs.append(out)
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[1], data)


@pytest.mark.parametrize("kw", [{"mesh": object()}])
def test_unported_arms_raise(kw):
    """No arm is left unported: `mesh=` takes a Mesh of the port's lanes and
    refuses anything else (a JAX mesh, say) before it splits any work."""
    from nanorq_tpu_torch.parallel.mesh import make_mesh

    rng, data = _object(7)
    dec, io, _ = _lossy_decoder(data, rng)
    with pytest.raises(TypeError):
        dec.repair_all(io, **kw)
    enc = Encoder(data.size, T, Al=8, Z=Z, device="cpu")
    with pytest.raises(TypeError):
        enc.encode_batch(0, np.arange(K, K + 3), MemoryIO(data), mesh=kw["mesh"])
    mesh = make_mesh(["cpu"] * 2)
    want = Encoder(data.size, T, Al=8, Z=Z, device="cpu").encode_batch(0, np.arange(K, K + 3), MemoryIO(data))
    assert np.array_equal(enc.encode_batch(0, np.arange(K, K + 3), MemoryIO(data), mesh=mesh), want)
    assert dec.repair_all(io, mesh=mesh)


def test_device_is_explicit():
    with pytest.raises(TypeError):
        Encoder(1000, T)  # no default device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Encoder(1000, T, device="cuda")  # no silent fallback to the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gf2_w", "gf256_w", "structured"])
def test_round_trip_on_card(case, monkeypatch):
    """Encode and device decode on the card, through the kernels, restore
    the object for each decode plan kind; repair symbols equal JAX's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from nanorq_tpu_torch.ops import kernels

    if case == "structured":
        monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
        monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    tcache.clear_decoder_cache()
    rng, data = _object(8)
    kernels.reset_launches()
    dec, io, out = _lossy_decoder(data, rng, overhead={"gf2_w": 15, "gf256_w": 2}.get(case), device="cuda")
    rep = np.arange(K, K + 20)
    want = JEncoder(data.size, T, Al=8, Z=Z).encode_batch(1, rep, MemoryIO(data))
    assert np.array_equal(Encoder(data.size, T, Al=8, Z=Z, device="cuda").encode_batch(1, rep, MemoryIO(data)), want)
    assert dec.repair_all(io, backend="device")
    assert np.array_equal(out, data)
    assert all(kernels.LAUNCHES[n] > 0 for n in ("gather_xor", "gf2_matmul", "gf256_matmul"))
