"""The port's own copy of the host half (rfc/, precode/, native/, codec/)
against the JAX package's, on the CPU, over K in {10, 100, 1000, 5000}:
RFC parameters and LT tuples, the encoder schedule, decode plans field for
field, and one block decoded by the native host arm."""

import dataclasses

import numpy as np
import pytest

from nanorq_tpu.codec import cache as jcache
from nanorq_tpu.codec.api import Decoder as JDecoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu.native import native_available
from nanorq_tpu.rfc.params import params_init as jparams_init
from nanorq_tpu.rfc.tuples import lt_indices as jlt_indices
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.rfc.params import params_init
from nanorq_tpu_torch.rfc.tuples import lt_indices

KS = [10, 100, 1000, 5000]
T = 16


def _same(a, b) -> bool:
    """Field-for-field equality across the two packages (a class of one name
    counts as one type; arrays by dtype and value)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return type(a) is type(b) and a.dtype == b.dtype and np.array_equal(a, b)
    if type(a).__name__ != type(b).__name__:
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if dataclasses.is_dataclass(a):
        return all(_same(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))
    if type(a).__name__ == "WSchedule":
        return all(_same(getattr(a, f), getattr(b, f)) for f in ("M_pad", "n_out", "Wbits", "rows", "W"))
    return a == b


@pytest.mark.parametrize("K", KS)
def test_params_and_lt_indices_equal(K):
    P, JP = params_init(K), jparams_init(K)
    assert _same(P, JP)
    isis = np.r_[np.arange(P.Kp), np.arange(P.Kp, P.Kp + 300), [(1 << 24) - 1]].astype(np.uint32)
    for got, want in zip(lt_indices(isis, P), jlt_indices(isis, JP)):
        assert _same(got, want)


@pytest.mark.parametrize("K", KS)
def test_encoder_schedule_equal(K):
    Kp = params_init(K).Kp
    assert _same(tcache.encoder_schedule(Kp), jcache.encoder_schedule(Kp))


def _pattern(K, seed, overhead):
    """(P, isis, overhead): a decode pattern with ~6% of the sources lost."""
    P = params_init(K)
    rng = np.random.default_rng(seed)
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    if gaps.size == 0:
        gaps = np.array([K // 2])
    isis = np.arange(P.Kp + overhead, dtype=np.uint32)
    rep = np.arange(P.Kp, P.Kp + gaps.size + overhead, dtype=np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp :] = rep[gaps.size :]
    return P, isis, overhead


@pytest.mark.parametrize("K", KS)
def test_decoder_plan_equal(K):
    """decoder_plan of the port's copy equals the JAX package's, field for
    field, for a binary (overhead > H) and an HDPC-pivot (overhead 2)
    pattern."""
    for seed, overhead in ((K, 15), (K + 1, 2)):
        P, isis, ov = _pattern(K, seed, overhead)
        tcache.clear_decoder_cache()
        jcache.clear_decoder_cache()
        assert _same(tcache.decoder_plan(P, isis, ov), jcache.decoder_plan(jparams_init(K), isis, ov))


@pytest.mark.parametrize("K", KS)
def test_host_arm_decodes_one_block_as_jax(K):
    """One block with ~6% loss, decoded by the native host arm of each
    package, gives the source bytes in both."""
    if not native_available():
        pytest.skip("the host arm needs the native solver")
    rng = np.random.default_rng(K)
    data = rng.integers(0, 256, K * T, dtype=np.uint8)
    enc = Encoder(data.size, T, Al=8, Z=1, device="cpu")
    assert enc.num_blocks == 1 and enc.block_symbols(0) == K
    gaps = np.nonzero(rng.random(K) < 0.06)[0]
    keep = np.setdiff1d(np.arange(K), gaps)
    rep = np.arange(K, K + gaps.size + 3)
    rep_pl = enc.encode_batch(0, rep, MemoryIO(data))
    outs = []
    for dec, mio in ((Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu"), MemoryIO),
                     (JDecoder(enc.oti_common(), enc.oti_scheme_specific()), JMemoryIO)):
        out = np.zeros(data.size, np.uint8)
        io = mio(out)
        dec.add_symbols(data.reshape(K, T)[keep], [make_tag(0, int(e)) for e in keep], io)
        dec.add_symbols(rep_pl, [make_tag(0, int(e)) for e in rep], io)
        assert dec.repair_all(io, backend="host")
        outs.append(out)
    assert np.array_equal(outs[0], outs[1]) and np.array_equal(outs[0], data)
