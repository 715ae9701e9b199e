"""The JAX package's round trips held on the port, on the CPU: the eight
seeded fuzz cases of tests/test_fuzz.py (random size, T in {17, 64, 100,
256, 512, 1280}, Al, Z, loss up to 35%, the fountain retry loop) and the four
cases of tests/test_scale.py (sub-block interleaving, uneven units, Z = 256,
a big-K HDPC system).  The same numpy-seeded inputs go through both
packages: every encode_batch of the port gives the JAX package's bytes, the
object path (`codec.batch`) gives the same repair symbols, and the port's
decoder restores the data block by block (`repair_block`) and in one
`repair_all(backend="device")`.  T = 17 and 100 take the kernels' byte path,
so the live-rows staging and the zero rows past them are held at odd widths."""

import dataclasses

import numpy as np
import pytest

from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import SYM_ADDED, SYM_ERR, SYM_IGN, Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.rfc.tables import Z_MAX


class _Both:
    """The port's and the JAX package's encoders over one object: encode_batch
    of both, held byte for byte; the port's rows returned.  `sent` keeps every
    (sbn, esis, payloads) for a second decode."""

    def __init__(self, data, T, **kw):
        self.enc = Encoder(data.size, T, device="cpu", **kw)
        self.jenc = JEncoder(data.size, T, **kw)
        assert dataclasses.astuple(self.enc.scheme) == dataclasses.astuple(self.jenc.scheme)
        self.io, self.jio = MemoryIO(data), JMemoryIO(data)
        self.sent = []

    def encode(self, sbn, esis):
        esis = np.asarray(esis, np.int64)
        got = self.enc.encode_batch(sbn, esis, self.io)
        want = self.jenc.encode_batch(sbn, esis, self.jio)
        assert got.shape == want.shape and np.array_equal(got, want), f"sbn={sbn}: the port's symbols differ"
        self.sent.append((sbn, esis, got))
        return got

    def object_repairs(self, data):
        """codec.batch's repair symbols equal the per-block ones sent above."""
        n = max(int(e.max()) - self.enc.block_symbols(s) + 1 for s, e, _ in self.sent)
        reps = tbatch.repair_symbols(tbatch.load_object(self.enc, MemoryIO(data)), max(n, 1), "cpu")
        for sbn, esis, pl in self.sent:
            K = self.enc.block_symbols(sbn)
            rep = esis >= K
            assert np.array_equal(reps[sbn][esis[rep] - K], pl[rep]), f"sbn={sbn}: object path differs"

    def decode_all(self, data):
        """A fresh decoder fed every symbol sent, repaired in one repair_all
        on the device arm (the stacked batches and the single-block path)."""
        tcache.clear_decoder_cache()
        dec = Decoder(self.enc.oti_common(), self.enc.oti_scheme_specific(), device="cpu")
        out = np.zeros(data.size, np.uint8)
        io = MemoryIO(out)
        for sbn, esis, pl in self.sent:
            dec.add_symbols(pl, [make_tag(sbn, int(e)) for e in esis], io)
        assert dec.repair_all(io, backend="device")
        assert np.array_equal(out, data)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_roundtrip_equals_jax(seed):
    """tests/test_fuzz.py's draws, seed for seed, through the port."""
    rng = np.random.default_rng(1000 + seed)
    size = int(rng.integers(100, 60_000))
    T = int(rng.choice([17, 64, 100, 256, 512, 1280]))
    Al = int(rng.choice([1, 2, 4, 8]))
    Z = int(rng.choice([0, 1, 2, 4]))
    loss = float(rng.uniform(0, 0.35))
    overhead = int(rng.integers(2, 8))

    data = rng.integers(0, 256, size, dtype=np.uint8)
    out = np.zeros(size, np.uint8)
    both = _Both(data, T, Al=Al, Z=Z)
    dec = Decoder(both.enc.oti_common(), both.enc.oti_scheme_specific(), device="cpu")
    io_out = MemoryIO(out)
    for sbn in range(both.enc.num_blocks):
        K = both.enc.block_symbols(sbn)
        kept = [e for e in range(K) if rng.random() >= loss]
        dropped = K - len(kept)
        esis = kept + list(range(K, K + dropped + overhead))
        for esi, p in zip(esis, both.encode(sbn, esis)):
            assert dec.add_symbol(p.tobytes(), make_tag(sbn, esi), io_out) != SYM_ERR
        ok = dec.repair_block(io_out, sbn)
        retries = 0
        while not ok and retries < 4:  # fountain retry loop: feed more repair
            more = list(range(K + dropped + overhead + 4 * retries, K + dropped + overhead + 4 * (retries + 1)))
            for esi, p in zip(more, both.encode(sbn, more)):
                dec.add_symbol(p.tobytes(), make_tag(sbn, esi), io_out)
            ok = dec.repair_block(io_out, sbn)
            retries += 1
        assert ok, f"seed={seed} sbn={sbn} unrecoverable"
    assert np.array_equal(out, data), f"seed={seed}"
    both.object_repairs(data)
    if native_available():
        both.decode_all(data)


def _lossy_roundtrip(both: _Both, data, loss_pct: float, seed: int, overhead: int = 5) -> None:
    """tests/test_scale.py's _lossy_roundtrip on the port, its symbols held
    against the JAX package's."""
    out = np.zeros(len(data), np.uint8)
    dec = Decoder(both.enc.oti_common(), both.enc.oti_scheme_specific(), device="cpu")
    assert dec.scheme == both.enc.scheme
    io_out = MemoryIO(out)
    rng = np.random.default_rng(seed)
    for sbn in range(both.enc.num_blocks):
        K = both.enc.block_symbols(sbn)
        kept = np.nonzero(rng.random(K) * 100 >= loss_pct)[0]
        nrep = (K - kept.size) + overhead
        esis = np.concatenate([kept, np.arange(K, K + nrep)])
        sts = dec.add_symbols(both.encode(sbn, esis), [make_tag(sbn, int(e)) for e in esis], io_out)
        assert all(s in (SYM_ADDED, SYM_IGN) for s in sts)
        assert dec.repair_block(io_out, sbn), f"repair failed sbn={sbn}"
    assert np.array_equal(out, data)


def _scale_case(name):
    """(data, _Both, loss %, seed, overhead) of one tests/test_scale.py case."""
    if name == "subblock_interleaved":  # N > 1, short final symbol
        rng = np.random.default_rng(21)
        data = rng.integers(0, 256, 50_001, dtype=np.uint8)
        both = _Both(data, 256, Al=4, Z=2, N=4)
        assert both.enc.scheme.N == 4
        return data, both, 8.0, 22, 5
    if name == "subblock_uneven_units":  # T/Al = 30 units over N = 7: long and short sub-blocks
        rng = np.random.default_rng(23)
        data = rng.integers(0, 256, 20_000, dtype=np.uint8)
        return data, _Both(data, 120, Al=4, Z=1, N=7), 10.0, 24, 5
    if name == "z256_max_blocks":  # Z = Z_MAX blocks, the last with a short symbol
        rng = np.random.default_rng(31)
        data = rng.integers(0, 256, Z_MAX * 10 * 64 - 17, dtype=np.uint8)
        both = _Both(data, 64, Al=8, Z=Z_MAX)
        assert both.enc.num_blocks == Z_MAX
        return data, both, 15.0, 32, 3
    # big K, HDPC-dominated: 0.5% loss with 8 repair symbols (< H) puts HDPC
    # rows among the decoder's pivots, and K' > cache.WPATH_MAX_KP, so the
    # decode is the structured replay.  tests/test_scale.py runs K' = 56403
    # at T = 64 (slow-marked); through both packages that takes ~85 s here,
    # so the case is cut to K = 20000 at T = 16 (~15 s)
    K, T = 20000, 16
    rng = np.random.default_rng(41)
    data = rng.integers(0, 256, K * T - 5, dtype=np.uint8)
    both = _Both(data, T, Al=4, Z=1)
    assert both.enc.block_symbols(0) == K and both.enc.P.H > 8
    return data, both, 0.5, 42, 8


@pytest.mark.parametrize("name", ["subblock_interleaved", "subblock_uneven_units", "z256_max_blocks", "bigk_hdpc"])
def test_scale_roundtrip_equals_jax(name):
    data, both, loss, seed, overhead = _scale_case(name)
    _lossy_roundtrip(both, data, loss, seed, overhead)
    both.object_repairs(data)
    if native_available():
        both.decode_all(data)
