"""The sender's object load (`codec.batch.load_object`, `Encoder._load`)
reads a block's symbols as rows (`_read_symbols_into` over
`ioctx.read_rows`): held byte for byte against the JAX package's per-symbol
load (plain NumPy) over every layout (equal blocks, long and short blocks,
a short final symbol, a subset of blocks out of order, sub-block
interleaving) and every backend, with the counters "load_symbols" and
"load_fast"; an I/O shorter than the object zero-pads as the reference
does.  On a card (`cuda`): the matrix is pinned and equals the CPU path's."""

import numpy as np
import pytest
import torch

from nanorq_tpu.codec import batch as jbatch
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.io.ioctx import MemoryIO as JMemoryIO
from nanorq_tpu_torch.codec import batch as tbatch
from nanorq_tpu_torch.codec.api import Encoder
from nanorq_tpu_torch.io.ioctx import FileIO, IOContext, MemoryIO, MmapIO
from nanorq_tpu_torch.utils import stats

T = 256  # a block of K = 24 rows is 6,144 bytes: more than MmapIO's smallest window

# name: (F, Z, N, sbns); K follows from F and Z
LAYOUTS = {
    "equal": (3 * 24 * T, 3, 1, None),
    "long_short": ((3 * 24 + 2) * T, 3, 1, None),  # Kt = 74 over 3 blocks: 25, 25, 24
    "short_final": (3 * 24 * T - 100, 3, 1, None),  # the last symbol is 156 bytes, zero-padded
    "subset": ((3 * 24 + 1) * T - 7, 3, 1, [2, 0]),
    "interleaved": (3 * 24 * T - 100, 3, 2, None),  # N = 2: symbol by symbol
}


def _backends(tmp_path, data: np.ndarray):
    path = tmp_path / "object"
    path.write_bytes(data.tobytes())
    return {
        "memory": lambda: MemoryIO(data.copy()),  # writable: torch's copy
        "memory_readonly": lambda: MemoryIO(data.tobytes()),  # numpy's copy
        "memory_reversed": lambda: MemoryIO(data[::-1].copy()[::-1]),  # negative stride: numpy's copy
        "file": lambda: FileIO(str(path)),
        "mmap": lambda: MmapIO(str(path)),
        "mmap_window": lambda: MmapIO(str(path), window=4096),  # smaller than a block
    }


def _counters() -> dict:
    return dict(stats.snapshot()["counters"])


BACKENDS = ["memory", "memory_readonly", "memory_reversed", "file", "mmap", "mmap_window"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_load_object_equals_the_per_symbol_reads(tmp_path, layout, backend):
    F, Z, N, sbns = LAYOUTS[layout]
    data = np.random.default_rng(F + N).integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=Z, N=N, device="cpu")
    io = _backends(tmp_path, data)[backend]()
    before = _counters()
    batch = tbatch.load_object(enc, io, sbns)
    after = _counters()
    want_sbns = list(range(enc.num_blocks)) if sbns is None else sbns
    assert batch.sbns == want_sbns
    Ks = [enc.block_symbols(s) for s in want_sbns]
    if layout == "long_short":
        assert Ks == [25, 25, 24]
    D = batch.D
    assert not D[max(Ks):].any()  # the rows past the largest K stay zero
    ref = jbatch.load_object(JEncoder(F, T, Al=8, Z=Z, N=N), JMemoryIO(data), sbns).D
    for b, (sbn, K) in enumerate(zip(want_sbns, Ks)):
        band = D[:, b * T : (b + 1) * T]
        assert np.array_equal(band[:K], ref[:K, b * T : (b + 1) * T]), (layout, backend, sbn)
        assert not band[K:].any()
    io.close()
    # the row read serves every symbol but a short final one, and none when N > 1
    short = F % T != 0 and enc.num_blocks - 1 in want_sbns
    fast = 0 if N > 1 else sum(Ks) - short
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in ("load_symbols", "load_fast")}
    assert grew == {"load_symbols": sum(Ks), "load_fast": fast}


@pytest.mark.parametrize("layout", ["equal", "short_final", "interleaved"])
def test_per_block_load_equals_the_per_symbol_reads(layout):
    F, Z, N, _ = LAYOUTS[layout]
    data = np.random.default_rng(F).integers(0, 256, F, dtype=np.uint8)
    enc = Encoder(F, T, Al=8, Z=Z, N=N, device="cpu")
    jenc = JEncoder(F, T, Al=8, Z=Z, N=N)
    io = MemoryIO(data)
    for sbn in range(enc.num_blocks):
        K = enc.block_symbols(sbn)
        D = enc._load(io, sbn).D
        assert np.array_equal(D[:K], jenc._load(JMemoryIO(data), sbn).D[:K])
        assert not D[K:].any()


@pytest.mark.parametrize("backend", ["memory", "memory_readonly", "file"])
def test_an_io_shorter_than_the_object_zero_pads_as_the_reference(tmp_path, backend):
    F, Z, N, _ = LAYOUTS["short_final"]
    data = np.random.default_rng(F).integers(0, 256, F - 30 * T - 5, dtype=np.uint8)  # ends inside block 1
    enc = Encoder(F, T, Al=8, Z=Z, N=N, device="cpu")
    before = _counters()
    D = tbatch.load_object(enc, _backends(tmp_path, data)[backend]()).D
    fast = _counters().get("load_fast", 0) - before.get("load_fast", 0)
    ref = jbatch.load_object(JEncoder(F, T, Al=8, Z=Z, N=N), JMemoryIO(data)).D
    assert np.array_equal(D, ref[: D.shape[0]]) and not ref[D.shape[0] :].any()
    assert fast == len(data) // T  # the rows the I/O holds whole; the rest read apart, zero-padded


class _Plain(IOContext):
    """The default read_rows_at over a bytes object, counting its reads."""

    def __init__(self, buf: bytes):
        self._buf, self.reads = buf, 0

    def read_at(self, offset: int, n: int) -> bytes:
        self.reads += 1
        return self._buf[offset : offset + n]


L = 40
# name: (row offsets in units of L, the read_at calls the default makes)
OFFSETS = {
    "consecutive": ([3, 4, 5, 6, 7], 1),
    "gaps": ([0, 1, 4, 5, 6, 9], 3),
    "shuffled": ([5, 2, 3, 9, 4, 0], 3),
}


@pytest.mark.parametrize("offsets", list(OFFSETS))
@pytest.mark.parametrize("kind", ["memory", "default"])
def test_read_rows_at_fills_a_strided_column_view(kind, offsets):
    units, reads = OFFSETS[offsets]
    buf = np.random.default_rng(len(units)).integers(0, 256, 12 * L, dtype=np.uint8)
    io = MemoryIO(buf) if kind == "memory" else _Plain(buf.tobytes())
    D = np.zeros((len(units) + 2, 3 * L), np.uint8)
    out = D[: len(units), L : 2 * L]  # a block's column band: strided rows
    io.read_rows_at(np.array(units) * L, out)
    assert np.array_equal(out, np.stack([buf[u * L : (u + 1) * L] for u in units]))
    D[: len(units), L : 2 * L] = 0
    assert not D.any()  # nothing landed outside the band
    if kind == "default":
        assert io.reads == reads
    io.read_rows_at(np.zeros(0, np.int64), D[:0, :L])  # no rows: nothing read


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["equal", "long_short_final"])
def test_cuda_load_object_is_pinned_and_equals_the_cpu_path(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    K, Tc, Z = 1000, 1280, 5
    F = Z * K * Tc if layout == "equal" else (Z * K + 3) * Tc - 77
    data = np.random.default_rng(F).integers(0, 256, F, dtype=np.uint8)
    got = {}
    for dev in ("cpu", "cuda:0"):
        batch = tbatch.load_object(Encoder(F, Tc, Al=8, Z=Z, device=dev), MemoryIO(data))
        assert (dev == "cpu") != torch.from_numpy(batch.D).is_pinned()
        got[dev] = batch.D
    live = got["cuda:0"].shape[0]
    assert np.array_equal(got["cuda:0"], got["cpu"][:live]) and not got["cpu"][live:].any()
