"""The port's structured decode -- a block's DeviceSchedule replayed over its
patched matrix, then the LT combine of the gap ISIs -- through the receive
loop (a fresh `Decoder`, `add_symbols` in bursts, `repair_block` a block),
against the plain reference decoder (`rqbench/reference/decode.py`) and the
source: the recovered bytes equal both.  Structured plans are forced at
every K' as `parallel/_dryrun.py` forces them.  Also: a rank-deficient first
try that succeeds once more repair arrives, the counters of the plan's kind
and the spans under `repair.apply`.  The `cuda` cases run the same on the
card, the reference on the card too, and one K=50000 block, whose plan is
structured by default, against its source."""

import numpy as np
import pytest
import torch

from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder, Encoder
from nanorq_tpu_torch.codec.oti import make_tag
from nanorq_tpu_torch.io.ioctx import MemoryIO
from nanorq_tpu_torch.native import native_available
from nanorq_tpu_torch.utils import stats
from rqbench.reference import decode as ref
from rqbench.reference import rfc6330

T = 16  # small, so that the reference's O(L^3) solve stays within seconds at K=1000
BURST = 128
COUNTERS = ("repair_structured_blocks", "repair_dense_blocks", "repair_block_failed")


@pytest.fixture
def structured():
    """Structured plans at every K' (`WPATH_MAX_KP` = `WPATH_GF256_MAX_KP` =
    0), the decoder cache cleared before and the settings restored after."""
    saved = tcache.WPATH_MAX_KP, tcache.WPATH_GF256_MAX_KP
    tcache.WPATH_MAX_KP = tcache.WPATH_GF256_MAX_KP = 0
    tcache.clear_decoder_cache()
    try:
        yield
    finally:
        tcache.WPATH_MAX_KP, tcache.WPATH_GF256_MAX_KP = saved
        tcache.clear_decoder_cache()


def _object(K, Z, seed, t=T, device="cpu"):
    """(data, the port's encoder of it): Z blocks of exactly K symbols."""
    data = np.random.default_rng(seed).integers(0, 256, Z * K * t, dtype=np.uint8)
    enc = Encoder(data.size, t, Al=8, Z=Z, device=device)
    assert enc.num_blocks == Z and all(enc.block_symbols(b) == K for b in range(Z))
    return data, enc


def _pattern(name, K, Z, rng) -> list:
    """Per block, (its lost source ESIs, its overhead):
    - "fixed": the cell's, the same round(6% K) ESIs lost in every block and
      ceil(5% K) overhead;
    - "random": each block its own 10% loss, drawn symbol by symbol, and 2
      overhead;
    - "hdpc": 6% lost, no overhead: the patched system takes HDPC pivots."""
    if name == "fixed":
        lost = np.sort(rng.choice(K, max(1, round(0.06 * K)), replace=False))
        return [(lost, int(np.ceil(0.05 * K)))] * Z
    if name == "random":
        out = []
        for _ in range(Z):
            lost = np.nonzero(rng.random(K) < 0.1)[0]
            out.append((lost if lost.size else np.array([K // 2]), 2))
        return out
    return [(np.sort(rng.choice(K, max(1, round(0.06 * K)), replace=False)), 0) for _ in range(Z)]


def _esis(K, lost, overhead) -> np.ndarray:
    """The kept source ESIs ascending, then lost + overhead repair ESIs."""
    return np.concatenate([np.setdiff1d(np.arange(K), lost), np.arange(K, K + lost.size + overhead)])


def _feed(dec, enc, data, io, sbn, esis, burst=BURST) -> np.ndarray:
    """The block's symbols of `esis` to `add_symbols` in bursts; returns their payloads."""
    payloads = enc.encode_batch(sbn, esis, MemoryIO(data))
    for lo in range(0, esis.size, burst):
        dec.add_symbols(payloads[lo : lo + burst], [make_tag(sbn, int(e)) for e in esis[lo : lo + burst]], io)
    return payloads


def _counters() -> dict:
    got = stats.snapshot()["counters"]
    return {k: got.get(k, 0) for k in COUNTERS}


def _moved(before: dict) -> dict:
    after = _counters()
    return {k: after[k] - before[k] for k in COUNTERS}


def _decode(K, Z, pattern, seed, device="cpu", t=T, check_hdpc=False):
    """The receive loop over an object of Z blocks; returns (data, the
    port's output, per block (esis, payloads), the counters' moves)."""
    data, enc = _object(K, Z, seed, t, device)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device=device)
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    fed = []
    before = _counters()
    for sbn, (lost, ov) in enumerate(_pattern(pattern, K, Z, np.random.default_rng(seed + 1))):
        esis = _esis(K, lost, ov)
        fed.append((esis, _feed(dec, enc, data, io, sbn, esis)))
        if check_hdpc:
            gaps, isis, overhead = dec._repair_prepare(sbn)
            st = tcache.solve_state(dec.P, tcache._patched_rows(dec.P, isis, overhead), overhead)
            assert st.hdpc_used
        assert dec.repair_block(io, sbn)
    return data, out, fed, _moved(before)


@pytest.mark.parametrize("pattern", ["fixed", "random", "hdpc"])
@pytest.mark.parametrize("K", [10, 101, 1000])
def test_structured_decode_equals_the_reference_and_the_source(structured, K, pattern):
    Z = 2
    data, out, fed, moved = _decode(K, Z, pattern, seed=K + 7, check_hdpc=pattern == "hdpc")
    blocks = data.reshape(Z, K, T)
    assert np.array_equal(out, data)
    P = rfc6330.params(K)
    for b, (esis, payloads) in enumerate(fed):
        assert np.array_equal(ref.decode(P, esis, payloads), blocks[b])
    assert moved == {"repair_structured_blocks": Z, "repair_dense_blocks": 0, "repair_block_failed": 0}


def test_a_rank_deficient_first_try_succeeds_after_more_repair(structured):
    K, seed = 10, 291  # 4 lost and no overhead: a rank-deficient system (a search over seeds; the reference confirms)
    P = rfc6330.params(K)
    lost = np.sort(np.random.default_rng(seed).choice(K, 4, replace=False))
    data, enc = _object(K, 1, seed=seed)
    dec = Decoder(enc.oti_common(), enc.oti_scheme_specific(), device="cpu")
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    esis = _esis(K, lost, 0)
    before = _counters()
    payloads = _feed(dec, enc, data, io, 0, esis)
    assert ref.decode(P, esis, payloads) is None
    assert not dec.repair_block(io, 0) and dec.num_missing(0) == lost.size
    assert _moved(before) == {"repair_structured_blocks": 0, "repair_dense_blocks": 0, "repair_block_failed": 1}
    more = np.arange(K + lost.size, K + lost.size + 1)
    payloads = np.concatenate([payloads, _feed(dec, enc, data, io, 0, more)])
    assert dec.repair_block(io, 0) and np.array_equal(out, data)
    assert np.array_equal(ref.decode(P, np.concatenate([esis, more]), payloads), data.reshape(K, T))
    assert _moved(before) == {"repair_structured_blocks": 1, "repair_dense_blocks": 0, "repair_block_failed": 1}


@pytest.mark.parametrize("kind", ["structured", "dense"])
def test_spans_and_counters_by_plan_kind(kind, request):
    """A structured plan's `repair.apply` holds `repair.replay` then
    `repair.lt`, once a block; a dense-W plan's holds neither."""
    if kind == "structured":
        request.getfixturevalue("structured")
    elif not native_available():
        pytest.skip("dense-W plans need the native solver")
    else:
        tcache.clear_decoder_cache()
    K, Z = 101, 3
    with stats.traced():
        data, out, _, moved = _decode(K, Z, "fixed", seed=11)
        spans = stats.take_spans()
    assert np.array_equal(out, data)
    assert moved == {"repair_structured_blocks": Z if kind == "structured" else 0,
                     "repair_dense_blocks": Z if kind == "dense" else 0, "repair_block_failed": 0}
    parent = {}
    for name, par, _, t0, t1 in spans:
        parent.setdefault(name, set()).add(par)
    applies = sorted((t0, t1) for name, _, _, t0, t1 in spans if name == "repair.apply")
    assert len(applies) == Z and parent["repair.apply"] == {"repair_block"}
    inner = [(name, t0, t1) for name, _, _, t0, t1 in spans if name in ("repair.replay", "repair.lt")]
    if kind == "dense":
        assert not inner
        return
    assert parent["repair.replay"] == parent["repair.lt"] == {"repair.apply"}
    for a0, a1 in applies:  # in each apply, the replay's span and then the LT's
        names = [name for name, t0, t1 in sorted(inner, key=lambda s: s[1]) if a0 <= t0 and t1 <= a1]
        assert names == ["repair.replay", "repair.lt"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_structured_k1000_equals_the_reference_on_the_card(structured):
    dev = _card()
    K, Z, t = 1000, 2, 1280
    data, out, fed, moved = _decode(K, Z, "fixed", seed=21, device=dev, t=t)
    assert np.array_equal(out, data)
    P = rfc6330.params(K)
    for b, (esis, payloads) in enumerate(fed):
        assert np.array_equal(ref.decode(P, esis, payloads, device=dev), data.reshape(Z, K, t)[b])
    assert moved == {"repair_structured_blocks": Z, "repair_dense_blocks": 0, "repair_block_failed": 0}


@pytest.mark.cuda
def test_cuda_one_k50000_block_recovers_its_source():
    """The cell's block: K=50000 at T=1280, 3000 ESIs lost, 2500 overhead;
    K' = 50511 takes the structured plan with no forcing."""
    dev = _card()
    tcache.clear_decoder_cache()
    data, out, _, moved = _decode(50000, 1, "fixed", seed=31, device=dev, t=1280)
    assert np.array_equal(out, data)
    assert moved == {"repair_structured_blocks": 1, "repair_dense_blocks": 0, "repair_block_failed": 0}
