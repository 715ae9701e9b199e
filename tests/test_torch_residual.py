"""The port's residual decode arms ("res", "res_host") and the "auto" routing
against nanorq_tpu (JAX on CPU) and the source bytes, with the three faults
the port would otherwise inherit:

- F1: "auto" must probe the port's own plan cache (a pattern decoded once
  on the device is warm and goes back to the device);
- F2: the residual arms' canonical w-rows must come from the port's JAX-free
  `res_wrows[_flat]` (tests/test_torch_nojax.py runs them without JAX);
- F3: the default backend is env NANORQ_DECODE_BACKEND, else "auto".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec import cache as jcache
from nanorq_tpu.codec.api import Decoder as JDecoder
from nanorq_tpu.codec.api import Encoder as JEncoder
from nanorq_tpu.codec.oti import make_tag
from nanorq_tpu.io.ioctx import MemoryIO
from nanorq_tpu.native import native_available
from nanorq_tpu.ops.wpath import _res_batch_jit
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu_torch.codec import cache as tcache
from nanorq_tpu_torch.codec.api import Decoder
from nanorq_tpu_torch.ops import wpath
from nanorq_tpu_torch.utils import stats  # the port counts its arms in its own stats

pytestmark = pytest.mark.skipif(not native_available(), reason="the residual arms need the native solver")

T = 96


def _packets(K, nb=3, loss=0.08, overhead_frac=0.05, seed=11):
    """tests/test_residual.py's loss model: (data, oti, [(sbn, esis, payloads)])."""
    rng = np.random.default_rng(seed)
    F = K * T * nb
    data = rng.integers(0, 256, F, dtype=np.uint8)
    payloads = data.reshape(nb * K, T)
    enc = JEncoder(F, T, Al=4, Z=nb)
    src = MemoryIO(data)
    pk = []
    for sbn in range(nb):
        gaps = np.nonzero(rng.random(K) < loss)[0]
        if gaps.size == 0:
            gaps = np.array([0])
        keep = np.setdiff1d(np.arange(K), gaps)
        rep = np.arange(K, K + gaps.size + max(0, int(overhead_frac * K)))
        pk.append((sbn, keep, payloads[sbn * K + keep]))
        pk.append((sbn, rep, enc.encode_batch(sbn, rep, src)))
    return data, (enc.oti_common(), enc.oti_scheme_specific()), pk


def _decode(dec, data, pk, **kw):
    out = np.zeros(data.size, np.uint8)
    io = MemoryIO(out)
    for sbn, esis, pl in pk:
        dec.add_symbols(pl, [make_tag(sbn, int(e)) for e in esis], io)
    assert dec.repair_all(io, **kw)
    return out


def _counts():
    c = stats.snapshot()["counters"]
    return {k: c.get(k, 0) for k in ("repair_device_blocks", "repair_res_blocks", "repair_res_host_blocks",
                                      "repair_host_blocks")}


def _moved(before):
    after = _counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


CASES = {  # name -> _packets arguments (tests/test_residual.py's grid and cases)
    "K18": dict(K=18), "K100": dict(K=100), "K500": dict(K=500), "K1200": dict(K=1200),
    "padding": dict(K=77, nb=2, loss=0.15),
    "zero_overhead": dict(K=200, nb=2, loss=0.05, overhead_frac=0.0, seed=7),
    "heavy_loss": dict(K=300, nb=2, loss=0.4, overhead_frac=0.2, seed=9),
}


@pytest.mark.parametrize("backend", ["res", "res_host", "auto"])
@pytest.mark.parametrize("case", list(CASES))
def test_arms_equal_jax_and_source(backend, case):
    data, oti, pk = _packets(**CASES[case])
    jcache.clear_decoder_cache()
    tcache.clear_decoder_cache()
    want = _decode(JDecoder(*oti), data, pk, backend=backend)
    before = _counts()
    got = _decode(Decoder(*oti, device="cpu"), data, pk, backend=backend)
    assert np.array_equal(got, want) and np.array_equal(got, data)
    moved = _moved(before)
    if backend == "res":
        assert set(moved) == {"repair_res_blocks"}
    elif backend == "res_host":
        assert set(moved) == {"repair_res_host_blocks"}


@pytest.mark.parametrize("K", [300, 500])
def test_f1_warm_auto_runs_on_the_device(K):
    """F1: after a device decode has cached the patterns' plans, "auto" sends
    every block to the device arm and none to a host arm (K' = 301 and 511:
    above the port's warm threshold, `api._RES_HOST_WARM_MAX`; cold, both
    go to "res_host")."""
    data, oti, pk = _packets(K, nb=3, seed=5)
    tcache.clear_decoder_cache()
    before = _counts()
    _decode(Decoder(*oti, device="cpu"), data, pk, backend="auto")  # cold: K' <= 560, res_host
    assert _moved(before) == {"repair_res_host_blocks": 3}
    before = _counts()
    _decode(Decoder(*oti, device="cpu"), data, pk, backend="device")
    assert _moved(before) == {"repair_device_blocks": 3}
    before = _counts()
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk, backend="auto"), data)
    assert _moved(before) == {"repair_device_blocks": 3}


@pytest.mark.parametrize("K,cold,warm", [(100, "res_host", "res_host"), (200, "res_host", "res_host"),
                                         (300, "res_host", "device"), (500, "res_host", "device"),
                                         (700, "host", "device")])
def test_auto_rule_routes_by_kp(K, cold, warm):
    """The port's "auto" rule (set from the H100 host's bench medians, a
    deliberate difference from the JAX package): cold patterns on
    "res_host" up to K' = 560 and on "host" above; warm ones (device plans
    cached) on "res_host" up to K' = 250 and on the device above.  K' =
    101, 200, 301, 511 and 703: both sides of each boundary."""
    data, oti, pk = _packets(K, nb=2, seed=K)
    tcache.clear_decoder_cache()
    for state, arm in (("cold", cold), ("warm", warm)):
        if state == "warm":
            _decode(Decoder(*oti, device="cpu"), data, pk, backend="device")  # caches every plan
        before = _counts()
        assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk, backend="auto"), data)
        assert _moved(before) == {f"repair_{arm}_blocks": 2}


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_auto_rule_routes_cold_plans_by_kind(kind, monkeypatch):
    """Above K' = 560 the cold rule goes by the kind of plan a pattern will
    get: dense-W up to `cache.WPATH_MAX_KP`, structured above, read when the
    rule runs, so structured plans are forced at K' = 703 by lowering it as
    `parallel/_dryrun.py` does.  Both kinds go to "host" cold (the H100
    host's medians: `host` ahead of `device`, or within their spreads, at K
    = 1000 ... 50000); warm, to the device."""
    from nanorq_tpu_torch.codec import api

    if kind == "structured":
        monkeypatch.setattr(tcache, "WPATH_MAX_KP", 0)
        monkeypatch.setattr(tcache, "WPATH_GF256_MAX_KP", 0)
    data, oti, pk = _packets(700, nb=2, seed=12)
    assert api.auto_arm(703, False) == "host" and api.auto_arm(703, True) == "device"
    tcache.clear_decoder_cache()
    before = _counts()
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk, backend="auto"), data)
    assert _moved(before) == {"repair_host_blocks": 2}
    dec, out = Decoder(*oti, device="cpu"), np.zeros(data.size, np.uint8)
    for sbn, esis, pl in pk:
        dec.add_symbols(pl, [make_tag(sbn, int(e)) for e in esis], MemoryIO(out))
    preps = [dec._repair_prepare(s) for s in range(2)]
    assert dec.repair_all(MemoryIO(out), backend="device")  # caches every plan
    assert {type(tcache.decoder_plan(dec.P, isis, ov)) for _, isis, ov in preps} == (
        {tcache.WSchedule} if kind == "dense" else {tcache.DeviceSchedule})
    before = _counts()
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk, backend="auto"), data)
    assert _moved(before) == {"repair_device_blocks": 2}


@pytest.mark.parametrize("K", [100, 1000])
def test_f2_res_wrows_equal_jax(K, monkeypatch):
    """F2: the port's canonical w-rows equal nanorq_tpu's byte for byte, from
    its own memo, which stays bounded by NANORQ_WROW_CACHE_MB."""
    P = params_init(K)
    rng = np.random.default_rng(K)
    isis = (P.Kp + rng.permutation(60)[:40]).astype(np.uint32)
    batch = [isis[:25], isis[10:], isis[:3]]
    jcache.clear_decoder_cache()
    tcache.clear_decoder_cache()
    want = jcache.res_wrows(P, isis)
    got = tcache.res_wrows(P, isis)
    assert got.dtype == np.uint8 and got.shape == (40, jcache.res_kcols(P)) and np.array_equal(got, want)
    assert np.array_equal(tcache.res_wrows(P, isis[::-1]), want[::-1])  # from the memo
    for a, b in zip(tcache.res_wrows_flat(P, batch), jcache.res_wrows_flat(P, batch)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.setattr(tcache, "_WROW_CACHE_MB", 4 * jcache.res_kcols(P) / (1 << 20))
    tcache.clear_decoder_cache()
    assert np.array_equal(tcache.res_wrows(P, isis), want)
    assert len(tcache._wrow_cache) == 4


def test_f3_default_backend_is_auto(monkeypatch):
    """F3: with NANORQ_DECODE_BACKEND unset, repair_all(io) routes as "auto"
    (a cold small-K' pattern goes to res_host); the env still overrides."""
    data, oti, pk = _packets(60, nb=2, seed=3)
    monkeypatch.delenv("NANORQ_DECODE_BACKEND", raising=False)
    tcache.clear_decoder_cache()
    before = _counts()
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk), data)
    assert _moved(before) == {"repair_res_host_blocks": 2}
    monkeypatch.setenv("NANORQ_DECODE_BACKEND", "res")
    before = _counts()
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk), data)
    assert _moved(before) == {"repair_res_blocks": 2}


def test_res_raises_without_the_factorization(monkeypatch):
    """"res" raises where nanorq_tpu would quietly reroute to the host."""
    data, oti, pk = _packets(60, nb=2, seed=4)
    monkeypatch.setattr(tcache, "canonical_state", lambda P: None)
    with pytest.raises(RuntimeError, match="res"):
        _decode(Decoder(*oti, device="cpu"), data, pk, backend="res")
    before = _counts()  # res_host keeps the reference's reroute to the host arm
    assert np.array_equal(_decode(Decoder(*oti, device="cpu"), data, pk, backend="res_host"), data)
    assert _moved(before) == {"repair_host_blocks": 2}
    with pytest.raises(ValueError, match="backend"):
        _decode(Decoder(*oti, device="cpu"), data, pk, backend="gpu")


def test_res_apply_batch_equals_jax():
    rng = np.random.default_rng(17)
    nb, nr, k, g, t = 3, 9, 40, 6, 24
    W, D0 = rng.integers(0, 256, (nb, nr, k), dtype=np.uint8), rng.integers(0, 256, (nb, k, t), dtype=np.uint8)
    R, y = rng.integers(0, 256, (nb, g, nr), dtype=np.uint8), rng.integers(0, 256, (nb, nr, t), dtype=np.uint8)
    want = np.asarray(_res_batch_jit(*(jnp.asarray(a) for a in (W, D0, R, y))))
    got = wpath.res_apply_batch(*(torch.from_numpy(a) for a in (W, D0, R, y)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["res", "auto"])
def test_arms_on_card(backend):
    """On the card: "res" goes through batched K3; "auto" after a device
    decode stays on the device.  Bytes equal the source."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    from nanorq_tpu_torch.ops import kernels

    data, oti, pk = _packets(500, nb=3, seed=8)
    tcache.clear_decoder_cache()
    if backend == "auto":
        _decode(Decoder(*oti, device="cuda"), data, pk, backend="device")
    before, launches = _counts(), kernels.LAUNCHES["gf256_matmul"]
    assert np.array_equal(_decode(Decoder(*oti, device="cuda"), data, pk, backend=backend), data)
    assert _moved(before) == {"repair_res_blocks" if backend == "res" else "repair_device_blocks": 3}
    if backend == "res":
        assert kernels.LAUNCHES["gf256_matmul"] == launches + 2  # one chunk: two batched launches
