"""Port's LT plan and combine vs nanorq_tpu.ops.lt (JAX on CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec.cache import encoder_schedule
from nanorq_tpu.ops import lt as jlt
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu.rfc.tuples import lt_indices
from nanorq_tpu_torch.ops.lt import lt_combine, lt_plan, lt_plan_from_jax
from nanorq_tpu_torch.ops.replay import device_arrays, replay


def _isis(P, K, rng):
    return np.r_[rng.choice(P.Kp, size=K // 2, replace=False), np.arange(P.Kp, P.Kp + 9)].astype(np.uint32)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("K,mode", [(100, "flat"), (100, "sorted"), (1000, "flat"), (1000, "sorted")])
def test_plan_arrays_equal_jax(K, mode):
    P = params_init(K)
    isis = _isis(P, K, np.random.default_rng(K))
    jp = jlt.lt_plan(isis, P, mode=mode)
    tp = lt_plan(isis, P, "cpu", mode=mode)
    assert (tp.n, tp.n_pad, tp.L) == (jp.n, jp.n_pad, jp.L)
    if mode == "sorted":
        assert len(tp.classes) == len(jp.classes)
        for a, b in zip(tp.classes, jp.classes):
            assert np.array_equal(a.numpy(), _np(b))
        assert np.array_equal(tp.sel.numpy()[:, 0], _np(jp.sel))
    else:
        passes, overflow = jp.plan
        assert len(tp.passes) == len(passes) and len(tp.overflow) == len(overflow)
        for a, b in zip(tp.passes, passes):
            assert np.array_equal(a.numpy(), _np(b))
        for (ix, sel), (jix, jsel) in zip(tp.overflow, overflow):
            assert np.array_equal(ix.numpy(), _np(jix)) and np.array_equal(sel.numpy()[:, 0], _np(jsel))


@pytest.mark.parametrize("K,mode,T", [(10, "auto", 8), (100, "flat", 33), (1000, "sorted", 16), (1000, "auto", 16)])
def test_lt_combine_equals_jax_and_converted_plan(K, mode, T):
    P = params_init(K)
    rng = np.random.default_rng(3 * K + T)
    C = rng.integers(0, 256, (P.L, T), dtype=np.uint8)
    isis = _isis(P, K, rng) if K > 10 else np.arange(P.Kp + 5, dtype=np.uint32)
    jp = jlt.lt_plan(isis, P, mode=mode)
    want = np.asarray(jlt.lt_combine(jnp.asarray(C), jp))
    got = lt_combine(torch.from_numpy(C), lt_plan(isis, P, "cpu", mode=mode)).numpy()
    assert np.array_equal(got, want)

    # the conversion from JAX state: the JAX plan's arrays as numpy
    if jp.classes is not None:
        jp_np = jlt.LTPlan(n=jp.n, n_pad=jp.n_pad, L=jp.L, classes=tuple(np.asarray(c) for c in jp.classes),
                           sel=np.asarray(jp.sel))
    else:
        passes, overflow = jp.plan
        jp_np = jlt.LTPlan(n=jp.n, n_pad=jp.n_pad, L=jp.L, plan=(
            tuple(np.asarray(p) for p in passes), tuple((np.asarray(a), np.asarray(b)) for a, b in overflow)))
    conv = lt_combine(torch.from_numpy(C), lt_plan_from_jax(jp_np, "cpu")).numpy()
    assert np.array_equal(conv, want)


@pytest.mark.parametrize("K", [10, 100, 1000])
def test_lt_combine_systematic(K):
    """LT(C, isi < K) reproduces the source rows; repair rows match a numpy
    LT over rfc.tuples.lt_indices."""
    P = params_init(K)
    rng = np.random.default_rng(K)
    ds = encoder_schedule(P.Kp)
    T = 16
    D = np.zeros((ds.M_pad, T), np.uint8)
    src = rng.integers(0, 256, (K, T), dtype=np.uint8)
    D[:K] = src
    C = replay(device_arrays(ds, "cpu"), torch.from_numpy(D))
    esis = np.concatenate([np.arange(K), np.arange(K, K + 7)])
    isis = (esis + (P.Kp - K) * (esis >= K)).astype(np.uint32)
    sym = lt_combine(C, lt_plan(isis, P, "cpu")).numpy()
    assert np.array_equal(sym[:K], src)
    Cn = C.numpy()
    idx, valid = lt_indices(isis, P)
    for r in range(K, len(esis)):
        want = np.zeros(T, np.uint8)
        for c in idx[r][valid[r]]:
            want ^= Cn[c]
        assert np.array_equal(sym[r], want)


def test_plan_cache_keyed_by_device_and_isis():
    P = params_init(100)
    isis = np.arange(5, dtype=np.uint32)
    a = lt_plan(isis, P, "cpu")
    assert lt_plan(isis.copy(), P, torch.device("cpu")) is a
    assert lt_plan(isis + 1, P, "cpu") is not a
