"""Port's structured replay vs nanorq_tpu's (JAX on CPU, xla backend) and the
numpy oracle, on encoder schedules (with HDPC) and decode schedules.
Byte equality throughout: GF arithmetic is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec.cache import encoder_schedule
from nanorq_tpu.ops.replay import device_arrays as jax_device_arrays
from nanorq_tpu.ops.replay import replay_device
from nanorq_tpu.precode.device_schedule import compile_device, replay_structured_numpy
from nanorq_tpu.precode.matrix import binary_rows
from nanorq_tpu.precode.solver import _solve_core
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu_torch.ops.replay import device_arrays, replay


def _decode_system(K, ov, seed):
    """A patched decode system, built as tests/test_device_replay.py does."""
    rng = np.random.default_rng(seed)
    P = params_init(K)
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    gaps = rng.choice(K, size=min(ov, K), replace=False)
    isis[gaps] = np.arange(K, K + len(gaps)) + (P.Kp - K)
    isis[P.Kp :] = np.arange(K + len(gaps), K + len(gaps) + ov) + (P.Kp - K)
    st = _solve_core(P, binary_rows(P, isis, overhead=ov), ov)
    assert st is not None
    return st, rng


def _payload(ds, K, T, rng):
    D = np.zeros((ds.M_pad, T), np.uint8)
    D[:K] = rng.integers(0, 256, (K, T), dtype=np.uint8)
    return D


def _check(ds, D):
    want = replay_structured_numpy(D, ds)
    jax_C = np.asarray(replay_device(jax_device_arrays(ds, "xla"), jnp.asarray(D)))
    assert np.array_equal(jax_C, want)
    got = replay(device_arrays(ds, "cpu"), torch.from_numpy(D)).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("K,T", [(10, 8), (100, 32), (1000, 16)])
def test_replay_encoder_schedule(K, T):
    P = params_init(K)
    ds = encoder_schedule(P.Kp)
    assert ds.mhd is not None  # encoder systems take HDPC pivots: K3 runs
    _check(ds, _payload(ds, K, T, np.random.default_rng(K)))


@pytest.mark.parametrize("K,ov,CB,T", [(10, 3, 64, 8), (100, 10, 64, 32), (1000, 30, 256, 13)])
def test_replay_decode_schedule(K, ov, CB, T):
    st, rng = _decode_system(K, ov, K + ov)
    ds = compile_device(st, CB=CB, canonical=True)
    D = np.zeros((ds.M_pad, T), np.uint8)
    D[: params_init(K).Kp + ov] = rng.integers(0, 256, (params_init(K).Kp + ov, T), dtype=np.uint8)
    D[K : params_init(K).Kp] = 0  # padding symbols are zero
    _check(ds, D)


def test_device_arrays_cached_apart_from_jax():
    """The port caches under its own attribute, keyed by device, and leaves
    the JAX executor's _dev_arrays alone (both run in one process)."""
    ds = encoder_schedule(params_init(100).Kp)
    jarr = jax_device_arrays(ds, "xla")
    a = device_arrays(ds, "cpu")
    assert device_arrays(ds, torch.device("cpu")) is a
    assert ds._dev_arrays[1] is jarr
    assert a["piv_rows"].dtype == torch.int32 and a["piv_rows"].shape == (ds.Lpad, 1)
    # bits stay packed, cut to Wut's nonzero rows; what is cut is zero
    wr = a["wut"].shape[0]
    assert a["wut"].shape[1] == ds.wut.shape[1] and np.array_equal(a["wut"].numpy(), ds.wut[:wr])
    assert not ds.wut[wr:].any() and not ds.wut[:, a["wut_k"] // 8 :].any()
    hr, hc = a["mhd"].shape
    assert np.array_equal(a["mhd"].numpy(), ds.mhd[:hr, :hc]) and hc % 16 == 0
    assert not ds.mhd[hr:].any() and not ds.mhd[:, hc:].any()
