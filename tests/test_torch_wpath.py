"""Port's dense-W decode path vs nanorq_tpu.ops.wpath (JAX on CPU): the host W
constructors, GF(2) and GF(256) W apply, single and stacked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec.cache import WSchedule, _patched_rows
from nanorq_tpu.gf256.numpy_ops import gf_matmul
from nanorq_tpu.ops import wpath as jw
from nanorq_tpu.precode.device_schedule import compile_device
from nanorq_tpu.precode.matrix import binary_rows, lt_rows_csr
from nanorq_tpu.precode.solver import solve_state
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu_torch.ops import wpath as tw


@pytest.fixture
def native():
    from nanorq_tpu.native import native_available

    if not native_available():
        pytest.skip("the W path needs the native solver")


def P_H(K):
    return params_init(K).H


def _decode_state(K, seed, ov):
    P = params_init(K)
    rng = np.random.default_rng(seed)
    gaps = np.nonzero(rng.random(K) < 0.08)[0]
    if gaps.size == 0:
        gaps = np.array([1])
    isis = np.arange(P.Kp + ov, dtype=np.uint32)
    rep = (np.arange(K, K + gaps.size + ov) + (P.Kp - K)).astype(np.uint32)
    isis[gaps] = rep[: gaps.size]
    isis[P.Kp :] = rep[gaps.size :]
    st = solve_state(P, _patched_rows(P, isis, ov), ov)
    assert st is not None
    return P, st, gaps, rng


def _payload(ds, st, P, t, rng):
    D = np.zeros((ds.M_pad, t), np.uint8)
    D[: P.Kp + st.overhead] = rng.integers(0, 256, (P.Kp + st.overhead, t), dtype=np.uint8)
    return D


@pytest.mark.parametrize("K,seed", [(100, 4), (500, 5), (1000, 6)])
def test_w_gf2_equals_jax(native, K, seed):
    P, st, gaps, rng = _decode_state(K, seed, ov=max(P_H(K) + 4, K // 20))
    assert not st.hdpc_used
    ds = compile_device(st)
    out = lt_rows_csr(gaps.astype(np.uint32), P)
    Wbits, rows = tw.w_rows_gf2(st, out, zero_row=ds.M_pad - 1)
    jWbits, jrows = jw.w_rows_gf2(st, out, zero_row=ds.M_pad - 1)
    assert np.array_equal(Wbits, jWbits) and np.array_equal(rows, jrows)
    D = _payload(ds, st, P, 40, rng)
    want = np.asarray(jw.w_matmul_gf2(jw.stage_w_gf2(jWbits, jrows), jnp.asarray(D)))
    got = tw.w_apply_gf2(torch.from_numpy(Wbits), torch.from_numpy(rows.reshape(-1, 1)), torch.from_numpy(D))
    assert np.array_equal(got.numpy(), want)
    W, binary = tw.w_rows(st, out, n_cols=ds.M_pad)
    assert binary and np.array_equal(got.numpy(), gf_matmul(W, D))


@pytest.mark.parametrize("K", [27, 100, 500])
def test_w_gf256_equals_jax(native, K):
    """Encoder systems take HDPC pivots: W has GF(256) coefficients."""
    P = params_init(K)
    st = solve_state(P, binary_rows(P))
    assert st.hdpc_used
    ds = compile_device(st)
    rng = np.random.default_rng(K)
    out = lt_rows_csr(np.arange(P.Kp, P.Kp + 20, dtype=np.uint32), P)
    W, binary = tw.w_rows(st, out, n_cols=ds.M_pad)
    jW, jbinary = jw.w_rows(st, out, n_cols=ds.M_pad)
    assert not binary and not jbinary and np.array_equal(W, jW)
    D = np.zeros((ds.M_pad, 24), np.uint8)
    D[:K] = rng.integers(0, 256, (K, 24), dtype=np.uint8)
    want = np.asarray(jw.w_matmul(jw.stage_w(jW, False), jnp.asarray(D)))
    got = tw.w_apply_gf256(torch.from_numpy(W), torch.from_numpy(D)).numpy()
    assert np.array_equal(got, want)


def test_w_stacked_equal_jax(native):
    """Stacked GF(2) and GF(256) W apply == the JAX vmapped batch programs."""
    plans, Ds = [], []
    for seed in range(3):
        P, st, gaps, rng = _decode_state(300, 10 + seed, ov=P_H(300) + 6 + seed)
        ds = compile_device(st)
        Wbits, rows = tw.w_rows_gf2(st, lt_rows_csr(gaps.astype(np.uint32), P), zero_row=ds.M_pad - 1)
        plans.append(WSchedule(ds.M_pad, gaps.size, Wbits=Wbits, rows=rows))
        Ds.append(_payload(ds, st, P, 32, rng))
    M_pad = max(p.M_pad for p in plans)
    plans = [WSchedule(M_pad, p.n_out, Wbits=p.Wbits, rows=np.where(p.rows == p.M_pad - 1, M_pad - 1, p.rows))
             for p in plans]
    D = np.zeros((3, M_pad, 32), np.uint8)
    for j, d in enumerate(Ds):
        D[j, : d.shape[0] - 1] = d[:-1]
    bits, rows = tw.w_stack_gf2(plans)
    jbits, jrows = jw.w_stack_gf2(plans)
    assert np.array_equal(bits, jbits) and np.array_equal(rows, jrows)
    want = np.asarray(jw._w_gf2_batch_jit(jnp.asarray(jbits), jnp.asarray(jrows), jnp.asarray(D)))
    got = tw.w_apply_gf2_batch(torch.from_numpy(bits), torch.from_numpy(rows[..., None]), torch.from_numpy(D))
    assert np.array_equal(got.numpy(), want)

    rng = np.random.default_rng(99)
    g256 = [WSchedule(64, n, W=rng.integers(0, 256, (n, 64), dtype=np.uint8)) for n in (5, 9, 3)]
    Dg = rng.integers(0, 256, (3, 64, 16), dtype=np.uint8)
    want = np.asarray(jw._w_gf256_batch_jit(jnp.asarray(jw.w_stack_gf256(g256)), jnp.asarray(Dg)))
    got = tw.w_apply_gf256_batch(torch.from_numpy(tw.w_stack_gf256(g256)), torch.from_numpy(Dg))
    assert np.array_equal(got.numpy(), want)
