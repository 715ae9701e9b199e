"""Port's plain GF primitives and kernel wrappers vs nanorq_tpu (JAX on CPU).

Inputs come from numpy with a seed and go through both packages; GF
arithmetic is exact, so every comparison is byte equality (tolerance 0).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.gf256.bitplane import companion_bits, gf2_matmul_bytes, gf256_matmul_bytes
from nanorq_tpu.ops import gfmat as jgfmat
from nanorq_tpu_torch.ops import gfmat, kernels

SHAPES = [(1, 1, 1), (7, 13, 5), (16, 64, 32), (33, 203, 1283), (64, 256, 1280)]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n,kb", [(1, 1), (5, 3), (40, 16)])
def test_unpack_bits_little_endian(n, kb):
    p = _rng(n, kb).integers(0, 256, (n, kb), dtype=np.uint8)
    got = gfmat.unpack_bits(_t(p)).numpy()
    assert np.array_equal(got, np.unpackbits(p, axis=-1, bitorder="little"))


@pytest.mark.parametrize("m,k,t", SHAPES)
def test_gf2_matmul_vs_jax(m, k, t):
    rng = _rng("gf2", m, k, t)
    bits = rng.integers(0, 2, (m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    want = np.asarray(jgfmat.gf2_matmul(jnp.asarray(bits), jnp.asarray(X)))
    assert np.array_equal(want, gf2_matmul_bytes(bits, X))
    assert np.array_equal(gfmat.gf2_matmul(_t(bits), _t(X)).numpy(), want)
    packed = np.packbits(bits, axis=1, bitorder="little")  # the schedules' layout
    assert np.array_equal(kernels.gf2_matmul(_t(packed), _t(X)).numpy(), want)


@pytest.mark.parametrize("m,k,t", SHAPES)
def test_gf256_matmul_vs_jax(m, k, t):
    rng = _rng("gf256", m, k, t)
    M = rng.integers(0, 256, (m, k), dtype=np.uint8)
    X = rng.integers(0, 256, (k, t), dtype=np.uint8)
    want = np.asarray(jgfmat.gf256_matmul_bits(jnp.asarray(companion_bits(M)), jnp.asarray(X)))
    assert np.array_equal(want, gf256_matmul_bytes(M, X))
    assert np.array_equal(gfmat.companion_bits(_t(M)).numpy(), companion_bits(M))
    assert np.array_equal(gfmat.gf256_matmul(_t(M), _t(X)).numpy(), want)
    assert np.array_equal(kernels.gf256_matmul(_t(M), _t(X)).numpy(), want)


@pytest.mark.parametrize("S,t,n,w", [(1, 1, 1, 1), (20, 13, 9, 3), (300, 1283, 100, 5), (64, 32, 17, 0)])
def test_gather_xor_vs_jax(S, t, n, w):
    rng = _rng("gx", S, t, n, w)
    src = rng.integers(0, 256, (S, t), dtype=np.uint8)
    src[-1] = 0  # the sentinel row
    idx = rng.integers(0, S, (n, w)).astype(np.int32)
    got = kernels.gather_xor(_t(src), _t(idx)).numpy()
    if w:
        want = np.asarray(jgfmat.xor_reduce_gather(jnp.asarray(src), jnp.asarray(idx)))
        assert np.array_equal(gfmat.xor_reduce_gather(_t(src), _t(idx)).numpy(), want)
    else:
        want = np.zeros((n, t), np.uint8)
    assert np.array_equal(got, want)


def test_out_accumulates_in_place():
    """out= XORs the result into the given rows (the replay's in-place use)."""
    rng = _rng("acc")
    src = _t(rng.integers(0, 256, (10, 16), dtype=np.uint8))
    idx = _t(rng.integers(0, 10, (4, 3)).astype(np.int32))
    base = _t(rng.integers(0, 256, (4, 16), dtype=np.uint8))
    want = base ^ kernels.gather_xor(src, idx)
    res = kernels.gather_xor(src, idx, out=base)
    assert res is base and torch.equal(base, want)
    M, X = _t(rng.integers(0, 256, (3, 10), dtype=np.uint8)), src
    out = M.new_ones(3, 16)
    kernels.gf256_matmul(M, X, out=out)
    assert torch.equal(out, 1 ^ kernels.gf256_matmul(M, X))
    bits = _t(rng.integers(0, 256, (3, 2), dtype=np.uint8))
    out = M.new_ones(3, 16)
    kernels.gf2_matmul(bits, X, out=out)
    assert torch.equal(out, 1 ^ kernels.gf2_matmul(bits, X))


@pytest.mark.parametrize("case", ["dtype", "noncontig", "short_bits", "k_mismatch", "out_shape", "idx_dtype",
                                  "out_aliases_input"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    X = torch.zeros((16, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        if case == "dtype":
            kernels.gf256_matmul(torch.zeros((4, 16), dtype=torch.int32), X)
        elif case == "noncontig":
            kernels.gather_xor(X.t(), torch.zeros((2, 1), dtype=torch.int32))
        elif case == "short_bits":
            kernels.gf2_matmul(torch.zeros((4, 1), dtype=torch.uint8), X)
        elif case == "k_mismatch":
            kernels.gf256_matmul(torch.zeros((4, 15), dtype=torch.uint8), X)
        elif case == "out_aliases_input":
            kernels.gf2_matmul(torch.zeros((4, 2), dtype=torch.uint8), X[:4], out=X[2:6])
        elif case == "out_shape":
            kernels.gf2_matmul(torch.zeros((4, 2), dtype=torch.uint8), X,
                               out=torch.zeros((5, 32), dtype=torch.uint8))
        else:
            kernels.gather_xor(X, torch.zeros((2, 1), dtype=torch.int64))


@pytest.mark.parametrize("bad", [10, 11, -1])
def test_gather_xor_rejects_out_of_range_index(bad):
    """An index outside [0, S) raises; none is wrapped or read as zero."""
    src = torch.zeros((10, 16), dtype=torch.uint8)
    idx = torch.tensor([[0, 9], [bad, 1]], dtype=torch.int32)
    with pytest.raises(IndexError):
        kernels.gather_xor(src, idx)
    with pytest.raises(IndexError):
        kernels.gather_xor(src, idx, check=True)


def test_cpu_calls_do_not_count_launches():
    kernels.reset_launches()
    src, idx = torch.zeros((2, 16), dtype=torch.uint8), torch.zeros((1, 1), dtype=torch.int32)
    kernels.gather_xor(src, idx)
    kernels.gather_v1(src, idx)
    kernels.gather_v2(src, idx, kernels.probe_counts(idx, 1), 1)
    kernels.gather_db(src, idx)
    kernels.gf256_matmul(src[None, :, :2].contiguous(), src[None])
    assert set(kernels.LAUNCHES) == {"gather_xor", "gf2_matmul", "gf256_matmul",
                                     "gather_v1", "gather_v2", "gather_db"}
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1280, 1283, 3 * 1280])
def test_kernels_match_plain_on_card(t):
    """Each CUDA kernel == its plain version on the card, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    dev = torch.device("cuda", 0)
    rng = _rng("card", t)

    def u8(*s):
        return torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)

    src = u8(500, t)
    idx = torch.from_numpy(rng.integers(0, 500, (300, 7)).astype(np.int32)).to(dev)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.gather_xor(src, idx), gfmat.xor_reduce_gather(src, idx))
    for m, k in [(256, 256), (50, 203), (1280, 128)]:
        bits, X = u8(m, (k + 7) // 8), u8(k, t)
        assert torch.equal(kernels.gf2_matmul(bits, X), gfmat.gf2_matmul(gfmat.unpack_bits(bits)[:, :k], X))
        M = u8(m // 4 + 1, k)
        assert torch.equal(kernels.gf256_matmul(M, X), gfmat.gf256_matmul(M, X))
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[n] > before[n] for n in ("gather_xor", "gf2_matmul", "gf256_matmul"))
    assert not kernels.take_index_errors(dev)
    for bad in (500, -1):  # the kernel flags an index outside the source
        bad_idx = idx.clone()
        bad_idx[5, 3] = bad
        with pytest.raises(IndexError):
            kernels.gather_xor(src, bad_idx, check=True)
        kernels.gather_xor(src, bad_idx)  # unchecked: the flag waits for take_index_errors
        assert kernels.take_index_errors(dev) and not kernels.take_index_errors(dev)
