"""The plain reference encoder: its repair symbols equal the port's, bit for
bit, at small K (the CPU path), and its intermediate symbols satisfy the
RFC's systematic property (source symbol i is LT row i of C)."""

import numpy as np
import pytest
import torch

from rqbench.reference import rfc6330


@pytest.mark.parametrize("K,Z,T", [(10, 3, 16), (37, 2, 24), (100, 2, 16), (300, 1, 8)])
def test_reference_matches_the_port(K, Z, T):
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.io.ioctx import MemoryIO

    data = np.random.default_rng(K).integers(0, 256, K * T * Z, dtype=np.uint8)
    enc = Encoder(len(data), T, Al=8, Z=Z, device="cpu")
    assert enc.num_blocks == Z and all(enc.block_symbols(b) == K for b in range(Z))
    n = K // 5 + 3
    want = np.stack([enc.encode_batch(b, np.arange(K, K + n), MemoryIO(data)) for b in range(Z)])
    got = rfc6330.repair_symbols(rfc6330.params(K), data.reshape(Z, K, T), n)
    assert np.array_equal(got, want)


def test_intermediate_symbols_are_systematic():
    P = rfc6330.params(37)
    A = torch.from_numpy(rfc6330.constraint_matrix(P))
    src = np.random.default_rng(1).integers(0, 256, (P.K, 5), dtype=np.uint8)
    D = np.zeros((P.L, 5), np.uint8)
    D[P.S + P.H : P.S + P.H + P.K] = src
    C = rfc6330._solve(A, torch.from_numpy(D)).numpy()
    for i, nb in enumerate(rfc6330.neighbors(P, np.arange(P.K))):
        assert np.array_equal(np.bitwise_xor.reduce(C[nb], axis=0), src[i])


def test_gf_matmul_against_log_tables():
    rng = np.random.default_rng(2)
    M = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    D = rng.integers(0, 256, (7, 9), dtype=np.uint8)
    want = np.zeros((5, 9), np.uint8)
    for i in range(5):
        for k in range(7):
            want[i] ^= rfc6330.gf_mul(M[i, k], D[k])
    assert np.array_equal(rfc6330.gf_matmul(torch.from_numpy(M), torch.from_numpy(D), cols=4).numpy(), want)


def test_bfloat16_sums_break_bit_exactness_at_k_1000_widths():
    """The control's rounding shows once a row's sums pass 256."""
    rng = np.random.default_rng(3)
    M = torch.from_numpy(rng.integers(0, 256, (4, 300), dtype=np.uint8))
    D = torch.from_numpy(rng.integers(0, 256, (300, 64), dtype=np.uint8))
    exact = rfc6330.gf_matmul(M, D)
    assert (rfc6330.gf_matmul(M, D, precision="bfloat16") != exact).any()


@pytest.mark.parametrize("K", [10, 37, 300])
def test_constraint_misses_zero_for_the_solution_and_any_change(K):
    P = rfc6330.params(K)
    src = torch.from_numpy(np.random.default_rng(K).integers(0, 256, (K, 24), dtype=np.uint8))
    D = torch.zeros((P.L, 24), dtype=torch.uint8)
    D[P.S + P.H : P.S + P.H + K] = src
    C = rfc6330._solve(torch.from_numpy(rfc6330.constraint_matrix(P)), D)
    assert rfc6330.constraint_misses(P, C, src) == 0
    for row in (0, P.S, P.S + P.H, P.B, P.W, P.L - 1):  # LDPC, HDPC, LT, PI and I_H columns
        bad = C.clone()
        bad[row, 5] ^= 1
        assert rfc6330.constraint_misses(P, bad, src) > 0


@pytest.mark.parametrize("K,Z,T", [(37, 3, 16), (300, 2, 8)])
def test_the_ports_intermediate_symbols_pass_and_give_the_repair_symbols(K, Z, T):
    """The check a receiver's packets get: the port's C [L, Z*T] (block b in
    columns b*T..) meets the constraints, and its LT symbols of the repair
    ISIs are the reference encoder's repair symbols."""
    from nanorq_tpu_torch.codec import batch
    from nanorq_tpu_torch.codec.api import Encoder
    from nanorq_tpu_torch.io.ioctx import MemoryIO

    P = rfc6330.params(K)
    data = np.random.default_rng(K + 1).integers(0, 256, K * T * Z, dtype=np.uint8)
    b = batch.load_object(Encoder(len(data), T, Al=8, Z=Z, device="cpu"), MemoryIO(data))
    C = batch.generate(b, "cpu")
    src = torch.from_numpy(np.ascontiguousarray(data.reshape(Z, K, T).transpose(1, 0, 2)).reshape(K, Z * T))
    assert rfc6330.constraint_misses(P, C, src) == 0
    n = K // 5
    got = rfc6330.xor_rows(C, rfc6330.neighbors(P, np.arange(P.Kp, P.Kp + n))).numpy().reshape(n, Z, T)
    assert np.array_equal(got.transpose(1, 0, 2), rfc6330.repair_symbols(P, data.reshape(Z, K, T), n))
