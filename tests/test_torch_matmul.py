"""The layouts of K2 (GF(2) matmul) and K3 (GF(256) matmul) on their shared
four-Russians core: K3's bits of M against alpha-scaled rows of X, K2's
block axis, the batched W decode's stacked gather, the rule that picks K3's
form and the bounds the forms tool reports -- on the CPU against the plain
versions and the JAX package; on the card (marker `cuda`) both kernels
bit-exact at the edge shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.gf256.bitplane import gf256_matmul_bytes
from nanorq_tpu.ops import wpath as jw
from nanorq_tpu_torch.gf256.tables import GF_MUL, OCT_EXP
from nanorq_tpu_torch.ops import gfmat, kernels, wpath
from nanorq_tpu_torch.tools import matmul_forms


def _u8(rng, *shape):
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


def _alpha_rows(X: torch.Tensor) -> torch.Tensor:
    """X [k, t] -> [8k, t], row 8c+q = alpha^q (x) X[c]: the rows K3's core
    tabulates."""
    k, t = X.shape
    alpha = torch.from_numpy(OCT_EXP[:8].astype(np.int64))
    return torch.from_numpy(GF_MUL.copy())[alpha[None, :, None], X.to(torch.int64)[:, None, :]].reshape(8 * k, t)


@pytest.mark.parametrize("nb,m,k,t", [(0, 5, 7, 9), (0, 32, 1280, 16), (0, 1, 1, 1), (3, 10, 110, 24)])
def test_companion_times_bit_planes_is_gf256_matmul(nb, m, k, t):
    """The companion expansion of M through the plain GF(2) product with X's
    bit planes (the TPU kernel's formulation), and M's own bits through the
    plain GF(2) product with the alpha-scaled rows of X (K3's layout on the
    four-Russians core), both equal the JAX package's GF(256) product and
    K3's wrapper (nb = 0: a 2-D call)."""
    rng = np.random.default_rng(m * 1000 + k)
    Ms, Xs = _u8(rng, max(nb, 1), m, k), _u8(rng, max(nb, 1), k, t)
    for M, X in zip(Ms, Xs):
        want = torch.from_numpy(gf256_matmul_bytes(M.numpy(), X.numpy()))
        assert torch.equal(gfmat.gf256_matmul_bits(gfmat.companion_bits(M), X), want)
        assert torch.equal(gfmat.gf2_matmul(gfmat.unpack_bits(M), _alpha_rows(X)), want)
    want = torch.stack([torch.from_numpy(gf256_matmul_bytes(M.numpy(), X.numpy())) for M, X in zip(Ms, Xs)])
    got = kernels.gf256_matmul(Ms, Xs) if nb else kernels.gf256_matmul(Ms[0], Xs[0])
    assert torch.equal(got, want if nb else want[0])


def test_gf2_matmul_block_axis_equals_per_block():
    rng = np.random.default_rng(3)
    bits, X = _u8(rng, 4, 9, 5), _u8(rng, 4, 37, 11)
    got = kernels.gf2_matmul(bits, X)
    assert torch.equal(got, torch.stack([kernels.gf2_matmul(bits[j], X[j]) for j in range(4)]))
    out = got.clone()
    kernels.gf2_matmul(bits, X, out=out)
    assert not out.any()
    with pytest.raises(ValueError):
        kernels.gf2_matmul(bits, X[:3])


@pytest.mark.parametrize("nb", [1, 7])
def test_stacked_w_gf2_equals_per_block_and_jax(nb):
    """w_apply_gf2_batch's one gather from D viewed as [nb * M_pad, t], rows
    offset by j * M_pad, equals the per-block loop and _w_gf2_batch_jit."""
    rng = np.random.default_rng(nb)
    m, kq, M_pad, t = 24, 128, 256, 40
    bits = _u8(rng, nb, m, kq // 8)
    rows = torch.from_numpy(rng.integers(0, M_pad, (nb, kq, 1)).astype(np.int32))
    D = _u8(rng, nb, M_pad, t)
    flat = wpath.stacked_rows(rows, M_pad)
    assert flat.shape == (nb * kq, 1) and flat.dtype == torch.int32
    assert torch.equal(flat.view(nb, kq), rows[..., 0] + torch.arange(nb, dtype=torch.int32)[:, None] * M_pad)
    got = wpath.w_apply_gf2_batch(bits, rows, D)
    loop = torch.stack([wpath.w_apply_gf2(bits[j], rows[j], D[j]) for j in range(nb)])
    want = np.asarray(jw._w_gf2_batch_jit(jnp.asarray(bits.numpy()), jnp.asarray(rows[..., 0].numpy()),
                                          jnp.asarray(D.numpy())))
    assert torch.equal(got, loop) and np.array_equal(got.numpy(), want)


def test_form_rules_at_the_main_path_shapes():
    """K2 has one form; K3 runs four-Russians tables but for wide products of
    few rows (log/exp), and the forms tool names the form the rule runs."""
    assert kernels.gf256_form(10, 256000) == kernels.GF256_LOGEXP  # HDPC over 200 blocks
    assert kernels.gf256_form(128, 256000) == kernels.GF256_M4R  # Vinv
    assert kernels.gf256_form(10, 1280) == kernels.GF256_M4R
    assert kernels.gf256_form(110, 1280) == kernels.GF256_M4R  # residual chunk
    assert matmul_forms.form("gf256", 10, 256000) == "logexp"
    assert matmul_forms.form("gf256", 110, 1280) == matmul_forms.form("gf2", 10, 256000) == "m4r"


@pytest.mark.parametrize("kind,nb,m,k,t,by", [
    ("gf2", 1, 256, 256, 256000, "bytes"),  # a chunk inverse over 200 blocks
    ("gf2", 1, 999, 72, 256000, "bytes"),  # Wut, cut
    ("gf256", 1, 10, 1008, 256000, "bytes"),  # HDPC, cut
    ("gf256", 1, 128, 128, 256000, "operations"),  # Vinv
    ("gf2", 200, 64, 1024, 1280, "bytes"),  # the batched W decode
    ("gf256", 32, 110, 1024, 1280, "operations"),  # the residual chunk
])
def test_forms_tool_bounds(kind, nb, m, k, t, by):
    """The bound is the larger of the bytes and the fewer of the two
    methods' operations; the four-Russians XORs are the fewer at every
    main-path shape."""
    b = matmul_forms.bounds(kind, nb, m, k, t)
    a_bytes = m * (k // 8 if kind == "gf2" else k)
    assert b["bytes_ms"] == pytest.approx(nb * (a_bytes + k * t + m * t) / 3.35e12 * 1e3)
    assert b["m4r_ms"] < b["tc_ms"]
    assert b["bound_by"] == by
    assert b["bound_ms"] == max(b["bytes_ms"], b["m4r_ms"])
    assert b["form_floor_ms"] > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_empty_contraction_is_zero(dim):
    """k = 0: both kernels give zeros, or leave out= as it is."""
    lead = (2,) if dim == 3 else ()
    X = torch.zeros(*lead, 0, 9, dtype=torch.uint8)
    for mm, A in ((kernels.gf2_matmul, torch.zeros(*lead, 5, 0, dtype=torch.uint8)),
                  (kernels.gf256_matmul, torch.zeros(*lead, 5, 0, dtype=torch.uint8))):
        assert torch.equal(mm(A, X), torch.zeros(*lead, 5, 9, dtype=torch.uint8))
        out = torch.full((*lead, 5, 9), 7, dtype=torch.uint8)
        assert mm(A, X, out=out) is out and bool((out == 7).all())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(matmul_forms.EDGES))
def test_edge_shapes_on_card(name):
    """k not a multiple of the tile, m < 16, t % 16 != 0, k split across
    blocks by the launch rule, nb = 1 and nb = 200, K3's log/exp form split
    and ragged: each kernel equals the plain version, alone and XORed into
    out=."""
    matmul_forms.measure(name, matmul_forms.EDGES[name], _card(), 1, timed=False)


@pytest.mark.cuda
def test_empty_contraction_launches_nothing_on_card():
    """k = 0 on the card: zeros, and no launch counted."""
    dev = _card()
    before = dict(kernels.LAUNCHES)
    X = torch.zeros(0, 32, dtype=torch.uint8, device=dev)
    assert not kernels.gf2_matmul(torch.zeros(4, 0, dtype=torch.uint8, device=dev), X).any()
    assert not kernels.gf256_matmul(torch.zeros(4, 0, dtype=torch.uint8, device=dev), X).any()
    assert kernels.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 200])
def test_batched_w_decode_on_card(nb):
    """The batched W decode at K = 1000's shape: one K1 and one K2 launch
    for nb blocks, equal to the plain per-block product."""
    dev = _card()
    rng = np.random.default_rng(nb)
    m, kq, M_pad, t = 64, 1024, 2048, 1280
    bits = _u8(rng, nb, m, kq // 8).to(dev)
    rows = torch.from_numpy(rng.integers(0, M_pad, (nb, kq, 1)).astype(np.int32)).to(dev)
    D = _u8(rng, nb, M_pad, t).to(dev)
    before = dict(kernels.LAUNCHES)
    got = wpath.w_apply_gf2_batch(bits, rows, D)
    assert kernels.LAUNCHES["gather_xor"] == before["gather_xor"] + 1
    assert kernels.LAUNCHES["gf2_matmul"] == before["gf2_matmul"] + 1
    G = gfmat.xor_reduce_gather(D.view(nb * M_pad, t), wpath.stacked_rows(rows, M_pad)).view(nb, kq, t)
    want = torch.stack([gfmat.gf2_matmul(gfmat.unpack_bits(bits[j]), G[j]) for j in range(nb)])
    assert torch.equal(got, want)
