"""The gather probe kernels' wrappers (P1 gather_v1, P2 gather_v2, P3 gather_db)
and the probe driver, against the probes' own numpy reference
(np.bitwise_xor.reduce over the gathered rows) and nanorq_tpu's
xor_reduce_gather (JAX on CPU).  Byte equality everywhere (tolerance 0).
Card-only cases are marked `cuda`."""

import ast
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.ops import gfmat as jgfmat
from nanorq_tpu_torch.ops import gfmat, kernels
from nanorq_tpu_torch.tools import gather_probe

REPO = pathlib.Path(__file__).resolve().parents[1]


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _case(S, n, w, t, frac, *key, dirty_sentinel=False):
    """The probes' data recipe at a small size; optionally a sentinel row that
    is not zero (gather_v2 must still read its slots as zero)."""
    src, idx = gather_probe.probe_data(_rng(S, n, w, t, *key), S, n, w, t, frac)
    if dirty_sentinel:
        src[S - 1] = _rng("dirty", S, t).integers(1, 256, t, dtype=np.uint8)
    return src, idx


def _numpy_ref(src, idx, sentinel=None):
    rows = src[idx]
    if sentinel is not None:
        rows = np.where((idx == sentinel)[..., None], 0, rows).astype(np.uint8)
    return np.bitwise_xor.reduce(rows, axis=1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


SHAPES = [  # (S, n, w, t, frac): tails of R = 8/16/32 rows, w = 1, wide w
    (301, 37, 5, 64, 0.3),
    (1025, 100, 8, 160, 0.35),
    (50, 8, 1, 16, 0.0),
    (400, 45, 16, 48, 0.45),
]


@pytest.mark.parametrize("S,n,w,t,frac", SHAPES)
@pytest.mark.parametrize("R", [8, 16, 32])
def test_plain_probes_equal_numpy_and_jax(S, n, w, t, frac, R):
    src, idx = _case(S, n, w, t, frac, R, dirty_sentinel=True)
    want = _numpy_ref(src, idx)
    assert np.array_equal(np.asarray(jgfmat.xor_reduce_gather(jnp.asarray(src), jnp.asarray(idx))), want)
    ts, ti = _t(src), _t(idx)
    for mode in (0, 1, 2):
        assert np.array_equal(kernels.gather_v1(ts, ti, mode, R=R).numpy(), want)
    assert np.array_equal(kernels.gather_db(ts, ti, R=R).numpy(), want)
    cnt = kernels.probe_counts(ti, S - 1, R)
    skip = kernels.gather_v2(ts, ti, cnt, S - 1, R=R).numpy()
    assert np.array_equal(skip, _numpy_ref(src, idx, S - 1))
    if (idx == S - 1).any():  # the dirty sentinel row reads as zero only in v2
        assert not np.array_equal(skip, want)


@pytest.mark.parametrize("n,R", [(37, 8), (32, 16), (1, 32), (0, 8)])
def test_probe_counts_match_the_probe(n, R):
    """cnt[b] = non-sentinel slots of rows [bR, bR+R), the last block a tail
    (gather_v2_probe.py:167 counts the same over n % R == 0)."""
    idx = _rng("cnt", n, R).integers(0, 10, (n, 4)).astype(np.int32)
    got = kernels.probe_counts(_t(idx), 9, R).numpy()
    pad = np.full((-n % R, 4), 9, np.int32)
    want = np.count_nonzero(np.vstack([idx, pad]).reshape(-1, R * 4) != 9, axis=1)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_v2_refuses_a_wrong_count_on_cpu():
    src, idx = _case(301, 37, 5, 64, 0.3, "cnt")
    ts, ti = _t(src), _t(idx)
    cnt = kernels.probe_counts(ti, 300)
    cnt[2] += 1
    with pytest.raises(ValueError, match="cnt"):
        kernels.gather_v2(ts, ti, cnt, 300)


def _misaligned(S, t):
    return torch.zeros(S * t + 1, dtype=torch.uint8)[1:].view(S, t)


@pytest.mark.parametrize("case", ["ragged_t", "mode", "R0", "R33", "slots", "w0", "idx_dtype", "cnt_shape",
                                  "cnt_dtype", "sentinel", "misaligned"])
def test_probe_wrappers_refuse_what_the_kernels_do_not_take(case):
    src, idx = torch.zeros((20, 32), dtype=torch.uint8), torch.zeros((9, 4), dtype=torch.int32)
    cnt = kernels.probe_counts(idx, 19)
    with pytest.raises(ValueError):
        if case == "ragged_t":
            kernels.gather_db(torch.zeros((20, 1283), dtype=torch.uint8), idx)
        elif case == "mode":
            kernels.gather_v1(src, idx, 3)
        elif case == "R0":
            kernels.gather_v1(src, idx, R=0)
        elif case == "R33":
            kernels.gather_db(src, idx, R=33)
        elif case == "slots":
            kernels.gather_v1(src, torch.zeros((9, 129), dtype=torch.int32), R=8)
        elif case == "w0":
            kernels.gather_db(src, torch.zeros((9, 0), dtype=torch.int32))
        elif case == "idx_dtype":
            kernels.gather_v1(src, idx.to(torch.int64))
        elif case == "cnt_shape":
            kernels.gather_v2(src, idx, cnt[:1], 19)
        elif case == "cnt_dtype":
            kernels.gather_v2(src, idx, cnt.to(torch.int64), 19)
        elif case == "sentinel":
            kernels.gather_v2(src, idx, cnt, 20)
        else:
            kernels.gather_v1(_misaligned(20, 32), idx)


@pytest.mark.parametrize("name", ["gather_v1", "gather_v2", "gather_db"])
def test_probes_reject_out_of_range_index(name):
    src = torch.zeros((10, 16), dtype=torch.uint8)
    idx = torch.tensor([[0, 9], [10, 1]], dtype=torch.int32)
    with pytest.raises(IndexError):
        if name == "gather_v2":
            kernels.gather_v2(src, idx, kernels.probe_counts(idx, 9), 9)
        else:
            getattr(kernels, name)(src, idx)


def _shapes_of(path: pathlib.Path):
    """The SHAPES list literal of a probe script, read without running it."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "SHAPES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no SHAPES in {path}")


def test_driver_tables_are_the_probes():
    assert gather_probe.V2_SHAPES == _shapes_of(REPO / "tools" / "gather_v2_probe.py")
    db = _shapes_of(REPO / "tools" / "gather_db_probe.py")
    assert [(S, n, w, t, name) for S, n, w, t, _, name in gather_probe.DB_SHAPES] == db
    assert {f for *_, f, _ in gather_probe.DB_SHAPES} == {0.35}  # gather_db_probe.py:115


def test_driver_runs_a_shape_on_cpu():
    line = gather_probe.run_shape("v2", (301, 37, 5, 64, 0.3, "tiny"), np.random.default_rng(0),
                                  torch.device("cpu"))
    assert line["exact"] and line["ms"] == {} and line["gathered_mb"] == 37 * 5 * 64 / 1e6
    with pytest.raises(SystemExit):
        gather_probe.main(["--shapes", "no-such-shape", "--device", "cpu"])


def test_gf256_matmul_batched_equals_per_block():
    """3-D K3: nb products in one call == nb 2-D calls; out= accumulates."""
    rng = _rng("k3b")
    M = _t(rng.integers(0, 256, (4, 9, 33), dtype=np.uint8))
    X = _t(rng.integers(0, 256, (4, 33, 48), dtype=np.uint8))
    want = torch.stack([kernels.gf256_matmul(M[j], X[j]) for j in range(4)])
    assert torch.equal(kernels.gf256_matmul(M, X), want)
    out = torch.ones((4, 9, 48), dtype=torch.uint8)
    kernels.gf256_matmul(M, X, out=out)
    assert torch.equal(out, 1 ^ want)
    with pytest.raises(ValueError):
        kernels.gf256_matmul(M, X[:3])
    with pytest.raises(ValueError):
        kernels.gf256_matmul(M, X[0])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("S,n,w,t,frac", SHAPES + [(2049, 1280, 1, 1280, 0.0), (567, 566, 8, 256000, 0.2)])
def test_probe_kernels_match_plain_on_card(S, n, w, t, frac):
    dev = _card()
    src, idx = _case(S, n, w, t, frac, "card", dirty_sentinel=True)
    ts, ti = _t(src).to(dev), _t(idx).to(dev)
    want = gfmat.xor_reduce_gather(ts, ti)
    skip = gfmat.xor_reduce_gather_skip(ts, ti, S - 1)
    before = dict(kernels.LAUNCHES)
    for R in (8, 16, 32):
        if R * w > 1024:
            continue
        for mode in (0, 1, 2):
            assert torch.equal(kernels.gather_v1(ts, ti, mode, R=R, check=True), want), (R, mode)
        assert torch.equal(kernels.gather_db(ts, ti, R=R, check=True), want), R
        cnt = kernels.probe_counts(ti, S - 1, R)
        assert torch.equal(kernels.gather_v2(ts, ti, cnt, S - 1, R=R, check=True), skip), R
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > before[k] for k in ("gather_v1", "gather_v2", "gather_db"))
    assert not kernels.take_index_errors(dev) and not kernels.take_count_errors(dev)


@pytest.mark.cuda
def test_probe_flags_on_card():
    """A wrong cnt is flagged and cannot hang the card (the kernel waits on its
    own count, so the result is still exact); an index outside flags too."""
    dev = _card()
    src, idx = _case(301, 37, 5, 64, 0.3, "flags")
    ts, ti = _t(src).to(dev), _t(idx).to(dev)
    cnt = kernels.probe_counts(ti, 300)
    cnt[1] += 3
    got = kernels.gather_v2(ts, ti, cnt, 300)
    assert torch.equal(got, gfmat.xor_reduce_gather_skip(ts, ti, 300))
    assert kernels.take_count_errors(dev) and not kernels.take_count_errors(dev)
    with pytest.raises(ValueError):
        kernels.gather_v2(ts, ti, cnt, 300, check=True)
    bad = ti.clone()
    bad[3, 2] = 301
    for fn in (lambda: kernels.gather_v1(ts, bad, 0, check=True), lambda: kernels.gather_db(ts, bad, check=True),
               lambda: kernels.gather_v2(ts, bad, kernels.probe_counts(bad, 300), 300, check=True)):
        with pytest.raises(IndexError):
            fn()
    with pytest.raises(ValueError):
        kernels.gather_v1(torch.zeros((20, 1283), dtype=torch.uint8, device=dev), (ti[:, :1] % 20).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("nb,m,k,t", [(1, 64, 1024, 1280), (5, 110, 1024, 1280), (3, 20, 203, 1283), (32, 7, 110, 256)])
def test_batched_gf256_matmul_on_card(nb, m, k, t):
    dev = _card()
    rng = _rng("k3card", nb, m, k, t)
    M = _t(rng.integers(0, 256, (nb, m, k), dtype=np.uint8)).to(dev)
    X = _t(rng.integers(0, 256, (nb, k, t), dtype=np.uint8)).to(dev)
    before = kernels.LAUNCHES["gf256_matmul"]
    got = kernels.gf256_matmul(M, X)
    assert kernels.LAUNCHES["gf256_matmul"] == before + 1
    assert torch.equal(got, gfmat.gf256_matmul_batch(M, X))
    out = torch.ones_like(got)
    kernels.gf256_matmul(M, X, out=out)
    assert torch.equal(out, 1 ^ got)
