"""K1's output rows (`rows`) and implicit zero row (`zero_index`), against the
plain version, a numpy reference and the JAX package's scatter-free
placement (`nanorq_tpu.ops.replay._apply_plan` / `_select_rows`, xla path on
the CPU).  GF arithmetic is exact: every comparison is byte equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanorq_tpu.codec.cache import encoder_schedule
from nanorq_tpu.ops import replay as jreplay
from nanorq_tpu.rfc.params import params_init
from nanorq_tpu_torch.ops import gfmat, kernels
from nanorq_tpu_torch.ops.replay import apply_plan, device_arrays, place, placed


def _t(a):
    """A tensor of its own (the gathers XOR into out= in place)."""
    return torch.from_numpy(np.array(a))


def _jplan(plan):
    return ([jnp.asarray(p) for p in plan.passes],
            [(jnp.asarray(ix), jnp.asarray(sel)) for ix, sel in plan.overflow])


@pytest.mark.parametrize("K,t", [(100, 16), (100, 33), (1000, 16), (1000, 33)])
def test_bsel_plan_matches_jax(K, t):
    """The encoder schedule's GatherPlan: passes plus each overflow class
    composed with its placement, gathered from t1 with the sentinel Lpad as
    the implicit zero row, equals the JAX package's gather + zero row +
    width-1 placement over src_ext (t1 with a zero row appended)."""
    ds = encoder_schedule(params_init(K).Kp)
    assert ds.bsel.overflow  # at least one class to place
    rng = np.random.default_rng(K + t)
    src_ext = rng.integers(0, 256, (ds.Lpad + 1, t), dtype=np.uint8)
    src_ext[-1] = 0
    base = rng.integers(0, 256, (ds.u_pad, t), dtype=np.uint8)
    want = np.asarray(jreplay._apply_plan(False, jnp.asarray(src_ext), _jplan(ds.bsel), jnp.asarray(base)))
    arr = device_arrays(ds, "cpu")
    assert len(arr["bsel_placed"]) == len(ds.bsel.overflow)
    got = apply_plan(_t(src_ext[:-1]), arr["bsel_passes"], arr["bsel_placed"], _t(base), zero_index=ds.Lpad)
    assert np.array_equal(got.numpy(), want)
    # the sentinel row present in src (no zero_index) gives the same bytes
    got = apply_plan(_t(src_ext), arr["bsel_passes"], arr["bsel_placed"], _t(base))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [100, 1000])
def test_hdpc_placement_matches_jax(K):
    """HDPC products XORed into the zsel rows that take one (`hd_placed`)
    equal the JAX package's `_select_rows` over the padded product buffer."""
    ds = encoder_schedule(params_init(K).Kp)
    arr = device_arrays(ds, "cpu")
    hr = arr["mhd"].shape[0]
    rng = np.random.default_rng(K)
    red = np.zeros((ds.mhd.shape[0], 24), np.uint8)
    red[:hr] = rng.integers(0, 256, (hr, 24), dtype=np.uint8)  # rows past the extent are zero products
    base = rng.integers(0, 256, (ds.u_pad, 24), dtype=np.uint8)
    want = base ^ np.asarray(jreplay._select_rows(False, jnp.asarray(red), jnp.asarray(ds.hd_sel)))
    ix, rows = arr["hd_placed"]
    assert ix.shape == (rows.shape[0], 1) and 0 < rows.shape[0] < ds.u_pad
    got = kernels.gather_xor(_t(red[:hr]), ix, out=_t(base), rows=rows)
    assert np.array_equal(got.numpy(), want)


def _numpy_gather(src, idx, out, rows, zero_index):
    src_ext = np.vstack([src, np.zeros((1, src.shape[1]), np.uint8)]) if zero_index is not None else src
    res = np.bitwise_xor.reduce(src_ext[idx], axis=1) if idx.shape[1] else np.zeros((idx.shape[0], src.shape[1]), np.uint8)
    out = out.copy()
    out[rows] ^= res
    return out


@pytest.mark.parametrize("S,t,n,w,n_out", [(9, 16, 5, 1, 12), (40, 13, 17, 6, 17), (300, 1283, 100, 5, 150),
                                           (7, 32, 3, 0, 4)])
@pytest.mark.parametrize("zero", [False, True])
def test_rows_and_zero_index_vs_numpy(S, t, n, w, n_out, zero):
    rng = np.random.default_rng(S * t + n + zero)
    src = rng.integers(0, 256, (S, t), dtype=np.uint8)
    idx = rng.integers(0, S + zero, (n, w)).astype(np.int32)
    rows = rng.permutation(n_out)[:n].astype(np.int32)
    out = rng.integers(0, 256, (n_out, t), dtype=np.uint8)
    zi = S if zero else None
    want = _numpy_gather(src, idx, out, rows, zi)
    got = kernels.gather_xor(_t(src), _t(idx), out=_t(out), rows=_t(rows), zero_index=zi)
    assert np.array_equal(got.numpy(), want)
    plain = gfmat.xor_reduce_gather(_t(src), _t(idx), out=_t(out), rows=_t(rows), zero_index=zi)
    assert np.array_equal(plain.numpy(), want)
    if zero:  # zero_index alone: S reads as a zero row
        fresh = kernels.gather_xor(_t(src), _t(idx), zero_index=S)
        assert np.array_equal(fresh.numpy(), _numpy_gather(src, idx, np.zeros((n, t), np.uint8), np.arange(n), S))


def test_placed_composes_a_class_with_its_placement():
    ix = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    sel = np.array([3, 0, 3, 2, 3], np.int32)  # 3 = nb: the sentinel
    i, r = placed(ix, sel, "cpu")
    assert r.tolist() == [1, 3] and i.tolist() == [[1, 2], [5, 6]]
    i, r = placed(ix[:2], np.array([4, 2, 3, 5], np.int32), "cpu", lo=2)  # rows [2, 4) of a concat
    assert r.tolist() == [1, 2] and i.tolist() == [[1, 2], [3, 4]]


def _refusal(case):
    src = torch.zeros((10, 16), dtype=torch.uint8)
    idx = torch.tensor([[0, 9], [3, 1]], dtype=torch.int32)
    out = torch.zeros((5, 16), dtype=torch.uint8)
    r32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    return {
        "place_repeats": lambda: place(np.zeros((3, 1), np.int32), np.array([0, 1, 1]), 5, "cpu"),
        "place_past_end": lambda: place(np.zeros((2, 1), np.int32), np.array([0, 5]), 5, "cpu"),
        "place_negative": lambda: place(np.zeros((1, 1), np.int32), np.array([-1]), 5, "cpu"),
        "rows_repeat": lambda: kernels.gather_xor(src, idx, out=out, rows=r32(2, 2)),
        "rows_past_end": lambda: kernels.gather_xor(src, idx, out=out, rows=r32(1, 5)),
        "rows_without_out": lambda: kernels.gather_xor(src, idx, rows=r32(0, 1)),
        "rows_int64": lambda: kernels.gather_xor(src, idx, out=out, rows=torch.tensor([0, 1])),
        "rows_short": lambda: kernels.gather_xor(src, idx, out=out, rows=r32(0)),
        "zero_index_not_S": lambda: kernels.gather_xor(src, idx, zero_index=9),
        "index_S_without_zero_index": lambda: kernels.gather_xor(src, r32(10).view(1, 1)),
        "index_past_zero_row": lambda: kernels.gather_xor(src, r32(11).view(1, 1), zero_index=10),
    }[case]


@pytest.mark.parametrize("case,exc", [
    ("place_repeats", ValueError), ("place_past_end", ValueError), ("place_negative", ValueError),
    ("rows_repeat", ValueError), ("rows_past_end", ValueError), ("rows_without_out", ValueError),
    ("rows_int64", ValueError), ("rows_short", ValueError), ("zero_index_not_S", ValueError),
    ("index_S_without_zero_index", IndexError), ("index_past_zero_row", IndexError)])
def test_refusals(case, exc):
    with pytest.raises(exc):
        _refusal(case)()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1280, 1283, 3 * 1280])
def test_rows_and_zero_index_on_card(t):
    """K1's new modes on the card == the plain version, bit for bit: output
    rows into a larger buffer, the implicit zero row, widths 1 to 48; a row
    outside out and an index past the zero row raise in the checked mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(t)

    def u8(*s):
        return torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)

    src = u8(500, t)
    before = kernels.LAUNCHES["gather_xor"]
    for n, w in [(300, 1), (64, 7), (20, 48)]:
        idx = torch.from_numpy(rng.integers(0, 501, (n, w)).astype(np.int32)).to(dev)
        rows = torch.from_numpy(rng.permutation(400)[:n].astype(np.int32)).to(dev)
        base = u8(400, t)
        got = kernels.gather_xor(src, idx, out=base.clone(), rows=rows, zero_index=500, check=True)
        want = gfmat.xor_reduce_gather(src, idx, out=base.clone(), rows=rows, zero_index=500)
        assert torch.equal(got, want)
        fresh = kernels.gather_xor(src, idx, zero_index=500, check=True)
        assert torch.equal(fresh, gfmat.xor_reduce_gather(src, idx, zero_index=500))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gather_xor"] == before + 6
    idx = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(IndexError):  # a row outside out: flagged by the kernel
        kernels.gather_xor(src, idx, out=u8(4, t), rows=torch.tensor([0, 4], dtype=torch.int32, device=dev),
                           check=True)
    with pytest.raises(IndexError):  # past the zero row
        kernels.gather_xor(src, idx + 501, zero_index=500, check=True)
    assert not kernels.take_index_errors(dev)
