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
    # the bytes bound: the distinct rows read, the output written, the indices read, at 3.35 TB/s
    src, idx = gather_probe.probe_data(np.random.default_rng(0), 301, 37, 5, 64, 0.3)
    assert line["bound_ms"] == (np.unique(idx).size * 64 + 37 * 64 + 37 * 5 * 4) / 3.35e12 * 1e3
    assert line["share"] == {} and line["index_select_ms"] is None  # nothing is timed on the CPU
    with pytest.raises(SystemExit):
        gather_probe.main(["--shapes", "no-such-shape", "--device", "cpu"])
    with pytest.raises(SystemExit):
        gather_probe.main(["--tables", "no-such-table", "--device", "cpu"])
    with pytest.raises(SystemExit):  # a shape of a table that was not asked for
        gather_probe.main(["--shapes", "bsel-1280", "--device", "cpu"])
    lines = gather_probe.main(["--tables", "main", "--shapes", "bsel-1280", "--device", "cpu"])
    assert [(ln["table"], ln["n"], ln["w"], ln["t"], ln["exact"]) for ln in lines] == [("main", 128, 8, 1280, True)]


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


GEOMETRY_GRID = [(n, w, t, R)
                 for n in (1, 7, 37, 566, 1280)
                 for w in (1, 2, 5, 8, 16, 48, 129, 1024)
                 for t in (16, 1280, 5008, 40960, 256000)
                 for R in (1, 8, 16, 32) if R * w <= 1024 and n * t <= 1280 * 40960]


@pytest.mark.parametrize("w", [1, 2, 5, 8, 16, 48, 129, 1024])
def test_probe_geometry_covers_every_lane_once(w):
    """The ring's launch geometry: over all blocks, the steps cover every
    (row, 16-byte lane) of the output exactly once, a step fits its stage,
    shared memory stays within a block's 227 KB, and every copy is a nonzero
    multiple of 16 bytes."""
    for n, w_, t, R in GEOMETRY_GRID:
        if w_ != w:
            continue
        for mode in (0, 1, 2):
            g = kernels.probe_geometry(n, w, t, R, mode)
            assert g["smem_bytes"] <= kernels.PROBE_SMEM_MAX, (n, w, t, R, mode)
            assert 2 <= g["stages"] and 1 <= g["rows_per_step"] <= R
            assert g["slots_per_step"] * g["copy_bytes"] == g["stage_bytes"] <= 48 * 1024
            assert g["copy_bytes"] % 16 == 0 and 0 < g["copy_bytes"] <= t
            assert 1 <= g["blocks"] <= min(g["steps"], 2 * 132) and g["threads"] % 32 == 0
            assert g["deal"] in (1, g["steps_per_tile"])
            assert g["steps_per_tile"] * g["rows_per_step"] >= R > (g["steps_per_tile"] - 1) * g["rows_per_step"]
        seen = np.zeros((n, t // 16), np.uint8)
        for block in range(g["blocks"]):
            for i, (stage, row0, rows, col0, nbytes) in enumerate(kernels.probe_steps(n, w, t, R, g, block)):
                assert stage == i % g["stages"] and 1 <= rows <= g["rows_per_step"]
                assert nbytes > 0 and nbytes % 16 == 0 and col0 % 16 == 0 and nbytes <= g["copy_bytes"]
                seen[row0 : row0 + rows, col0 // 16 : (col0 + nbytes) // 16] += 1
        assert (seen == 1).all(), (n, w, t, R)


def test_probe_geometry_tile_order_follows_the_width():
    """Width 1: consecutive tiles walk one row block's column chunks; wider:
    one column chunk's row blocks (the object-wide take_rows and LT class)."""
    g1 = kernels.probe_geometry(1280, 1, 256000, 8)
    assert g1["order"] == "row_block" and g1["copy_bytes"] == 4096 and g1["rows_per_step"] == 8
    a, b = [next(kernels.probe_steps(1280, 1, 256000, 8, g1, blk)) for blk in (0, 1)]
    assert (a[1], a[3]) == (0, 0) and (b[1], b[3]) == (0, 4096)
    g8 = kernels.probe_geometry(566, 8, 256000, 8)
    assert g8["order"] == "column_chunk" and g8["copy_bytes"] == 2048 and g8["rows_per_step"] == 2
    assert (g8["steps_per_tile"], g8["deal"], g8["steps"], g8["blocks"]) == (4, 4, 71 * 125 * 4, 264)
    # enough tiles: a block takes whole tiles, a column chunk's row blocks in turn, then tile + blocks
    steps = list(kernels.probe_steps(566, 8, 256000, 8, g8, 0))[:5]
    assert [(s[1], s[3]) for s in steps] == [(0, 0), (2, 0), (4, 0), (6, 0), (264 % 71 * 8, 264 // 71 * 2048)]
    # the tail row block (rows 560..565) has three steps: its fourth is no one's
    tail = [s for blk in range(264) for s in kernels.probe_steps(566, 8, 256000, 8, g8, blk) if s[1] >= 560]
    assert sorted({s[1] for s in tail}) == [560, 562, 564] and len(tail) == 3 * 125
    # few tiles: single steps are dealt, so R sets the tails and not how far the launch spreads
    for R, blocks in ((8, 71 * 3), (32, 18 * 11)):
        small = kernels.probe_geometry(566, 8, 1280, R)
        assert (small["copy_bytes"], small["rows_per_step"], small["deal"], small["blocks"]) == (1280, 3, 1, blocks)
    small = kernels.probe_geometry(566, 8, 1280, 8)
    assert [next(kernels.probe_steps(566, 8, 1280, 8, small, blk))[1] for blk in (0, 1, 2, 3)] == [0, 3, 6, 8]


def _least_copy(w, t, stage):
    """The least copy db may issue: 4 KB at width 1, 2 KB wider, unless t
    itself is narrower or one row's w copies of that size do not fit a stage."""
    return min(4096 if w == 1 else 2048, t, stage // w // 16 * 16)


@pytest.mark.parametrize("w", [1, 2, 5, 8, 16, 48, 129, 1024])
def test_db_geometry_covers_every_lane_once(w):
    """gather_db's launch geometry: over all blocks, the steps cover every
    (row, 16-byte lane) of the output exactly once; a block's steps are a
    contiguous run of one t-tile's row blocks, in order, through stages 0, 1,
    0, ...; a step fits its stage and never crosses a row block; two blocks
    fit an SM's shared memory; no copy is narrower than the least copy."""
    for n, w_, t, R in GEOMETRY_GRID:
        if w_ != w:
            continue
        others = ({"stage_bytes": 32 * 1024, "sweep_steps": 3}, {"sweep_steps": 64}) if n * t <= 566 * 5008 else ()
        for knobs in ({}, *others):
            g = kernels.db_geometry(n, w, t, R, **knobs)
            stage = knobs.get("stage_bytes", kernels.DB_STAGE_BYTES)
            assert g["smem_bytes"] <= kernels.DB_SMEM_MAX and g["stages"] == 2, (n, w, t, R)
            assert g["slots_per_step"] * g["copy_bytes"] == g["stage_bytes"] <= stage
            assert g["copy_bytes"] % 16 == 0 and _least_copy(w, t, stage) <= g["copy_bytes"] <= t
            assert 1 <= g["rows_per_step"] <= R and g["threads"] == 288
            assert g["steps_per_row_block"] * g["rows_per_step"] >= R > (g["steps_per_row_block"] - 1) * g["rows_per_step"]
            assert g["blocks"] == g["tiles"] * g["sweeps"] and 1 <= g["row_blocks_per_sweep"]
            assert (g["sweeps"] - 1) * g["row_blocks_per_sweep"] < g["row_blocks"]  # no empty sweep
            seen = np.zeros((n, t // 16), np.uint8)
            for block in range(g["blocks"]):
                steps = list(kernels.db_steps(n, w, t, R, g, block))
                assert steps, block
                assert len({(s[3], s[4]) for s in steps}) == 1  # one t-tile
                rows = [r for s in steps for r in range(s[1], s[1] + s[2])]
                assert rows == list(range(rows[0], rows[0] + len(rows))) and rows[0] % R == 0
                assert len(rows) == min(n - rows[0], g["row_blocks_per_sweep"] * R)
                for i, (stg, row0, nrow, col0, nbytes) in enumerate(steps):
                    assert stg == i % 2 and 1 <= nrow <= g["rows_per_step"]
                    assert row0 // R == (row0 + nrow - 1) // R  # within one row block
                    assert nbytes % 16 == 0 and col0 % 16 == 0 and 0 < nbytes <= g["copy_bytes"]
                    seen[row0 : row0 + nrow, col0 // 16 : (col0 + nbytes) // 16] += 1
            assert (seen == 1).all(), (n, w, t, R, knobs)


def test_db_geometry_at_the_shapes_it_is_judged_on():
    """The LT class and take_rows over an object, a probe-table shape and a
    small launch, number by number."""
    lt = kernels.db_geometry(566, 8, 256000, 8)
    assert (lt["copy_bytes"], lt["rows_per_step"], lt["steps_per_row_block"]) == (2048, 3, 3)
    assert (lt["tiles"], lt["row_blocks_per_sweep"], lt["sweeps"], lt["blocks"]) == (125, 3, 24, 3000)
    assert lt["smem_bytes"] == 2 * 49152 + 32 + 2 * 4 * 24
    # block 25: tile 1, sweep 1 -- row blocks 3..5 in steps of 3, 3, 2 rows
    assert [s[1:] for s in kernels.db_steps(566, 8, 256000, 8, lt, 25)][:4] == [
        (24, 3, 2048, 2048), (27, 3, 2048, 2048), (30, 2, 2048, 2048), (32, 3, 2048, 2048)]
    # the last sweep of a tile ends at the tail row block (rows 560..565)
    assert [s[1:3] for s in kernels.db_steps(566, 8, 256000, 8, lt, 23)][-2:] == [(560, 3), (563, 3)]
    tr = kernels.db_geometry(1280, 1, 256000, 8)
    assert (tr["copy_bytes"], tr["rows_per_step"], tr["tiles"], tr["row_blocks_per_sweep"]) == (6144, 8, 42, 8)
    assert list(kernels.db_steps(1280, 1, 256000, 8, tr, 41 * 20))[0][3:] == (41 * 6144, 256000 - 41 * 6144)
    # R = 16 and 32 keep the copies and cut the row block into more steps
    assert [kernels.db_geometry(566, 8, 256000, R)["steps_per_row_block"] for R in (16, 32)] == [6, 11]
    # a small launch: a sweep is one row block, so it spreads over 16 blocks
    small = kernels.db_geometry(128, 8, 1280, 8)
    assert (small["copy_bytes"], small["rows_per_step"], small["row_blocks_per_sweep"], small["blocks"]) == (1280, 4, 1, 16)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m cuda)")
    return torch.device("cuda", 0)


def _edge_case(name):
    """(src, idx) of the cases the ring makes edges of; the sentinel is S - 1."""
    if name == "all_sentinel_block":  # rows 8..15 hold the sentinel alone: v2 copies nothing for them
        src, idx = _case(301, 37, 5, 64, 0.3, name, dirty_sentinel=True)
        idx[8:16] = 300
    elif name == "all_sentinel":  # no copy in the whole launch
        src, idx = _case(301, 37, 5, 64, 0.0, name, dirty_sentinel=True)
        idx[:] = 300
    elif name == "w1_sentinels":  # the zero strip of the width-1 body
        src, idx = _case(300, 45, 1, 9008, 0.4, name, dirty_sentinel=True)
    else:
        raise AssertionError(name)
    return src, idx


CARD_SHAPES = SHAPES + [
    (2049, 1280, 1, 1280, 0.0),  # take_rows at one block's width
    (567, 566, 8, 256000, 0.2),  # the LT class at an object's width
    (50, 8, 4, 64, 0.3),  # one tile: fewer than the ring's stages
    (300, 45, 8, 5008, 0.3),  # n % R != 0 and t % copy != 0 together
    (300, 45, 1, 9008, 0.0),  # the same at width 1
    (400, 70, 32, 256, 0.4),  # R * w = 1024 at R = 32
    (2000, 5, 1024, 64, 0.5),  # 1024 slots in one step (R = 1)
    (3000, 1100, 2, 40960, 0.1),  # more tiles than a block's ring holds, narrow
    "all_sentinel_block", "all_sentinel", "w1_sentinels",
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_probe_kernels_match_plain_on_card(shape):
    dev = _card()
    if isinstance(shape, str):
        src, idx = _edge_case(shape)
    else:
        src, idx = _case(*shape, "card", dirty_sentinel=True)
    S, w = src.shape[0], idx.shape[1]
    ts, ti = _t(src).to(dev), _t(idx).to(dev)
    want = gfmat.xor_reduce_gather(ts, ti)
    skip = gfmat.xor_reduce_gather_skip(ts, ti, S - 1)
    before = dict(kernels.LAUNCHES)
    for R in (1, 8, 16, 32):
        if R * w > 1024:
            continue
        cnt = kernels.probe_counts(ti, S - 1, R)
        for _ in range(2):  # back to back on one stream: the barriers start afresh in each launch
            for mode in (0, 1, 2):
                assert torch.equal(kernels.gather_v1(ts, ti, mode, R=R), want), (R, mode)
            assert torch.equal(kernels.gather_v2(ts, ti, cnt, S - 1, R=R), skip), R
        assert torch.equal(kernels.gather_db(ts, ti, R=R, check=True), want), R
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] > before[k] for k in ("gather_v1", "gather_v2", "gather_db"))
    assert not kernels.take_index_errors(dev) and not kernels.take_count_errors(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 5])
def test_probe_out_of_range_slots_read_as_zero_on_card(w):
    """An index outside [0, S) copies nothing, reads as zero and sets the flag
    (at width 1 the row is stored from the zero strip); nothing hangs."""
    dev = _card()
    src, idx = _case(300, 45, w, 9008, 0.2, "oob", dirty_sentinel=True)
    bad = idx.copy()
    bad[3, 0], bad[17, w - 1], bad[44, 0] = 300, -1, 1 << 30
    ext = np.vstack([src, np.zeros((1, src.shape[1]), np.uint8)])  # row 300: zeros
    want = _numpy_ref(ext, np.where((bad < 0) | (bad >= 300), 300, bad))
    want_skip = _numpy_ref(ext, np.where((bad < 0) | (bad >= 300) | (bad == 299), 300, bad))
    ts, tb = _t(src).to(dev), _t(bad).to(dev)
    for R in (8, 32):
        for mode in (0, 1, 2):
            assert np.array_equal(kernels.gather_v1(ts, tb, mode, R=R).cpu().numpy(), want), (R, mode)
            assert kernels.take_index_errors(dev)
        got = kernels.gather_v2(ts, tb, kernels.probe_counts(tb, 299, R), 299, R=R)
        assert np.array_equal(got.cpu().numpy(), want_skip), R
        assert kernels.take_index_errors(dev) and not kernels.take_count_errors(dev)


@pytest.mark.cuda
def test_probe_geometry_is_the_library_rule_on_card():
    """probe_geometry (Python) against ring_plan (the .cu file) over the grid
    the CPU test walks."""
    import ctypes

    from nanorq_tpu_torch.ops import _build

    _card()
    lib = _build.load()
    plan = (ctypes.c_int64 * 8)()
    for n, w, t, R in GEOMETRY_GRID:
        for mode in (0, 1, 2):
            for sms in (132, 7):
                g = kernels.probe_geometry(n, w, t, R, mode, sms)
                assert lib.nrq_gather_stage_plan(t, n, w, R, mode, sms, plan) == 0
                assert list(plan) == [g[k] for k in ("rows_per_step", "copy_bytes", "stages", "slots_per_step",
                                                      "steps", "blocks", "threads", "smem_bytes")], (n, w, t, R, mode)


@pytest.mark.cuda
def test_db_geometry_is_the_library_rule_on_card():
    """db_geometry (Python) against db_plan (the .cu file) over the grid the
    CPU test walks, under the rule's own constants and others."""
    import ctypes

    from nanorq_tpu_torch.ops import _build

    _card()
    lib = _build.load()
    plan = (ctypes.c_int64 * 8)()
    for n, w, t, R in GEOMETRY_GRID:
        for sms in (132, 7):
            for stage, steps in ((0, 0), (32 * 1024, 3), (16 * w, 64)):
                knobs = {k: v for k, v in (("stage_bytes", stage), ("sweep_steps", steps)) if v}
                g = kernels.db_geometry(n, w, t, R, sms, **knobs)
                assert lib.nrq_gather_db_plan(t, n, w, R, sms, stage, steps, plan) == 0
                assert list(plan) == [g[k] for k in ("rows_per_step", "copy_bytes", "slots_per_step",
                                                      "row_blocks_per_sweep", "sweeps", "blocks", "threads",
                                                      "smem_bytes")], (n, w, t, R, sms, knobs)


DB_EDGES = {  # name -> (S, n, w, t, frac, R)
    "one_step": (50, 3, 4, 64, 0.3, 8),
    "one_row_block_a_sweep": (300, 64, 8, 1280, 0.3, 8),
    "tails_both_ways": (300, 45, 8, 5008, 0.3, 8),
    "tails_both_ways_w1": (300, 45, 1, 9008, 0.0, 16),
    "long_sweeps": (600, 4000, 2, 4096, 0.1, 8),
    "slots_1024_R1": (2000, 5, 1024, 64, 0.5, 1),
    "slots_1024_R32": (400, 70, 32, 256, 0.4, 32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(DB_EDGES))
def test_db_edges_on_card(name):
    """gather_db where its sweep has edges: one step, a sweep of one row
    block, tails in rows and in t, sweeps of many steps, 1024 slots; each
    launched back to back, under the rule's constants and under others."""
    from nanorq_tpu_torch.tools.gather_db_tune import _tuned

    dev = _card()
    S, n, w, t, frac, R = DB_EDGES[name]
    src, idx = _case(S, n, w, t, frac, "db", name, dirty_sentinel=True)
    ts, ti = _t(src).to(dev), _t(idx).to(dev)
    want = gfmat.xor_reduce_gather(ts, ti)
    for _ in range(3):  # back to back on one stream: the barriers start afresh in each launch
        assert torch.equal(kernels.gather_db(ts, ti, R=R), want)
    for stage, steps in ((16 * w, 1), (32 * 1024, 3), (48 * 1024, 1000)):
        assert torch.equal(_tuned(ts, ti, R, stage, steps), want), (stage, steps)
    assert not kernels.take_index_errors(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 5])
def test_db_out_of_range_steps_on_card(w):
    """Steps whose every index lies outside [0, S) copy nothing, read as zero
    and set the flag; the sweep goes on, and nothing hangs."""
    dev = _card()
    src, idx = _case(300, 90, w, 9008, 0.2, "db-oob")
    bad = idx.copy()
    bad[16:40] = 300  # three whole row blocks of R = 8: steps with no copy at all
    bad[3, 0], bad[77, w - 1] = -1, 1 << 30
    ext = np.vstack([src, np.zeros((1, src.shape[1]), np.uint8)])  # row 300: zeros
    want = _numpy_ref(ext, np.where((bad < 0) | (bad >= 300), 300, bad))
    ts, tb = _t(src).to(dev), _t(bad).to(dev)
    for R in (8, 32):
        assert np.array_equal(kernels.gather_db(ts, tb, R=R).cpu().numpy(), want), R
        assert kernels.take_index_errors(dev)
    allbad = torch.full((20, w), 300, dtype=torch.int32, device=dev)
    assert not kernels.gather_db(ts, allbad).any() and kernels.take_index_errors(dev)


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
