"""The plain reference decoder (`reference/decode.py`) against the plain
reference encoder: it recovers a block's source symbols from random sets of
K + overhead received symbols, source and repair mixed, padding included
(K < K'); it returns None where the set does not determine the block; it
refuses an L it cannot solve.  And the two readers of its cell's new spans,
`repair_replay_ms.dec` and `repair_lt_ms.dec`, on a synthetic run."""

import numpy as np
import pytest

from rqbench import harness, run as runmod
from rqbench.reference import decode as ref
from rqbench.reference import rfc6330


def _symbols(K, T, n_repair, seed):
    """(source [K, T], every symbol [K + n_repair, T] by ESI), from the plain encoder."""
    src = np.random.default_rng(seed).integers(0, 256, (K, T), dtype=np.uint8)
    rep = rfc6330.repair_symbols(rfc6330.params(K), src[None], n_repair)[0]
    return src, np.concatenate([src, rep])


@pytest.mark.parametrize("K,overhead", [(10, 0), (10, 2), (37, 1), (101, 3), (300, 2)])
def test_recovers_the_source_from_random_subsets(K, overhead):
    P = rfc6330.params(K)
    src, every = _symbols(K, 8, 2 * K, seed=K)
    rng = np.random.default_rng(K + overhead)
    for _ in range(3):
        esis = rng.choice(3 * K, K + overhead, replace=False)
        got = ref.decode(P, esis, every[esis])
        if overhead >= 2:  # rarely rank deficient at 2 or more: these draws are not
            assert got is not None
        assert got is None or np.array_equal(got, src)


def test_recovers_from_repair_symbols_alone():
    K = 37
    src, every = _symbols(K, 24, K + 4, seed=5)
    esis = np.arange(K, 2 * K + 4)
    assert np.array_equal(ref.decode(rfc6330.params(K), esis, every[esis]), src)


def test_none_where_the_set_does_not_determine_the_block():
    K = 10
    P = rfc6330.params(K)
    src, every = _symbols(K, 8, 10, seed=1)
    esis = np.arange(1, K)  # one symbol short
    assert ref.decode(P, esis, every[esis]) is None
    # K symbols whose patched system is rank deficient (a search over seeds)
    lost = np.sort(np.random.default_rng(291).choice(K, 4, replace=False))
    esis = np.concatenate([np.setdiff1d(np.arange(K), lost), np.arange(K, K + 4)])
    assert ref.decode(P, esis, every[esis]) is None
    esis = np.concatenate([esis, [K + 4]])  # one more repair symbol
    assert np.array_equal(ref.decode(P, esis, every[esis]), src)


def test_refuses_an_l_above_the_solve():
    P = rfc6330.params(5000)
    assert P.L > harness.SOLVE_MAX_L
    with pytest.raises(ValueError):
        ref.decode(P, np.arange(5000), np.zeros((5000, 1), np.uint8))


def _receiver(with_structured: bool) -> harness.Run:
    """Two objects of two blocks each; with `with_structured`, every block's
    repair.apply holds repair.replay and repair.lt."""
    run = harness.Run(cfg={}, mix={}, K=1, T=1, Z=2, n_repair=1, overhead=0)
    spans, prog = [], []
    for i, base in enumerate((0.0, 10.0)):
        spans += [("ingest", i, base, base + 4.0), ("repair", i, base + 4.0, base + 9.0)]
        for b in range(2):
            a = base + 4.1 + 2.0 * b
            prog += [("repair.apply", "repair_block", 1, a + 0.2, a + 1.0),
                     ("repair_block", None, 1, a, a + 1.9)]
            if with_structured:
                prog += [("repair.replay", "repair.apply", 1, a + 0.25, a + 0.45 + 0.1 * i),
                         ("repair.lt", "repair.apply", 1, a + 0.6, a + 0.7 + 0.2 * b)]
    run.spans, run.program_spans = spans, prog
    return run


def test_readers_of_the_structured_spans():
    run = _receiver(True)
    # per object, both blocks: replay 0.2 + 0.2 (object 0) and 0.3 + 0.3 (object 1); LT 0.1 + 0.3 in each
    assert runmod.reader("repair_replay_ms.dec")(run) == pytest.approx(1e3 * (0.4 + 0.6) / 2)
    assert runmod.reader("repair_lt_ms.dec")(run) == pytest.approx(400.0)


def test_readers_read_nothing_where_no_structured_span_was_recorded():
    empty = harness.Run(cfg={}, mix={}, K=1, T=1, Z=1, n_repair=1, overhead=0)
    empty.program_spans = []  # a run in which the program recorded nothing
    for run in (_receiver(False), empty):
        assert runmod.reader("repair_replay_ms.dec")(run) is None
        assert runmod.reader("repair_lt_ms.dec")(run) is None


def test_the_new_cell_and_metrics_in_benchmark_json():
    spec = harness.load_spec()
    cell = "k50000.bulk_dec_fixed"
    w, cfg, mix = harness.cell_files(spec, cell)
    assert (w["config"], w["traffic"], w["chips"]) == ("k50000_t1280_node_loss", "bulk_dec_fixed", 1)
    assert cfg["K"] == 50000 and mix["role"] == "receive"
    assert not harness.solvable(cfg["K"])  # its packets are certified, not solved
    names = {m["name"] for m in runmod.metrics_for(spec, cell, True)}
    assert {"repair_replay_ms.dec", "repair_lt_ms.dec", "repair_roofline.dec", "repair_host_ms.dec"} <= names
    assert [m["name"] for m in runmod.metrics_for(spec, cell, False)] == ["decode_mbps", "setup_s"]
    for name in ("repair_replay_ms.dec", "repair_lt_ms.dec"):
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()
