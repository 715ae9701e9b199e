"""The traffic generator: deterministic per seed, losses as the mix files say,
packets in transmission order."""

import json
from pathlib import Path

import numpy as np
import pytest

from rqbench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"


def _mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("K", [1000, 50000])
def test_patterns_repeat_per_seed(K):
    mix = _mix("bulk_dec_fixed")
    draw = lambda seed: traffic.lost_esis(mix, K, np.random.default_rng(seed))  # noqa: E731
    assert np.array_equal(draw(2**31 + 5), draw(2**31 + 5))
    assert not np.array_equal(draw(2**31 + 5), draw(2**31 + 6))


@pytest.mark.parametrize("K", [1000, 50000])
def test_fixed_loses_round_rate_k(K):
    g = traffic.lost_esis(_mix("bulk_dec_fixed"), K, np.random.default_rng(3))
    assert g.size == round(0.06 * K) and np.unique(g).size == g.size and g.max() < K
    assert np.all(np.diff(g) > 0)


def test_no_loss_and_unknown_models():
    assert traffic.lost_esis(_mix("bulk_enc"), 1000, np.random.default_rng(1)).size == 0
    with pytest.raises(ValueError):
        traffic.lost_esis({"loss": {"model": "iid", "rate": 0.06}}, 1000, np.random.default_rng(1))


def test_overhead_and_repair_counts_follow_the_mix():
    mix = _mix("bulk_dec_fixed")
    assert traffic.overhead(mix, 1000) == 50 and traffic.overhead(mix, 50000) == 2500
    assert traffic.n_repair(mix, 1000) == 200 and traffic.n_repair(mix, 50000) == 10000
    assert traffic.overhead(_mix("bulk_enc"), 1000) == 0


def test_stream_order_tags_and_payloads():
    Z, K, n, T, ov = 2, 6, 4, 3, 1
    gaps = [np.array([1, 4]), np.array([0])]
    s = traffic.Stream(Z, K, n, gaps, ov)
    want = [(0, e) for e in (0, 2, 3, 5, 6, 7, 8)] + [(1, e) for e in (1, 2, 3, 4, 5, 6, 7)]
    assert [(int(t) >> 24, int(t) & 0xFFFFFF) for t in s.tags] == want
    src = np.arange(Z * K * T, dtype=np.uint8).reshape(Z * K, T)
    rep = (200 + np.arange(Z * n * T)).astype(np.uint8).reshape(Z * n, T)
    got = s.payloads(np.concatenate([src, rep]))
    assert np.array_equal(got[0], src[0]) and np.array_equal(got[4], rep[0]) and np.array_equal(got[6], rep[2])
    assert np.array_equal(got[7], src[K + 1]) and np.array_equal(got[13], rep[n + 1])


def test_stream_bursts_stop_at_each_block():
    Z, K, n, T, ov = 2, 6, 4, 3, 1
    s = traffic.Stream(Z, K, n, [np.array([1, 4]), np.array([0])], ov)
    got = s.payloads(np.zeros((Z * (K + n), T), np.uint8))
    blocks = list(s.blocks(got, 4))
    assert [b for b, _ in blocks] == [0, 1]
    assert [[len(p) for p, _ in bursts] for _, bursts in blocks] == [[4, 3], [4, 3]]
    for b, bursts in blocks:
        tags = np.concatenate([t for _, t in bursts])
        assert np.all(tags >> 24 == b) and tags.size == 7


def test_stream_refuses_more_loss_than_repair():
    with pytest.raises(ValueError):
        traffic.Stream(1, 10, 3, [np.arange(3)], 1)
