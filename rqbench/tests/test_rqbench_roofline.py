"""The roofline's row counts against counts by hand at small K."""

import numpy as np
import pytest

from rqbench import roofline
from rqbench.reference import rfc6330


def test_generate_rows_are_k_in_and_l_out():
    P = rfc6330.params(10)
    assert (P.Kp, P.S, P.H, P.L) == (10, 7, 10, 27)
    assert roofline.generate_rows(P) == (10, 27)
    assert roofline.generate_rows(rfc6330.params(1000)) == (1000, 1071)


def test_lt_rows_count_each_touched_intermediate_row_once():
    P = rfc6330.params(10)
    nb = rfc6330.neighbors(P, [10, 11])
    # by hand: the two repair ISIs' LT and PI neighbours, a row touched twice counted once
    hand = len(set(int(x) for x in nb[0]) | set(int(x) for x in nb[1]))
    assert roofline.lt_rows(P, 2) == (hand, 2)
    assert roofline.lt_rows(P, 1) == (len(set(int(x) for x in nb[0])), 1)


def test_neighbors_follow_the_rfc_walk():
    P = rfc6330.params(10)
    d, a, b, d1, a1, b1 = (int(v[0]) for v in rfc6330.tuples(P, [3]))
    lt = [(b + j * a) % P.W for j in range(d)]
    pi, x = [], b1
    while x >= P.P:
        x = (x + a1) % P.P1
    pi.append(x)
    while len(pi) < d1:
        x = (x + a1) % P.P1
        while x >= P.P:
            x = (x + a1) % P.P1
        pi.append(x)
    assert list(rfc6330.neighbors(P, [3])[0]) == lt + [P.W + v for v in pi]


def test_decode_rows_and_share():
    assert roofline.decode_rows(1000, 60, 50) == (1050, 60)
    assert roofline.share_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.share_pct(1.0, 0.0) is None


@pytest.mark.parametrize("K,lost,overhead,plan", [
    (1000, 60, 50, "dense-W"),  # k1000.bulk_dec_fixed: K' = 1002, ops.wpath
    (50000, 3000, 2500, "structured"),  # k50000.bulk_dec_fixed: K' = 50511, ops.program
])
def test_repair_roofline_counts_the_same_rows_whatever_the_plan(K, lost, overhead, plan):
    """repair_roofline.dec: per block K + overhead rows in (the K - lost
    source rows and lost + overhead repair rows received), the lost rows
    out, times T, over the kernels' union under repair_block."""
    from rqbench import harness
    from rqbench.run import reader
    from rqbench.trace import Trace

    T, Z, objects = 1280, 3, 2
    run = harness.Run(cfg={}, mix={}, K=K, T=T, Z=Z, n_repair=K // 5, overhead=overhead)
    run.objects = [{"i": i, "bytes": Z * K * T, "dec_s": 1.0, "lost": [lost] * Z} for i in range(objects)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": "rq.window", "ts": 0.0, "dur": 1000.0},
          {"ph": "X", "cat": "user_annotation", "name": "rq.repair", "ts": 100.0, "dur": 500.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110.0, "dur": 1.0,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 120.0, "dur": 1.0,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 115.0, "dur": 40.0, "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 135.0, "dur": 40.0, "args": {"correlation": 2}}]
    run.trace = Trace(ev)
    hand = objects * Z * ((K - lost) + (lost + overhead) + lost) * T  # bytes in and out
    secs = 60e-6  # the union [115, 175) us
    assert reader("repair_roofline.dec")(run) == pytest.approx(100.0 * hand / 3.35e12 / secs)
    run.trace = Trace(ev[:2])  # no kernel under repair_block: nothing to read
    assert reader("repair_roofline.dec")(run) is None
