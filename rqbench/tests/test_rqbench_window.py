"""The window: rates come from all objects, the window runs
until the last object begun in it is done, and the check runs on the CPU at a
small size with the program as it is."""

import numpy as np
import pytest

from rqbench import harness, traffic
from rqbench.readers import rate_mbps, span_median_ms

SMALL = {"K": 300, "T": 16, "Al": 8, "bulk_blocks": 5}  # lost + overhead stays under K//5 by 6 sd


def _run(times, key="enc_s", nbytes=2**20) -> harness.Run:
    run = harness.Run(cfg={}, mix={}, K=1, T=1, Z=1, n_repair=1, overhead=0)
    run.objects = [{"i": i, "bytes": nbytes, key: t} for i, t in enumerate(times)]
    run.window_s = sum(times)
    return run


def test_rate_counts_every_object_over_the_whole_window():
    run = _run([0.5, 0.25, 0.25])
    assert rate_mbps(run, "enc_s") == pytest.approx(8 * 3 / 1.0)
    run.window_s = 2.0  # harness time between objects counts too
    assert rate_mbps(run, "enc_s") == pytest.approx(8 * 3 / 2.0)
    assert rate_mbps(run, "dec_s") is None


def test_span_median_sums_an_objects_spans():
    run = _run([1.0])
    run.spans = [("generate", 0, 0.0, 1.0), ("repair_symbols", 0, 1.0, 1.5), ("generate", 1, 2.0, 2.2),
                 ("repair_symbols", 1, 2.2, 2.3), ("load", 0, 5.0, 9.0)]
    assert span_median_ms(run, ["generate", "repair_symbols"]) == pytest.approx(1e3 * (1.5 + 0.3) / 2)


@pytest.mark.parametrize("mix_name", ["bulk_enc", "bulk_dec_fixed"])
def test_cell_window_and_check_on_the_cpu(mix_name):
    mix = traffic.load(harness.HERE / "traffic" / f"{mix_name}.json")
    cell = harness.Cell(SMALL, dict(mix, warmup=2), 2**31 + 99, "cpu")
    cell.make_pool()
    cell.warm_up()
    cell.window(0.3)
    objs = cell.run.objects
    assert objs and [o["i"] for o in objs] == list(range(len(objs)))
    done = sum(o.get("enc_s", 0) + o.get("dec_s", 0) for o in objs)
    assert 0.3 <= cell.run.window_s and done <= cell.run.window_s
    checks = cell.check()
    assert cell.verdict(checks), checks
    assert all(v == 0 for v, _ in checks.values())
