"""The statistics: every counted request enters a tail, a failed or
unfinished one as missing every limit; a rate is all tokens over the whole
window."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

from gpubench import readers, stats
from gpubench.tests.conftest import REPO
from gpubench.harness import load_module


def _req(due, first, last, n, finished=True):
    return types.SimpleNamespace(due=due, first=first, last=last, served=list(range(n)), finished=finished)


@pytest.mark.parametrize("q", [0.5, 0.9, 0.95])
def test_percentile_matches_numpys_linear_quantile(q):
    xs = list(np.random.default_rng(0).exponential(size=137))
    assert stats.percentile(xs, q) == pytest.approx(float(np.quantile(xs, q)))


def test_the_tail_takes_every_request_and_failures_miss():
    reqs = [_req(0.0, 0.1 * (i + 1), 1.0 + i, 10) for i in range(10)]
    run = types.SimpleNamespace(requests=reqs)
    assert readers.ttft_ms(run, 0.9) == pytest.approx(1e3 * float(np.quantile([0.1 * (i + 1) for i in range(10)], 0.9)))
    reqs[0].finished = False  # the fastest request fails: it now counts as missing every limit
    assert readers.ttft_ms(run, 0.9) > readers.ttft_ms(types.SimpleNamespace(requests=reqs[1:]), 0.9) * 0.99
    for r in reqs[:2]:
        r.finished = False
    assert math.isinf(readers.ttft_ms(run, 0.9))
    assert math.isinf(readers.tpot_ms(run, 0.9))


def test_tpot_is_each_requests_gap_between_its_first_and_last_token():
    reqs = [_req(0.0, 1.0, 1.0 + 0.02 * (n - 1), n) for n in (2, 10, 100)]
    assert readers.tpot_ms(types.SimpleNamespace(requests=reqs), 0.5) == pytest.approx(20.0)


def test_output_tok_s_is_all_tokens_over_the_whole_window():
    m = load_module(REPO / "gpubench/metrics/output_tok_s.py", "output_tok_s")
    assert m.read(types.SimpleNamespace(tokens=4000, window_s=40.0)) == pytest.approx(100.0)


def test_slot_utilization_reads_the_counters_across_the_window():
    m = load_module(REPO / "gpubench/metrics/slot_util.decode.py", "slot_util.decode")
    run = types.SimpleNamespace(stats0={"decode_steps": 100, "decode_tokens": 700},
                                stats1={"decode_steps": 300, "decode_tokens": 2200}, n_slots=8)
    assert m.read(run) == pytest.approx(100.0 * 1500 / (200 * 8))
    run.stats1 = dict(run.stats0)
    assert m.read(run) is None
