"""The traffic generator: a seed repeats exactly, and every seed offers the
same sizes and arrivals in another order."""

from __future__ import annotations

import json
from collections import Counter

import pytest

from gpubench import traffic
from gpubench.tests.conftest import REPO


def _mix(name):
    return json.loads((REPO / f"gpubench/traffic/{name}.json").read_text())


def _draw(mix, seed, n):
    g = traffic.Generator(mix, seed, 151936, 4096)
    return [g.next() for _ in range(n)]


@pytest.mark.parametrize("name", ["batch-decode", "rag-prefill"])
def test_a_seed_repeats_exactly(name):
    a, b = _draw(_mix(name), 2**31 + 5, 70), _draw(_mix(name), 2**31 + 5, 70)
    assert [(r.prompt, r.max_new_tokens, r.temperature, r.seed, r.due_s) for r in a] == \
           [(r.prompt, r.max_new_tokens, r.temperature, r.seed, r.due_s) for r in b]


@pytest.mark.parametrize("name", ["batch-decode", "rag-prefill"])
def test_seeds_share_each_blocks_sizes_in_another_order(name):
    mix = _mix(name)
    n = mix["block"]
    a, b = _draw(mix, 1, 2 * n), _draw(mix, 2**33 + 1, 2 * n)
    for k in range(2):
        blk_a, blk_b = a[k * n:(k + 1) * n], b[k * n:(k + 1) * n]
        assert Counter(len(r.prompt) for r in blk_a) == Counter(len(r.prompt) for r in blk_b)
        assert Counter(r.max_new_tokens for r in blk_a) == Counter(r.max_new_tokens for r in blk_b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    assert [r.prompt[:4] for r in a] != [r.prompt[:4] for r in b]


@pytest.mark.parametrize("name", ["batch-decode", "rag-prefill"])
def test_every_run_of_strata_requests_holds_one_of_each_class(name):
    mix = _mix(name)
    n, k = mix["block"], mix["strata"]
    for key, sizes in (("prompt_tokens", lambda r: len(r.prompt)), ("output_tokens", lambda r: r.max_new_tokens)):
        q = sorted(traffic.lognormal_quantiles(mix[key], n))
        cls = {}
        for i, v in enumerate(q):  # a size shared by two classes belongs to either
            cls.setdefault(v, set()).add(i // (n // k))
        for seed in (4, 2**31 + 3):
            reqs = _draw(mix, seed, 2 * n)
            for j in range(0, 2 * n, k):
                got = [cls[sizes(r)] for r in reqs[j:j + k]]
                assert any(len({c for c in pick}) == k for pick in _choices(got)), (key, seed, j)


def _choices(sets):
    if not sets:
        yield ()
        return
    for c in sets[0]:
        for rest in _choices(sets[1:]):
            yield (c, *rest)


def test_open_loop_blocks_take_the_same_time_at_the_stated_rate():
    mix = _mix("rag-prefill")
    n, rate = mix["block"], mix["loop"]["rate_per_s"]
    for seed in (3, 2**31 + 99):
        due = [r.due_s for r in _draw(mix, seed, 3 * n)]
        assert due == sorted(due)
        ends = [due[(k + 1) * n - 1] for k in range(3)]
        assert ends[1] - ends[0] == pytest.approx(ends[2] - ends[1], rel=1e-9)
        # the block's gaps are scaled to sum to n / rate
        assert ends[1] - ends[0] == pytest.approx(n / rate, rel=1e-9)


@pytest.mark.parametrize("name", ["batch-decode", "rag-prefill"])
def test_lengths_stay_in_their_ranges_and_a_quarter_decode_greedily(name):
    mix = _mix(name)
    reqs = _draw(mix, 11, 4 * mix["block"])
    assert all(mix["prompt_tokens"]["min"] <= len(r.prompt) <= mix["prompt_tokens"]["max"] for r in reqs)
    assert all(mix["output_tokens"]["min"] <= r.max_new_tokens <= mix["output_tokens"]["max"] for r in reqs)
    assert sum(r.greedy for r in reqs) == len(reqs) // mix["sampling"]["greedy_every"]
    assert all(0 <= t < 151936 for r in reqs for t in r.prompt)


def test_rag_prompts_pass_2048_rows_about_a_third_of_the_time():
    mix = _mix("rag-prefill")
    q = traffic.lognormal_quantiles(mix["prompt_tokens"], mix["block"])
    assert 0.25 <= sum(p > 2048 for p in q) / len(q) <= 0.4
