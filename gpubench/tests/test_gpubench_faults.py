"""The comparison fails a run whose timed path is broken underneath: the
harness's run at a tiny size on the CPU (the look for a card skipped), with
each fault a one-chip serving cell can have planted in the program.  (The
exchange between chips does not exist in a one-chip cell.)"""

from __future__ import annotations

import pytest
import torch

from gpubench.tests.conftest import make_tiny_root, run_tiny


def test_a_sound_run_is_correct(tiny_batch):
    res = run_tiny(tiny_batch, "tiny.batch-decode")
    assert res["correct"], res["checks"]
    assert res["checks"]["tokens_compared"]["value"] >= 20
    assert res["failed"] == 0 and res["attempted"] > 0


def test_a_decode_step_that_leaves_the_cache_unchanged_is_not_correct(tiny_batch, monkeypatch):
    import qwen3_rs_tpu_torch.models.qwen3 as model

    write = model._write_rows

    def no_decode_writes(cache, layer, k, v, pos, write_mask):
        if k.shape[1] > 1:  # prefill windows still write
            write(cache, layer, k, v, pos, write_mask)

    monkeypatch.setattr(model, "_write_rows", no_decode_writes)
    res = run_tiny(tiny_batch, "tiny.batch-decode")
    assert not res["correct"], res["checks"]


def _patch_sampler(monkeypatch, fault):
    import qwen3_rs_tpu_torch.serving.scheduler as sched

    sample = sched.sample_tokens
    calls = [0]

    def faulty(logits, *a, **kw):
        calls[0] += 1
        return fault(sample(logits, *a, **kw), logits, calls[0])

    monkeypatch.setattr(sched, "sample_tokens", faulty)


def test_half_of_the_batch_left_out_is_not_correct(tiny_batch, monkeypatch):
    def half(tokens, logits, n):
        # the second half of the slots gets the first half's tokens
        out = tokens.clone()
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out

    _patch_sampler(monkeypatch, half)
    res = run_tiny(tiny_batch, "tiny.batch-decode")
    assert not res["correct"], res["checks"]


def test_a_token_altered_where_it_is_produced_is_not_correct(tiny_batch, monkeypatch):
    def altered(tokens, logits, n):
        return (tokens + 1) % logits.shape[-1] if n % 3 == 0 else tokens

    _patch_sampler(monkeypatch, altered)
    res = run_tiny(tiny_batch, "tiny.batch-decode")
    assert not res["correct"], res["checks"]


def test_a_sampled_token_altered_where_it_is_drawn_is_not_correct(tiny_batch, monkeypatch):
    """The device sampler's temperature and top-p branch alone is broken
    (its pick moved to the next vocabulary entry, as an index taken before
    the sort would): the greedy tokens stay right, the sampled ones fail."""
    import qwen3_rs_tpu_torch.ops.sampling as sampling

    draw = sampling._topp_sample

    def shifted(scaled, generator, topp):
        return (draw(scaled, generator, topp) + 1) % scaled.shape[-1]

    monkeypatch.setattr(sampling, "_topp_sample", shifted)
    res = run_tiny(tiny_batch, "tiny.batch-decode")
    c = res["checks"]
    assert not res["correct"], c
    assert c["served_gap_sd"]["value"] <= c["served_gap_sd"]["limit"], c
    assert c["sampled_gap_sd"]["value"] > c["sampled_gap_sd"]["limit"], c


def test_the_nucleus_floor_is_the_lowest_kept_logit():
    from gpubench import check

    lg = torch.tensor([[4.0, 3.0, 2.0, 1.0, 0.0]])
    p = torch.softmax(lg / 0.5, dim=-1)[0].tolist()  # 0.865, 0.117, 0.016, ...
    assert check.nucleus_floor(lg, 0.0, 0.95).item() == 4.0
    assert check.nucleus_floor(lg, 0.5, p[0] - 1e-3).item() == 4.0  # the best alone passes top-p
    assert check.nucleus_floor(lg, 0.5, p[0] + 1e-3).item() == 3.0
    assert check.nucleus_floor(lg, 0.5, p[0] + p[1] + 1e-3).item() == 2.0
    assert check.nucleus_floor(lg, 0.5, 1.0).item() == 0.0


def test_a_wrong_first_token_of_a_long_prompt_is_not_correct(tmp_path, monkeypatch):
    """The open-loop cell: the admission's window itself is broken (its
    last layer's output dropped), so the first tokens are wrong."""
    import qwen3_rs_tpu_torch.serving.scheduler as sched

    forward = sched.qwen3_forward

    def broken(config, weights, tokens, cache, pos, **kw):
        logits, cache = forward(config, weights, tokens, cache, pos, **kw)
        if torch.as_tensor(tokens).shape[1] > 1:
            logits = logits.roll(1, dims=-1)
        return logits, cache

    monkeypatch.setattr(sched, "qwen3_forward", broken)
    root = make_tiny_root(tmp_path, "rag-prefill")
    res = run_tiny(root, "tiny.rag-prefill")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("traffic_name", ["batch-decode", "rag-prefill"])
def test_the_float8_control_reads_far_above_the_program(tmp_path, traffic_name):
    """The control (the reference in float8 at the program's place) at a
    tiny size: its widest gap over the greedy rows reads many times the
    program's, over the sampled rows above it, and the program's stay under
    the cell's limits.  (At the cells' sizes on the card the control
    reads above the limit itself: ``PERF.md`` keeps those readings.)"""
    import time

    from gpubench import check, harness, traffic
    from gpubench import weights as draw

    root = make_tiny_root(tmp_path, traffic_name)
    cell = harness.load_cell(f"tiny.{traffic_name}", root)
    for seed in (5, 2**31 + 7, 2**32 + 9):
        torch.manual_seed(0)
        torch.set_num_threads(2)
        w = draw.draw(cell.shapes, traffic.derive_seed(seed, 1), "cpu", cell.shapes.tied)
        rec = cell.driver.run(harness.Context(cell, w, seed, 3.0, False, "cpu", time.perf_counter()))
        g = check.gaps(w, cell.shapes, check.sample(rec["requests"], 100, seed), control=True)
        assert g["tokens"] > 0 and g["sampled_tokens"] > 0, g
        assert g["control_gap_sd"] > 5 * g["served_gap_sd"], g
        assert g["control_sampled_gap_sd"] > g["sampled_gap_sd"], g  # a nucleus of a few tokens at this size
        assert g["served_gap_sd"] < cell.check["limit_gap_sd"], g
        assert g["sampled_gap_sd"] < cell.check["limit_sampled_gap_sd"], g


def test_an_open_loop_window_of_whole_blocks_counts_each_of_their_requests(tmp_path):
    root = make_tiny_root(tmp_path, "rag-prefill")  # blocks of 8 at 20 a second
    res = run_tiny(root, "tiny.rag-prefill", seconds=2.0)
    assert res["attempted"] == 40 and res["failed"] == 0
