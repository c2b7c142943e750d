"""Speculative serving (``spec_k``): the port's ``ContinuousBatchingEngine``
with n-gram speculative chunks on the page pool with device sampling.

* **Greedy streams** with ``spec_k`` 2 and 3 equal the port's plain
  (``spec_k=0``) streams, and in one configuration (2 layers, pages of 16,
  speculation kept on) the JAX package's speculative scheduler's, the JAX
  engine through its interpret-mode kernels (``torch_parity``), with the same
  ``stats()``, the acceptance EWMA included.  A stream may part once, only at
  a near-tie (``test_torch_serving_device._match``).
* Every page is released and every request ends at its exact budget; a
  batch of greedy and sampled requests completes.
* **The acceptance-adaptive policy**, from the JAX package's cases: an
  unreachable ``spec_min_accept`` turns speculation off, a probe interval of
  one chunk turns it back on and off again, the bigram gate holds probes on
  traffic with no repeated bigram, and cyclic prompts keep it on; the same
  ``stats()`` keys.
* Composition with ``prefix_cache`` (the history seeded from the whole
  prompt, the adopted prefix included) and ``prefill_chunk``.
* Under tensor parallelism (2 gloo ranks on the CPU): the tp=1 engine's
  streams and counters, every rank the same streams.
* JAX's ``ValueError`` for the dense layout and for host sampling; ``batch
  --spec`` through the CLI prints the plain run's completions.
"""

import functools


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serving import BUCKETS, CONFIG, JCONFIG, _drive, weights  # noqa: F401
from test_torch_serving_device import _match
from test_torch_generate import exported  # noqa: F401
from torch_parity import route_jax_through_interpret_kernels
from torch_tp_ranks import model

from qwen3_rs_tpu.serving import ContinuousBatchingEngine as JaxEngine
from qwen3_rs_tpu.serving import Request as JaxRequest
from qwen3_rs_tpu_torch.inference import speculative
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request
from qwen3_rs_tpu_torch.serving.scheduler import start_tp_engine

torch.set_num_threads(2)

PAGE = 16
COMMON = dict(n_slots=3, mode="fast", prefill_buckets=BUCKETS, kv_layout="paged", page_size=PAGE,
              sampling="device", decode_chunk_steps=4, seed=3)
# (id, prompt, max_new, temperature, seed): the JAX package's speculative
# serving schedule, four requests on three slots; prompts that cycle.
SCHEDULE = {0: [(0, [3, 4, 3, 4, 3], 9, 0.0, 100), (1, [40, 50, 60, 70, 80], 6, 0.0, 101),
                (2, [22], 7, 0.0, 102), (3, [9, 11, 9, 11], 8, 0.0, 103)]}
BUDGETS = {0: 9, 1: 6, 2: 7, 3: 8}


def _engine(pw, **kw):
    return ContinuousBatchingEngine(config=CONFIG, weights=pw, cache_dtype=torch.bfloat16, device="cpu",
                                    **{**COMMON, **kw})


def _run(pw, schedule=SCHEDULE, **kw):
    engine = _engine(pw, **kw)
    streams, stats = _drive(engine, schedule, Request)
    assert engine.allocator.free_pages == engine.allocator.n_pages - 1
    return engine, streams, stats


def _prompts(schedule):
    return {rid: p for reqs in schedule.values() for rid, p, *_ in reqs}


@pytest.mark.parametrize("k", [2, 3])
def test_greedy_streams_equal_plain(weights, k):  # noqa: F811
    """Speculation on (``spec_min_accept=0``) and with the default policy:
    the plain engine's greedy streams, each request at its budget (no EOS
    met here), one count read a round."""
    pw = weights[1]
    plain, want, _ = _run(pw)
    assert {rid: len(t) for rid, (t, _) in want.items()} == BUDGETS
    for kw in (dict(spec_min_accept=0.0), {}):
        reads = speculative.HOST_READS["counts"]
        engine, got, stats = _run(pw, spec_k=k, **kw)
        _match(plain.completed, engine.completed, pw, _prompts(SCHEDULE))
        assert set(stats) == set(plain.stats()) - {"p50_ttft"} | {"spec_enabled", "spec_accept_ewma",
                                                                 "spec_probes_gated"}
        assert stats["decode_tokens"] == sum(BUDGETS.values()) - len(BUDGETS)
        if kw:
            assert stats["spec_enabled"] and stats["spec_accept_ewma"] > 1.0
            assert speculative.HOST_READS["counts"] - reads == stats["decode_steps"] > 0


def test_greedy_streams_match_the_jax_spec_scheduler(weights, monkeypatch):  # noqa: F811
    """spec_k=2, speculation kept on: the JAX scheduler's streams and
    counters (rounds, tokens, the EWMA of a round's tokens).

    The JAX scheduler passes ``jnp.asarray(self.slot_pos)`` to its
    speculative chunk and advances ``slot_pos`` in place right after; on the
    CPU ``jnp.asarray`` may alias an aligned numpy buffer, so the chunk, run
    asynchronously, can read the advanced positions (its plain chunk passes a
    copy).  Here its chunk waits for its results before it returns."""
    calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    jw, pw, _ = weights
    kw = dict(spec_k=2, spec_min_accept=0.0)
    jax_engine = JaxEngine(config=JCONFIG, weights=jw, cache_dtype=jnp.bfloat16, **COMMON, **kw)
    chunk = jax_engine._decode_spec_paged
    jax_engine._decode_spec_paged = lambda *a: jax.block_until_ready(chunk(*a))
    _, ref_stats = _drive(jax_engine, SCHEDULE, JaxRequest)
    engine, _, stats = _run(pw, **kw)
    assert calls["fused"]
    _match(jax_engine.completed, engine.completed, pw, _prompts(SCHEDULE))
    assert stats == ref_stats
    assert ref_stats["spec_enabled"] and ref_stats["spec_accept_ewma"] > 1.0


def test_mixed_greedy_and_sampled_batch(weights):  # noqa: F811
    """A sampled request rides the rounds beside greedy ones: every budget
    met, the greedy streams the plain engine's, the whole run repeatable per
    seed."""
    pw = weights[1]
    schedule = {0: [(0, [3, 4, 3, 4], 8, 0.0, 100), (1, [4, 5, 6], 6, 0.9, 7), (2, [33, 33, 33], 7, 0.0, 102)]}
    runs = [_run(pw, schedule, spec_k=2, spec_min_accept=0.0)[1] for _ in range(2)]
    assert runs[0] == runs[1]
    assert {rid: len(t) for rid, (t, _) in runs[0].items()} == {0: 8, 1: 6, 2: 7}
    plain = _run(pw, schedule)[1]
    assert {r: runs[0][r] for r in (0, 2)} == {r: plain[r] for r in (0, 2)}


def test_adaptive_disable_falls_back_to_plain(weights):  # noqa: F811
    engine, streams, stats = _run(weights[1], spec_k=2, spec_min_accept=10.0, spec_probe_chunks=10_000)
    assert {rid: len(t) for rid, (t, _) in streams.items()} == BUDGETS
    assert stats["spec_enabled"] is False
    assert stats["spec_accept_ewma"] is not None and stats["spec_accept_ewma"] < 10.0
    assert streams == _run(weights[1])[1]


def test_adaptive_probe_reenables(weights, monkeypatch):  # noqa: F811
    """A probe interval of one chunk: disable, probe, disable again; every
    budget met, the plain streams, pages released."""
    enabled = []
    real = ContinuousBatchingEngine._count_plain_chunk

    def counted(self):
        real(self)
        enabled.append(self._spec_enabled)

    monkeypatch.setattr(ContinuousBatchingEngine, "_count_plain_chunk", counted)
    long = {0: [(0, [3, 4, 3, 4, 3], 40, 0.0, 100), (1, [40, 50, 60, 70, 80], 30, 0.0, 101)]}
    engine, streams, stats = _run(weights[1], long, spec_k=2, spec_min_accept=10.0, spec_probe_chunks=1)
    assert {rid: len(t) for rid, (t, _) in streams.items()} == {0: 40, 1: 30}
    assert stats["spec_accept_ewma"] is not None and True in enabled
    assert streams == _run(weights[1], long)[1]


def test_probe_gate_detector(weights):  # noqa: F811
    """``_traffic_repetitive``: whether some live stream's recent window
    repeats a bigram (the JAX package's cases)."""
    engine = _engine(weights[1], spec_k=2)

    def req(tokens, gen=()):
        r = Request(request_id=0, prompt_tokens=list(tokens))
        r.generated = list(gen)
        return r

    engine.slot_request = [None, None, None]
    assert not engine._traffic_repetitive()
    engine.slot_request = [req([1, 2, 3, 4, 5]), None, req([9, 8, 7])]
    assert not engine._traffic_repetitive()
    engine.slot_request = [req([1, 2, 3, 4, 5]), req([5, 6, 5, 6]), None]
    assert engine._traffic_repetitive()
    engine.slot_request = [req([1, 2, 3], gen=[4, 1, 2]), None, None]
    assert engine._traffic_repetitive()
    w = engine._SPEC_GATE_WINDOW
    engine.slot_request = [req([7, 7, 7] + list(range(100, 100 + w))), None, None]
    assert not engine._traffic_repetitive()


def test_probe_gate_holds_on_nonrepetitive_traffic(weights):  # noqa: F811
    schedule = {0: [(0, [5, 6, 7], 12, 0.0, 100), (1, [14, 15, 16, 17], 10, 0.0, 101)]}
    engine, streams, stats = _run(weights[1], schedule, spec_k=2, spec_min_accept=10.0, spec_probe_chunks=1)
    assert {rid: len(t) for rid, (t, _) in streams.items()} == {0: 12, 1: 10}
    assert stats["spec_probes_gated"] >= 0 and "spec_enabled" in stats


def test_adaptive_keeps_spec_on_high_acceptance(weights):  # noqa: F811
    """Prompts that are cycles of the model's own greedy output draft well:
    with the default threshold (1.35 tokens a round) speculation stays on."""
    pw = weights[1]
    seeds = _run(pw, {0: [(0, [3, 4, 3, 4], 24, 0.0, 100), (1, [9, 11, 9, 11], 24, 0.0, 101)]})[1]
    schedule = {0: [(i, [3, 4, 3, 4] + seeds[i][0][:16], 24, 0.0, 100 + i) for i in range(2)]}
    _, streams, stats = _run(pw, schedule, spec_k=2)
    assert {rid: len(t) for rid, (t, _) in streams.items()} == {0: 24, 1: 24}
    assert stats["spec_accept_ewma"] >= 1.35 and stats["spec_enabled"] is True
    assert streams == _run(pw, schedule)[1]


def test_composes_with_the_prefix_cache(weights):  # noqa: F811
    """Requests sharing two pages of prompt: the plain, uncached streams;
    the prefix hits; the adopted prefix draftable (the history of each hit
    seeded from its whole prompt and first token)."""
    pw = weights[1]
    base = [3, 1, 4, 1, 5, 9, 2, 6] * 4  # 32 tokens: two pages
    schedule = {i * 12: [(i, base + [10 + i], 6, 0.0, 100 + i)] for i in range(3)}
    want = _run(pw, schedule, n_slots=1)[1]
    drafts = []
    real = speculative.ngram_draft_batched

    def spy(hist, hlen, cur, k):
        drafts.append((hist[0].clone(), int(hlen[0]), int(cur[0])))
        return real(hist, hlen, cur, k)

    speculative.ngram_draft_batched = spy
    try:
        engine, got, stats = _run(pw, schedule, n_slots=1, spec_k=2, spec_min_accept=0.0, prefix_cache=True)
    finally:
        speculative.ngram_draft_batched = real
    assert got == want
    assert stats["prefix_hits"] == 2 and stats["prefix_rows_reused"] == 2 * 2 * PAGE
    firsts = [engine.completed[i].generated[0] for i in range(3)]
    for i in range(3):
        seeded = base + [10 + i, firsts[i]]
        assert any(n == len(seeded) and c == firsts[i] and h[:n].tolist() == seeded for h, n, c in drafts), i


def test_composes_with_chunked_prefill(weights):  # noqa: F811
    pw = weights[1]
    rng = np.random.default_rng(3)
    schedule = {0: [(i, [int(t) for t in rng.integers(3, 60, n)], 6, 0.0, 100 + i) for i, n in enumerate((20, 33, 41))]}
    want = _run(pw, schedule)[1]
    engine, got, stats = _run(pw, schedule, spec_k=2, prefill_chunk=8)
    assert got == want and stats["prefill_waves"] >= 3


def test_spec_requires_paged_device(weights):  # noqa: F811
    for kw in (dict(kv_layout="dense", sampling="device"), dict(kv_layout="paged", sampling="host")):
        for cls, w, cfg in ((ContinuousBatchingEngine, weights[1], CONFIG), (JaxEngine, weights[0], JCONFIG)):
            extra = {"device": "cpu"} if cls is ContinuousBatchingEngine else {}
            want = 'speculative serving requires kv_layout="paged" and sampling="device"'
            with pytest.raises(ValueError, match=want):
                cls(config=cfg, weights=w, spec_k=2, **kw, **extra)


def test_spec_warmup_then_run(weights):  # noqa: F811
    engine = _engine(weights[1], spec_k=2, n_slots=2)
    engine.warmup()
    engine.submit(Request(request_id=0, prompt_tokens=[1, 2, 1, 2], max_new_tokens=5))
    assert len(engine.run()[0].generated) == 5
    assert engine.allocator.free_pages == engine.allocator.n_pages - 1


def test_spec_under_tp_matches_tp1(weights):  # noqa: F811
    """spec_k=2 on 2 ranks: every rank makes the same acceptance decisions
    from the same all-gathered logits, so the streams and counters are the
    tp=1 engine's."""
    pw = weights[1]
    kw = {**COMMON, "spec_k": 2, "spec_min_accept": 0.0, "cache_dtype": torch.bfloat16}
    one, _, one_stats = _run(pw, spec_k=2, spec_min_accept=0.0)
    engine = start_tp_engine(functools.partial(model, CONFIG, pw), ["cpu", "cpu"], **kw)
    try:
        streams, stats = _drive(engine, SCHEDULE, Request)
        reports = engine.rank_reports()
    finally:
        engine.close()
    _match(one.completed, engine.completed, pw, _prompts(SCHEDULE))
    assert stats == one_stats and stats["spec_enabled"] and stats["spec_accept_ewma"] > 1.0
    assert reports[0]["streams"] == reports[1]["streams"] == {rid: t for rid, (t, _) in streams.items()}


def test_cli_batch_spec_prints_the_plain_completions(exported, tmp_path, capsys):  # noqa: F811
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello world\nab ab ab ab\nthe cat\n")
    argv = ["batch", str(exported / "m.qtpu"), "-f", str(prompts), "-n", "10", "--kv", "paged", "--no-warmup",
            "--device", "cpu"]
    outs = []
    for extra in ([], ["--spec", "2"], ["--spec", "3"]):
        assert port_main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0].count("\n") == 3 and outs[1] == outs[0] and outs[2] == outs[0]


def test_cli_serve_spec_reports_the_policy_in_stats(exported, monkeypatch):  # noqa: F811
    """``serve --spec 2 --spec-min-accept 2.5``: the engine takes both, a
    completion comes back over HTTP, and ``/v1/stats`` passes the policy's
    keys through."""
    import json
    import threading
    import urllib.request

    import qwen3_rs_tpu_torch.serving.server as server_mod
    from test_torch_server import _post

    real_serve, box = server_mod.serve, {}

    def serve_once(frontend, host, port):
        box["engine"] = frontend.engine

        def ready(httpd):
            def ask():
                try:
                    port = httpd.server_address[1]
                    ask = {"prompt": "ab ab ab", "max_tokens": 6}
                    box["body"] = json.loads(_post(port, "/v1/completions", ask).read())
                    stats = urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=60)
                    box["stats"] = json.loads(stats.read())
                finally:
                    httpd.shutdown()

            threading.Thread(target=ask, daemon=True).start()

        real_serve(frontend, host, 0, ready=ready)

    monkeypatch.setattr(server_mod, "serve", serve_once)
    argv = ["serve", str(exported / "m.qtpu"), "--no-warmup", "--slots", "2", "--spec", "2", "--spec-min-accept", "2.5",
            "--device", "cpu"]
    assert port_main(argv) == 0
    engine = box["engine"]
    assert (engine.spec_k, engine.spec_min_accept, engine.kv_layout, engine.sampling) == (2, 2.5, "paged", "device")
    assert box["body"]["tokens"] > 0
    assert {"spec_enabled", "spec_accept_ewma", "spec_probes_gated"} <= set(box["stats"])
