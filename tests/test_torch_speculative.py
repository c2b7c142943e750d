"""N-gram speculative decoding: the port's ``inference/speculative.py``,
``Engine.decode_chunk_spec`` and ``generate(spec_k=)`` against the JAX
package's.

* ``ngram_draft`` and its batched form equal JAX's bit for bit: the JAX
  package's six drafting cases and 240 seeded random histories over a small
  alphabet (k 1..8, every ``hlen`` from 0 to T: histories shorter than two,
  starts clamped at T - k, histories full to T).
* ``spec_round`` and ``spec_round_batched`` against JAX's with the same
  mocked forward (one-hot logits from numpy, so every outcome is exact):
  tokens, counts, the next token, positions, histories and their lengths
  equal, for full, partial and zero acceptance, inactive slots, no draft
  match, a sampled slot, and rows at the history's end (the writes JAX
  drops).
* The sampled acceptance keeps plain sampling's law (the JAX package's
  joint-distribution test, 8192 independent rows of one round).
* ``decode_chunk_spec`` and ``generate(spec_k=)`` on the exported fixture of
  ``test_torch_generate.py`` (the kernels' plain versions): the ids and the
  printed text of the port's plain greedy loop, and of JAX's
  ``generate(spec_k=)`` through its interpret-mode kernels.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_generate import CONFIG as GEN_CONFIG
from test_torch_generate import exported  # noqa: F401
from torch_parity import route_jax_through_interpret_kernels

from qwen3_rs_tpu.inference import Engine as JaxEngine
from qwen3_rs_tpu.inference import Tokenizer as JaxTokenizer
from qwen3_rs_tpu.inference import TokenSampler as JaxTokenSampler
from qwen3_rs_tpu.inference import generate as jax_generate
from qwen3_rs_tpu.inference import speculative as jax_spec
from qwen3_rs_tpu_torch.inference import Engine, Tokenizer, TokenSampler, generate
from qwen3_rs_tpu_torch.inference import speculative

torch.set_num_threads(2)


def _hist(rows, t):
    h = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        h[i, : len(r)] = r
    return h


# --------------------------------------------------------------------- drafts
DRAFT_CASES = {
    "most_recent_bigram": ([7, 8, 1, 2, 3, 7, 8, 5, 6, 7, 7, 8], 8, 3, [5, 6, 7]),
    "no_match": ([1, 2, 3, 4], 4, 3, [-1, -1, -1]),
    "continuation_spans_to_current": ([3, 4, 9, 3, 4], 4, 3, [9, 3, 4]),
    "clipped_at_history_end": ([7, 4, 4, 4], 4, 3, [4, -1, -1]),
    "short_history": ([5], 5, 2, [-1, -1]),
    "prefers_full_window": ([9, 4, 4, 4, 4, 4, 4], 4, 3, [4, 4, 4]),
    "prefers_full_window_period_2": ([5, 6, 5, 6, 5, 6, 5, 6], 6, 3, [5, 6, 5]),
}


@pytest.mark.parametrize("case", list(DRAFT_CASES))
def test_ngram_draft_cases_match_jax(case):
    history, cur, k, want = DRAFT_CASES[case]
    h = _hist([history], 32)
    ref = np.asarray(jax_spec.ngram_draft(jnp.asarray(h[0]), jnp.int32(len(history)), jnp.int32(cur), k))
    single = speculative.ngram_draft(torch.as_tensor(h[0]), len(history), cur, k)
    batched = speculative.ngram_draft_batched(torch.as_tensor(h), torch.tensor([len(history)]), torch.tensor([cur]), k)
    assert ref.tolist() == want
    assert single.tolist() == want and batched[0].tolist() == want
    assert single.dtype == batched.dtype == torch.int32


@pytest.mark.parametrize("t", [12, 24])
def test_ngram_draft_random_histories_match_jax(t):
    """Seeded histories over 3 token values, so that bigrams repeat: every
    hlen from 0 to T and k from 1 to 8, each against JAX's vmapped drafter;
    the single form row by row too."""
    rng = np.random.default_rng(t)
    for k in range(1, 9):
        hlens = np.arange(t + 1)
        hlens = np.concatenate([hlens, rng.integers(0, t + 1, 15 - len(hlens) % 15)])
        hist = rng.integers(0, 3, (len(hlens), t)).astype(np.int32)
        cur = hist[np.arange(len(hlens)), np.clip(hlens - 1, 0, t - 1)]
        draft = jax.jit(jax.vmap(jax_spec.ngram_draft, in_axes=(0, 0, 0, None)), static_argnums=3)
        ref = np.asarray(draft(jnp.asarray(hist), jnp.asarray(hlens, jnp.int32), jnp.asarray(cur), k))
        got = speculative.ngram_draft_batched(torch.as_tensor(hist), torch.as_tensor(hlens), torch.as_tensor(cur), k)
        np.testing.assert_array_equal(got.numpy(), ref)
        for i in range(0, len(hlens), 5):
            single = speculative.ngram_draft(torch.as_tensor(hist[i]), int(hlens[i]), int(cur[i]), k)
            np.testing.assert_array_equal(single.numpy(), ref[i])
        assert (ref >= 0).any() and (ref < 0).any()


# ------------------------------------------------------------- mocked rounds
V, K = 16, 2


def _jax_batched(hist_rows, hlens, curs, temps, active, targets, pos, t, topp=0.5):
    targets = jnp.asarray(targets)

    def fake_fwd(weights, window, cache, pos, write_mask=None, page_table=None, return_all_logits=False):
        return jax.nn.one_hot(targets, V) * 10.0, cache

    b = len(curs)
    carry = (jnp.asarray(curs, jnp.int32), {"cache": 0}, jnp.asarray(pos, jnp.int32), jnp.asarray(_hist(hist_rows, t)),
             jnp.asarray(hlens, jnp.int32), jnp.asarray(temps, jnp.float32), jnp.full((b,), topp, jnp.float32),
             jax.random.PRNGKey(0))
    (cur, _, pos, hist, hlen, *_), (toks, counts) = jax.jit(
        lambda c, a: jax_spec.spec_round_batched(fake_fwd, None, c, K, None, a))(carry, jnp.asarray(active))
    return [np.asarray(a) for a in (toks, counts, cur, pos, hist, hlen)]


def _port_batched(hist_rows, hlens, curs, temps, active, targets, pos, t, topp=0.5):
    seen = {}

    def fwd(window, cache, pos, **kw):
        seen.update(kw, window=window.clone(), pos=np.array(pos))
        return torch.nn.functional.one_hot(torch.as_tensor(targets), V).float() * 10.0, cache

    b = len(curs)
    gen = torch.Generator()
    gen.manual_seed(0)
    carry = (torch.tensor(curs, dtype=torch.int32), "cache", np.asarray(pos), torch.as_tensor(_hist(hist_rows, t)),
             torch.tensor(hlens, dtype=torch.int32), np.asarray(temps, np.float32), np.full(b, topp, np.float32), gen)
    reads = speculative.HOST_READS["counts"]
    (cur, cache, pos, hist, hlen, *_), (toks, counts) = speculative.spec_round_batched(fwd, carry, K, "table", active)
    assert cache == "cache" and seen["page_table"] == "table" and seen["return_all_logits"]
    assert seen["write_mask"].tolist() == list(active) and seen["window"].shape == (b, K + 1)
    assert speculative.HOST_READS["counts"] == reads + 1 and isinstance(counts, np.ndarray)
    return [toks.numpy(), counts, cur.numpy(), pos, hist.numpy(), hlen.numpy()]


ROUNDS = {
    # slot 0: draft [3, 1] fully accepted; slot 1: draft [6, 4] rejected at
    # once; slot 2 (sampled, deterministic under top-p 0.5): draft [7, 8]
    # against 8; slot 3 inactive.
    "full_zero_sampled_inactive": dict(
        hist_rows=[[1, 2, 3, 1, 2], [4, 5, 6, 4, 5], [7, 8, 7, 8], [0]], hlens=[5, 5, 4, 1], curs=[2, 5, 8, 0],
        temps=[0.0, 0.0, 1.0, 0.0], active=[True, True, True, False],
        targets=[[3, 1, 7], [9, 6, 6], [8, 2, 2], [5, 5, 5]], pos=[10, 20, 30, 0], t=12),
    "partial": dict(hist_rows=[[1, 2, 3, 1, 2]], hlens=[5], curs=[2], temps=[0.0], active=[True],
                    targets=[[3, 9, 4]], pos=[7], t=12),
    "no_draft_match": dict(hist_rows=[[1, 2, 3, 4]], hlens=[4], curs=[4], temps=[0.0], active=[True],
                           targets=[[6, 6, 6]], pos=[4], t=12),
    "sampled_accepts": dict(hist_rows=[[7, 8, 7, 8]], hlens=[4], curs=[8], temps=[1.0], active=[True],
                            targets=[[7, 8, 5]], pos=[30], t=12),
    # Histories full or one short of T: the accepted tokens' writes past T
    # are dropped, the last history row kept.
    "history_end": dict(
        hist_rows=[[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 5, 6, 5, 6, 5], [1, 2, 3, 1, 2, 3, 1, 2]], hlens=[8, 7, 8],
        curs=[2, 5, 2], temps=[0.0, 0.0, 0.0], active=[True, True, False],
        targets=[[3, 1, 9], [6, 5, 4], [3, 1, 9]], pos=[40, 41, 42], t=8),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_spec_round_batched_matches_jax(case):
    kw = ROUNDS[case]
    ref = _jax_batched(**kw)
    got = _port_batched(**kw)
    for name, a, b in zip(("toks", "counts", "cur", "pos", "hist", "hlen"), got, ref):
        if name == "toks":  # inactive slots' rows are not emitted
            a, b = a[np.asarray(kw["active"])], b[np.asarray(kw["active"])]
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case == "history_end":
        assert ref[1].tolist() == [3, 3, 0] and ref[5].tolist() == [11, 10, 8]
        assert ref[4][0].tolist() == [1, 2, 3, 1, 2, 3, 1, 2] and ref[4][1, 7] == 6


SINGLE = {
    "full": ([1, 2, 3, 1, 2], 2, [3, 1, 7], 12),
    "partial": ([1, 2, 3, 1, 2], 2, [3, 9, 4], 12),
    "none": ([1, 2, 3, 4], 4, [6, 6, 6], 12),
    "history_end": ([1, 2, 3, 1, 2, 3, 1, 2], 2, [3, 1, 9], 8),
    # a tie on the verify rows: the last maximum, as the host sampler
    "tie": ([1, 2, 3, 1, 2], 2, None, 12),
}


@pytest.mark.parametrize("case", list(SINGLE))
def test_spec_round_matches_jax(case):
    history, cur, targets, t = SINGLE[case]
    logits = np.zeros((1, K + 1, V), np.float32)
    if targets is None:
        logits[0, :, 3] = logits[0, :, 1] = logits[0, :, 12] = 4.0
    else:
        logits[0, np.arange(K + 1), targets] = 10.0

    def jfwd(weights, window, cache, pos, return_all_logits=False):
        return jnp.asarray(logits), cache

    h = _hist([history], t)[0]
    carry = (jnp.asarray([cur], jnp.int32), None, jnp.asarray([5], jnp.int32), jnp.asarray(h),
             jnp.int32(len(history)))
    (jcur, _, jpos, jhist, jhlen), (jpreds, jcount) = jax_spec.spec_round(jfwd, None, carry, K)

    def fwd(window, cache, pos, **kw):
        assert kw == {"return_all_logits": True} and window.shape == (1, K + 1)
        return torch.as_tensor(logits), cache

    carry = (torch.tensor([cur], dtype=torch.int32), None, np.asarray([5]), torch.as_tensor(h),
             torch.tensor(len(history), dtype=torch.int32))
    (pcur, _, ppos, phist, phlen), (ppreds, pcount) = speculative.spec_round(fwd, carry, K)
    assert pcount == int(jcount) and ppos.tolist() == np.asarray(jpos).tolist()
    np.testing.assert_array_equal(ppreds.numpy(), np.asarray(jpreds))
    np.testing.assert_array_equal(pcur.numpy(), np.asarray(jcur))
    np.testing.assert_array_equal(phist.numpy(), np.asarray(jhist))
    assert int(phlen) == int(jhlen)


def test_stochastic_acceptance_keeps_the_sampling_law():
    """temperature 1, top-p outside (0, 1): the first emitted token follows
    p0, a draft is accepted with p0(draft), and after an acceptance the next
    token follows p1 conditioned on the draft (8192 rows, 4 sigma)."""
    v, k, d, n = 4, 1, 1, 8192
    p0_logits = torch.tensor([0.3, 0.9, -0.2, 0.1])
    p1_matrix = torch.tensor([[0.0, 0.5, 1.0, -0.5], [1.2, -0.3, 0.4, 0.0],
                              [-1.0, 0.2, 0.2, 0.6], [0.5, 0.5, -0.8, 0.3]])

    def fwd(window, cache, pos, **kw):
        l0 = p0_logits.expand(window.shape[0], v)
        return torch.stack([l0, p1_matrix[window[:, 1].long()]], dim=1), cache

    gen = torch.Generator()
    gen.manual_seed(7)
    hist = torch.tensor([[1, 2, 1, 2, 0, 0, 0, 0]], dtype=torch.int32).repeat(n, 1)
    carry = (torch.full((n,), 2, dtype=torch.int32), None, np.zeros(n, np.int64), hist,
             torch.full((n,), 4, dtype=torch.int32), np.ones(n, np.float32), np.full(n, 2.0, np.float32), gen)
    _, (toks, counts) = speculative.spec_round_batched(fwd, carry, k, None, np.ones(n, bool))
    toks = toks.numpy()
    p0 = torch.softmax(p0_logits, 0).numpy()
    p1_d = torch.softmax(p1_matrix[d], 0).numpy()

    def close(f, p, m):
        return abs(f - p) < 4.0 * np.sqrt(p * (1 - p) / max(m, 1)) + 1e-3

    for x in range(v):
        assert close(np.mean(toks[:, 0] == x), p0[x], n), x
    acc = counts == 2
    assert close(np.mean(acc), p0[d], n)
    sel = toks[acc, 1]
    for y in range(v):
        assert close(np.mean(sel == y), p1_d[y], len(sel)), y


# ------------------------------------------------------------ the engine
@pytest.fixture(scope="module")
def engine(exported):  # noqa: F811
    return Engine(exported / "m.qtpu", device="cpu")


def _first(engine, prompt):
    cache = engine.new_cache(1)
    logits, cache = engine.prefill(cache, np.asarray([prompt]), np.zeros(1, np.int64))
    return int(logits[0].argmax()), cache


def _greedy(engine, prompt, n):
    cur, cache = _first(engine, prompt)
    toks, _ = engine.decode_chunk(cache, cur, len(prompt), n, temperature=0.0)
    return [cur] + [int(t) for t in toks]


def _spec(engine, prompt, n_rounds, k):
    cur, cache = _first(engine, prompt)
    toks, counts, _ = engine.decode_chunk_spec(cache, cur, len(prompt), n_rounds, k, np.asarray(prompt + [cur]))
    assert toks.shape == (n_rounds, k + 1) and counts.shape == (n_rounds,)
    return [cur] + [int(t) for r in range(n_rounds) for t in toks[r, : counts[r]]], counts


@pytest.mark.parametrize("k,prompt", [(2, [3, 5, 3, 5, 3, 7, 11, 2]), (4, [3, 5, 3, 5, 3, 7, 11, 2]),
                                      (4, [2, 9, 2, 9, 2, 9, 2, 9])])
def test_decode_chunk_spec_is_the_greedy_loop(engine, k, prompt):
    """Every round emits 1..k+1 tokens, the plain greedy chunk's; one count
    read a round."""
    reads = speculative.HOST_READS["counts"]
    spec, counts = _spec(engine, prompt, 8, k)
    assert speculative.HOST_READS["counts"] == reads + 8
    assert spec == _greedy(engine, prompt, len(spec) - 1)
    assert all(1 <= c <= k + 1 for c in counts.tolist())


def test_decode_chunk_spec_accepts_on_a_cycle(engine):
    """A prompt that is a cycle of the model's own greedy tokens: the drafts
    repeat it, and some round accepts."""
    seed = _greedy(engine, [2, 9, 2, 9], 24)
    prompt = [2, 9, 2, 9] + seed[:20]
    spec, counts = _spec(engine, prompt, 10, 4)
    assert spec == _greedy(engine, prompt, len(spec) - 1)
    assert max(counts.tolist()) > 1, counts.tolist()


def test_decode_chunk_spec_refuses_a_chunk_past_the_context(engine):
    cur, cache = _first(engine, [1, 2, 3])
    with pytest.raises(ValueError, match="do not fit the cache"):
        engine.decode_chunk_spec(cache, cur, 3, 32, 3, [1, 2, 3, cur])


def test_generate_spec_matches_the_greedy_loop_and_jax(exported, engine, monkeypatch):  # noqa: F811
    """``generate(spec_k=3)`` prints and returns the plain greedy device
    loop's ids and text (EOS, metrics and the UTF-8 stream included), and
    the JAX package's ``generate(spec_k=3)``."""
    tok = Tokenizer(exported / "m.qtpu", engine.config.vocab_size)
    prompt = "hello there"

    def run(spec_k):
        buf = io.StringIO()
        ids = generate(engine, tok, TokenSampler(0.0, 0.9, 1, device=True), prompt, out=buf, spec_k=spec_k)
        return ids, buf.getvalue()

    ref = run(0)
    got = run(3)
    assert len(ref[0]) > 20 and got == ref
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=GEN_CONFIG.seq_len)
    jengine = JaxEngine(exported / "m.qtpu", mode="fast")
    jtok = JaxTokenizer(exported / "m.qtpu", jengine.config.vocab_size)
    buf = io.StringIO()
    ids = jax_generate(jengine, jtok, JaxTokenSampler(0.0, 0.9, seed=1, device=True), prompt, out=buf, spec_k=3)
    assert (ids, buf.getvalue()) == got


def test_generate_spec_stops_at_max_tokens(engine, exported):  # noqa: F811
    tok = Tokenizer(exported / "m.qtpu", engine.config.vocab_size)
    sampler = lambda: TokenSampler(0.0, 0.9, 1, device=True)  # noqa: E731
    ref = generate(engine, tok, sampler(), "hello there", out=io.StringIO())
    for n in (1, 5, 13):
        assert generate(engine, tok, sampler(), "hello there", out=io.StringIO(), spec_k=3, max_tokens=n) == ref[:n]


def test_cli_spec_matches_jax_cli(exported, monkeypatch):  # noqa: F811
    """``inference -m generate -t 0 --spec 3``: the JAX CLI's text (the port
    turns device sampling on, as JAX does)."""
    from test_torch_generate import _stdout

    from qwen3_rs_tpu.cli import main as jax_main
    from qwen3_rs_tpu_torch.cli import main as port_main

    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=GEN_CONFIG.seq_len)
    argv = ["inference", str(exported / "m.qtpu"), "-m", "generate", "-i", "hello world", "-t", "0", "-s", "1"]
    want = _stdout(jax_main, [*argv, "--engine-mode", "fast", "--spec", "3"])
    got = _stdout(port_main, [*argv, "--device", "cpu", "--spec", "3"])
    assert len(want) > 40 and got == want == _stdout(port_main, [*argv, "--device", "cpu"])
