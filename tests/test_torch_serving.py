"""The continuous-batching engine: the port's ``ContinuousBatchingEngine``
against the JAX package's with host sampling, on the same weights and the
same schedule of submissions, in each configuration: dense and paged
layouts, bf16, f32 and INT8 pools, greedy and ``-t 0.8`` requests, the prefix
cache, chunked prefill, the admission cap, a run to the context end,
backpressure on a small pool.

Two checks per configuration, at pages of 128 rows:

* **The engines, stream for stream.**  The port's engine runs with its own
  forward (the kernels' plain versions on the CPU), the JAX engine through
  its Pallas kernels in interpret mode (``torch_parity``), as the JAX
  package's own parity tests run it.  Every request must get the same token
  stream and finish reason, ``stats()`` the same counters (timings
  excepted), and the pool the same rows within 2e-2 of their largest
  magnitude: the forwards agree to f32 rounding but for an occasional
  flipped bf16 rounding of the residual stream (``test_torch_model.py``),
  which moves one row's logits by ~0.5%.  A stream parts where such a flip
  meets a near-tie of the sampler; the fixture's peaked logits make that
  rare, and these schedules meet none (the mixed case's prompts from seed 3
  did, at the 6th token of a ``-t 0.8`` request).  Should one part all the
  same, the check takes it only at a token where both engines, on the same
  history, gave logits within the tolerance, and only once per
  configuration; the pool is then not compared.
* **The port's forward under the engine's calls.**  Every call the port's
  engine makes is held against the JAX forward (its XLA path) on the same
  state: logits and written K/V within 2e-2 of their largest magnitude.

The mid-prefill trap: a slot whose prompt is still being prefilled in chunks
holds pages (a prefix-cache hit included) but decodes with its write masked.
A decode step must leave every idle slot's pages, and the null page, bit for
bit unchanged.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, route_jax_through_interpret_kernels

import qwen3_rs_tpu.models.qwen3 as jax_qwen3
import qwen3_rs_tpu.serving.paged_cache as jax_paged
import qwen3_rs_tpu.serving.scheduler as jax_scheduler
import qwen3_rs_tpu_torch.serving.scheduler as port_scheduler
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.serving import ContinuousBatchingEngine as JaxEngine
from qwen3_rs_tpu.serving import Request as JaxRequest
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import weights_from_jax_numpy
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=128, seq_len=512, vocab_size=2176, group_size=64, shared_classifier=True,
)
JCONFIG = JaxConfig(**dataclasses.asdict(CONFIG))
PAGE = 128  # the JAX package's paged kernels take multiples of 128
BUCKETS = (8, 16, 32)
TOL = 2e-2  # of max |ref|: logits and K/V rows


@pytest.fixture(scope="module")
def weights():
    """(JAX weights, port weights, JAX weights with the fast engine's bf16
    scales): power-of-two scales, a final norm weight scaled by 20 for
    peaked next-token distributions."""
    tree = jax_numpy_weights(CONFIG, 21, fast_scales=False)  # the engines cast scales themselves
    tree = tree._replace(rms_final=tree.rms_final * 20.0)
    jw = jax.tree.map(jnp.asarray, tree)
    return jw, weights_from_jax_numpy(tree), jax_qwen3.cast_weight_scales(jw)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX engine through its Pallas kernels in interpret mode, and both
    engines' samplers keeping the logits of every token they draw."""
    for mod in (jax_scheduler, port_scheduler):
        monkeypatch.setattr(mod, "Sampler", _recording(mod.Sampler))
    return route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)


def _recording(sampler_cls):
    class Recording(sampler_cls):
        def sample(self, logits):
            self.__dict__.setdefault("seen", []).append(np.array(logits, np.float32))
            return super().sample(logits)

    return Recording


_JAX_CACHES = {"KVCache": jax_qwen3.KVCache, "QuantizedKVCache": jax_qwen3.QuantizedKVCache,
               "PagedKVCache": jax_paged.PagedKVCache, "QuantizedPagedKVCache": jax_paged.QuantizedPagedKVCache}


def _to_jax(cache):
    def arr(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())

    return _JAX_CACHES[type(cache).__name__](*(arr(t) for t in cache))


@functools.cache
def _jax_step():
    return jax.jit(functools.partial(jax_qwen3.qwen3_forward, JCONFIG), static_argnames=("mode", "fresh_prefill"))


def _jax_call(jweights, tokens, cache, pos, mode, out_idx=None, fresh_prefill=False, page_table=None,
              write_mask=None):
    """The JAX forward on the port's cache state: (logits, new cache) as numpy."""
    opt = lambda a, dt: None if a is None else jnp.asarray(np.asarray(a), dt)
    logits, new = _jax_step()(
        jweights, jnp.asarray(np.asarray(tokens), jnp.int32), _to_jax(cache), jnp.asarray(np.asarray(pos), jnp.int32),
        mode=mode, fresh_prefill=fresh_prefill, out_idx=opt(out_idx, jnp.int32),
        page_table=opt(page_table, jnp.int32), write_mask=opt(write_mask, bool),
    )
    return np.asarray(logits), [np.asarray(a) for a in new]


def _rows_f32(cache):
    """Cache rows as f32 (INT8 codes times their row scales)."""
    parts = [t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32) for t in cache]
    return parts[:2] if len(parts) == 2 else [parts[0] * parts[2][..., None], parts[1] * parts[3][..., None]]


def _close(got, ref):
    return float(np.abs(got - ref).max()) <= TOL * max(float(np.abs(ref).max()), 1e-6)


def _checked_forward(jweights, calls):
    """The port's own forward, each call held against the JAX forward on the
    same state (the null page aside: padding rows write it in any order)."""
    port_forward = port_scheduler.qwen3_forward

    def forward(config, weights, tokens, cache, pos, *, mode, tp_group=None, **kw):
        assert tp_group is None  # one rank: the forward the JAX call is held against
        ref_logits, ref_cache = _jax_call(jweights, tokens, cache, pos, mode, **kw)
        logits, cache = port_forward(config, weights, tokens, cache, pos, mode=mode, **kw)
        assert logits.shape == ref_logits.shape
        assert _close(logits.numpy(), ref_logits)
        skip = 1 if kw.get("page_table") is not None else 0
        for got, ref in zip(_rows_f32(cache), _rows_f32(ref_cache)):
            assert _close(got[:, skip:], ref[:, skip:])
        calls.append(np.asarray(tokens).shape)
        return logits, cache

    return forward


def _prompts(seed, lens, stem=()):
    rng = np.random.default_rng(seed)
    return [list(stem) + [int(t) for t in rng.integers(3, CONFIG.vocab_size, n)] for n in lens]


def _schedule(prompts, max_new=6, temps=(0.0,), at=None):
    """{step: [(id, prompt, max_new, temperature, seed)]}: every request at
    step 0 unless ``at`` gives each one's submission step."""
    out = {}
    for i, p in enumerate(prompts):
        out.setdefault(0 if at is None else at[i], []).append((i, p, max_new, temps[i % len(temps)], 100 + i))
    return out


def _drive(engine, schedule, request_cls, on_step=None):
    step = 0
    while True:
        for rid, prompt, max_new, temp, seed in schedule.get(step, []):
            engine.submit(request_cls(request_id=rid, prompt_tokens=list(prompt), max_new_tokens=max_new,
                                      temperature=temp, seed=seed, eos_token_ids=(1,)))
        if not engine.has_work and step >= max(schedule):
            break
        if on_step is not None:
            on_step(engine)
        engine.step()
        step += 1
    streams = {r.request_id: (r.generated, r.finish_reason) for r in engine.completed}
    stats = {k: v for k, v in engine.stats().items() if k != "p50_ttft"}
    return streams, stats


def _engines(weights, n_slots=4, cache="bf16", **kw):
    """(JAX engine, port engine) of one configuration."""
    jw, pw, _ = weights
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": "int8"}[cache]
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32, "int8": "int8"}[cache]
    common = dict(n_slots=n_slots, mode="fast", prefill_buckets=BUCKETS, **kw)
    return (JaxEngine(config=JCONFIG, weights=jw, cache_dtype=jdt, **common),
            ContinuousBatchingEngine(config=CONFIG, weights=pw, cache_dtype=tdt, device="cpu", **common))


def _match_streams(jax_engine, engine) -> list:
    """Every request's stream and finish reason equal to the JAX engine's, or
    parted once at a near-tie: at the first token that differs, both engines
    drew from logits within the tolerance (the same history on both sides).
    Returns the partings as (request id, token index)."""
    ref = {r.request_id: r for r in jax_engine.completed}
    got = {r.request_id: r for r in engine.completed}
    assert got.keys() == ref.keys()
    parted = []
    for rid, r in ref.items():
        g = got[rid]
        if (g.generated, g.finish_reason) == (r.generated, r.finish_reason):
            continue
        diff = [i for i, (a, b) in enumerate(zip(r.generated, g.generated)) if a != b]
        assert diff, f"request {rid}: {g.generated} {g.finish_reason} against {r.generated} {r.finish_reason}"
        i = diff[0]
        lj, lp = r._sampler.seen[i], g._sampler.seen[i]
        err = float(np.abs(lp - lj).max())
        assert err <= TOL * float(np.abs(lj).max()), f"request {rid} parts at token {i}, logits {err} apart"
        parted.append((rid, i))
    assert len(parted) <= 1, f"streams part at {parted}"
    return parted


def _pools_close(jax_engine, engine):
    """The pool's pages (the null page aside) or the dense slots, row for row
    within the tolerance."""
    skip = 1 if engine.allocator is not None else 0
    for got, ref in zip(_rows_f32(engine.cache), _rows_f32(jax_engine.cache)):
        assert _close(got[:, skip:], ref[:, skip:])


STEM = _prompts(99, [PAGE])[0]  # a one-page prefix several prompts share
PAGED = dict(kv_layout="paged", page_size=PAGE)
CASES = {
    "dense-greedy": (dict(kv_layout="dense"), _schedule(_prompts(1, [5, 17, 3, 30, 9, 12]))),
    "dense-t0.8": (dict(kv_layout="dense"), _schedule(_prompts(2, [7, 20, 4, 11]), temps=(0.8,))),
    "paged-bf16-mixed": (PAGED, _schedule(_prompts(31, [5, 170, 3, 30, 140, 12, 260]), temps=(0.0, 0.8))),
    "paged-int8": (dict(PAGED, cache="int8"), _schedule(_prompts(4, [6, 200, 3, 14, 33]), temps=(0.0, 0.8))),
    "paged-f32-admission-cap": (dict(PAGED, cache="f32", max_admissions_per_step=1),
                                _schedule(_prompts(5, [4, 6, 9, 3, 130, 8]))),
    "prefix-cache": (dict(PAGED, prefix_cache=True),
                     _schedule(_prompts(6, [3, 5, 9, 2, 17], stem=STEM), at=[0, 1, 1, 2, 2])),
    "prefix-cache-int8": (dict(PAGED, prefix_cache=True, cache="int8"),
                          _schedule(_prompts(7, [4, 8, 11], stem=STEM), temps=(0.8, 0.0), at=[0, 1, 1])),
    "chunked-prefill": (dict(PAGED, prefill_chunk=64),
                        _schedule(_prompts(8, [300, 5, 150, 8, 3]), temps=(0.0, 0.8))),
    "context-end": (PAGED, _schedule(_prompts(9, [470, 490, 20]), max_new=40)),
    "context-end-dense": (dict(kv_layout="dense"), _schedule(_prompts(9, [470, 500]), max_new=40)),
    "backpressure": (dict(PAGED, n_pages=4), _schedule(_prompts(10, [200, 100, 250, 5]), max_new=10)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(weights, case, jax_kernels):
    """The port's engine with its own forward against the JAX engine through
    its interpret-mode kernels: the same streams and counters, the pool's
    rows within the tolerance."""
    kw, schedule = CASES[case]
    jax_engine, engine = _engines(weights, **kw)
    _, ref_stats = _drive(jax_engine, schedule, JaxRequest)
    streams, stats = _drive(engine, schedule, Request)
    assert stats == ref_stats
    if not _match_streams(jax_engine, engine):
        _pools_close(jax_engine, engine)
    assert len(streams) == sum(len(v) for v in schedule.values())
    assert jax_kernels["fused"] and (jax_kernels["paged"] or kw["kv_layout"] == "dense")
    if case.startswith("context-end"):
        assert {reason for _, reason in streams.values()} == {"length"}
        assert any(len(toks) < 40 for toks, _ in streams.values())
    if case.startswith("prefix-cache"):
        assert stats["prefix_hits"] > 0
    if case == "chunked-prefill":
        assert stats["prefill_waves"] > 0
    if case == "backpressure":
        assert stats["decode_steps"] > 10  # requests waited for pages
    if engine.allocator is not None:
        assert stats["kv_pages_free"] == stats["kv_pages_total"]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_forward_matches_jax(weights, case, monkeypatch):
    """The port's own forward on every call the engine makes: within 2e-2 of
    the JAX forward on the same state; every request completes."""
    kw, schedule = CASES[case]
    _, engine = _engines(weights, **kw)
    calls = []
    monkeypatch.setattr(port_scheduler, "qwen3_forward", _checked_forward(weights[2], calls))
    streams, stats = _drive(engine, schedule, Request)
    assert len(streams) == sum(len(v) for v in schedule.values()) == stats["completed"]
    assert all(reason in ("length", "stop") for _, reason in streams.values())
    assert len(calls) > stats["decode_steps"]


def test_mid_prefill_slot_keeps_its_pages_while_others_decode(weights, jax_kernels):
    """A prefix-cache hit whose suffix prefills in chunks while two other
    requests decode: every decode step of the port's engine leaves the idle
    slots' pages, the partial's adopted and private pages included, and the
    null page untouched; the streams equal the JAX engine's."""
    # The first request prefills the shared stem in chunks and registers its
    # pages; the second decodes from step 0; the third adopts the stem at
    # step 4 and prefills its 150-row suffix in chunks while both decode.
    prompts = [STEM + _prompts(11, [4])[0], _prompts(12, [5])[0], STEM + _prompts(13, [150])[0]]
    schedule = _schedule(prompts, max_new=12, at=[0, 0, 4])
    kw = dict(PAGED, prefix_cache=True, prefill_chunk=64, n_slots=3)
    jax_engine, engine = _engines(weights, **kw)
    checked = []
    decode = engine._decode

    def guarded_decode(active):
        idle = [s for s in range(engine.n_slots) if not active[s]]
        pages = sorted({0} | {int(p) for s in idle for p in engine.allocator.tables[s, : engine.allocator.used[s]]})
        before = [t[:, pages].clone() for t in engine.cache]
        out = decode(active)
        for b, t in zip(before, engine.cache):
            assert torch.equal(b, t[:, pages]), f"decode step wrote into idle pages {pages}"
        checked.append((len(pages), len(engine._partials)))
        return out

    engine._decode = guarded_decode
    streams, stats = _drive(engine, schedule, Request)
    assert len(streams) == 3
    # The trap was exercised: steps decoded while a partial held pages.
    assert any(n_partials and n_pages > 1 for n_pages, n_partials in checked)
    assert stats["prefix_hits"] >= 1 and stats["prefill_waves"] > 1
    assert stats == _drive(jax_engine, schedule, JaxRequest)[1]
    if not _match_streams(jax_engine, engine):
        _pools_close(jax_engine, engine)


def test_pool_too_small_raises_like_jax(weights):
    schedule = _schedule(_prompts(13, [300]), max_new=150)  # 4 pages; the pool has 3 and the null page
    kw = dict(PAGED, n_pages=4)
    jw, pw, _ = weights
    with pytest.raises(RuntimeError, match="needs more KV pages than the pool holds") as ref:
        _drive(JaxEngine(config=JaxConfig(**dataclasses.asdict(CONFIG)), weights=jw, **kw), schedule, JaxRequest)
    with pytest.raises(RuntimeError, match="needs more KV pages than the pool holds") as got:
        _drive(ContinuousBatchingEngine(config=CONFIG, weights=pw, device="cpu", **kw), schedule, Request)
    assert str(got.value) == str(ref.value)


def test_warmup_writes_nothing_live(weights):
    """warmup() on an engine with requests in flight: the pool's live pages
    and the streams are unchanged."""
    pw = weights[1]
    schedule = _schedule(_prompts(14, [9, 21]), max_new=8)
    plain = _drive(ContinuousBatchingEngine(config=CONFIG, weights=pw, device="cpu", kv_layout="paged",
                                            page_size=PAGE, prefill_buckets=BUCKETS), schedule, Request)
    engine = ContinuousBatchingEngine(config=CONFIG, weights=pw, device="cpu", kv_layout="paged",
                                      page_size=PAGE, prefill_buckets=BUCKETS)
    state = {}

    def warm_midway(eng):
        if eng.active_count and not state:
            live = sorted({int(p) for p in eng.allocator.tables.ravel() if p})
            state["before"] = [t[:, live].clone() for t in eng.cache]
            eng.warmup()
            assert all(torch.equal(b, t[:, live]) for b, t in zip(state["before"], eng.cache))

    assert _drive(engine, schedule, Request, on_step=warm_midway) == plain and state


@pytest.mark.parametrize("kw", [dict(sampling="device"), dict(sampling="device", decode_chunk_steps=8)])
def test_device_sampling_options_run(weights, kw):
    """``sampling="device"`` (with the default 8-step chunks, or given
    explicitly) runs, with the host-sampling engine's greedy streams and
    counters of completed requests."""
    schedule = _schedule(_prompts(15, [4, 9, 3]), max_new=5)
    common = dict(config=CONFIG, weights=weights[1], device="cpu", n_slots=2, prefill_buckets=BUCKETS)
    engine = ContinuousBatchingEngine(**common, **kw)
    assert (engine.sampling, engine.decode_chunk_steps) == ("device", 8)
    streams, stats = _drive(engine, schedule, Request)
    want, want_stats = _drive(ContinuousBatchingEngine(**common), schedule, Request)
    assert streams == want and stats["completed"] == want_stats["completed"] == 3


@pytest.mark.parametrize("kw", [dict(spec_k=2, kv_layout="paged")])
def test_spec_options_raise_the_jax_error(weights, kw):
    """``spec_k`` with host sampling (the default): the JAX engine's error."""
    with pytest.raises(ValueError, match="speculative serving requires") as want:
        JaxEngine(config=JCONFIG, weights=weights[0], **kw)
    with pytest.raises(ValueError, match="speculative serving requires") as got:
        ContinuousBatchingEngine(config=CONFIG, weights=weights[1], device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_engine_defaults_to_the_card(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(config=CONFIG, weights=weights[1])


def test_layout_validation_matches_jax(weights):
    with pytest.raises(ValueError, match="INT8 KV cache requires"):
        ContinuousBatchingEngine(config=CONFIG, weights=weights[1], device="cpu", cache_dtype="int8")
    with pytest.raises(ValueError, match="prefix caching requires"):
        ContinuousBatchingEngine(config=CONFIG, weights=weights[1], device="cpu", prefix_cache=True)
    with pytest.raises(ValueError, match="chunked prefill requires"):
        ContinuousBatchingEngine(config=CONFIG, weights=weights[1], device="cpu", prefill_chunk=16)
