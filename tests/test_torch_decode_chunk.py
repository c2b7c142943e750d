"""The megakernel's path: the forward's routing, ``Engine.decode_chunk``,
device sampling, and the dense serving decode.

* ``qwen3_forward`` sends a fast-mode decode step through the decode
  megakernel on exactly the shapes the JAX package's gate admits, and matches
  the JAX forward routed through its interpret-mode megakernel (logits within
  ``2e-2 · max|logits|``, the bound of ``test_torch_model.py``: an f32 sum in
  another order can flip a bf16 rounding).
* ``Engine.decode_chunk`` at temperature 0 gives the JAX engine's
  ``decode_chunk`` tokens, and within the port exactly the host-greedy
  step-by-step stream.  The final norm weight is scaled by 20 so that the
  next-token distributions are peaked (no near-ties).
* ``sample_tokens``: temperature 0 is ``argmax_last_jax`` on logits with
  ties; at temperature > 0 a seed repeats its draws, every draw lies in the
  nucleus that the reference's rule keeps, and 20000 draws match the
  renormalised nucleus (chi-square below 50 at ≤ 15 degrees of freedom: far
  out in the tail of that distribution, which a wrong nucleus or temperature
  crosses by orders of magnitude).
* The dense serving decode takes the megakernel at these shapes, and an idle
  slot's rows stay as they were, bit for bit (``write_ok``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, route_jax_through_interpret_megakernel

import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.inference.engine import Engine as JaxEngine
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu.ops.sampling import argmax_last_jax
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.inference.engine import Engine, TokenSampler
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.sampling import NUCLEUS_TOPK, argmax_last, sample_tokens
from qwen3_rs_tpu_torch.serving import ContinuousBatchingEngine, Request

torch.set_num_threads(2)

# Passes the megakernel gate in both packages (dim 512: 8-group weight tiles).
CFG = ModelConfig(
    architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=128,
    seq_len=256, vocab_size=2048, group_size=64, shared_classifier=True,
)
# Fails it (dim 256), as the configurations of the other port tests do.
SMALL = dataclasses.replace(CFG, dim=256, hidden_dim=512, vocab_size=2176)


def _weights(cfg, seed, peaked=False):
    tree = jax_numpy_weights(cfg, seed)
    if peaked:
        tree = tree._replace(rms_final=tree.rms_final * 20.0)
    return JaxConfig(**dataclasses.asdict(cfg)), jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree)


@pytest.fixture
def spy(monkeypatch):
    """Counts the port forward's megakernel calls (launches are counted only
    on the card)."""
    calls = []
    real = port_qwen3.decode_stack_megakernel

    def counted(*args, **kw):
        calls.append(args[1].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(port_qwen3, "decode_stack_megakernel", counted)
    return calls


def _rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("cache_dtype", ["f32", "int8"])
def test_decode_steps_route_through_the_megakernel_and_match_jax(cache_dtype, spy, monkeypatch):
    """B = 2: a prefill window, then 3 decode steps; the classifier (2000
    columns, which the head gate refuses) runs after the kernel."""
    calls = route_jax_through_interpret_megakernel(monkeypatch, min_seq_len=128)
    cfg = dataclasses.replace(CFG, vocab_size=2000)
    jcfg, jw, pw = _weights(cfg, 21)
    jdt, tdt = (jnp.float32, torch.float32) if cache_dtype == "f32" else ("int8", "int8")
    jcache, pcache = jax_init_cache(jcfg, 2, dtype=jdt), init_kv_cache(cfg, 2, dtype=tdt, device="cpu")
    fwd = jax.jit(lambda w, t, c, p: jax_forward(jcfg, w, t, c, p, mode="fast"))
    rng = np.random.default_rng(21)
    tokens, pos = rng.integers(0, cfg.vocab_size, (2, 7)), np.zeros(2, np.int32)
    for step in range(4):
        jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos))
        pl_, pcache = qwen3_forward(cfg, pw, tokens, pcache, pos)
        assert _rel(pl_.numpy(), jl) <= 2e-2, step
        pos = pos + tokens.shape[1]
        tokens = np.asarray(jl).argmax(-1)[:, None]
    assert calls["mega"] == 1 and calls["fused"]  # traced once for S = 1
    assert spy == [2, 2, 2]  # every decode step, never the prefill window
    k_ref = np.asarray(jcache.k, np.float32)
    assert np.abs(pcache.k.float().numpy() - k_ref).max() <= (1 if cache_dtype == "int8" else 2e-2 * np.abs(k_ref).max())


def test_gate_refusals_keep_the_per_layer_path(spy):
    """Nine rows and the small configuration's widths take the per-layer
    path, as do the exact engine, windows and the page pool; a decode step
    of eight rows takes the kernel."""
    _, _, pw = _weights(CFG, 22)
    for b, taken in ((9, False), (8, True)):
        cache = init_kv_cache(CFG, b, device="cpu")
        qwen3_forward(CFG, pw, np.ones((b, 1), np.int64), cache, np.arange(b))
        assert bool(spy) == taken, b
        spy.clear()
    cache = init_kv_cache(CFG, 1, device="cpu")
    assert port_qwen3.megakernel_route(CFG, cache, 1, 1, "fast")
    assert not port_qwen3.megakernel_route(CFG, cache, 1, 1, "exact")
    assert not port_qwen3.megakernel_route(CFG, cache, 1, 2, "fast")
    assert not port_qwen3.megakernel_route(CFG, cache, 1, 1, "fast", paged=True)
    _, _, sw = _weights(SMALL, 22)
    qwen3_forward(SMALL, sw, np.ones((1, 1), np.int64), init_kv_cache(SMALL, 1, device="cpu"), [3])
    assert not spy


def test_greedy_head_is_the_first_max_on_both_paths(spy):
    _, _, pw = _weights(CFG, 23)
    for cfg, w in ((CFG, pw), (SMALL, _weights(SMALL, 23)[2])):
        cache = init_kv_cache(cfg, 2, device="cpu")
        logits, _ = qwen3_forward(cfg, w, [[5], [9]], init_kv_cache(cfg, 2, device="cpu"), [4, 4])
        tok, _ = qwen3_forward(cfg, w, [[5], [9]], cache, [4, 4], greedy_head=True)
        assert tok.dtype == torch.int32 and torch.equal(tok, logits.argmax(-1).to(torch.int32))
    assert spy == [2, 2]


def test_decode_chunk_matches_the_jax_engine(monkeypatch):
    calls = route_jax_through_interpret_megakernel(monkeypatch, min_seq_len=128)
    jcfg, jw, pw = _weights(CFG, 24, peaked=True)
    jeng = JaxEngine(config=jcfg, weights=jw)
    peng = Engine(config=CFG, weights=pw, device="cpu")
    prompt = np.random.default_rng(24).integers(0, CFG.vocab_size, (1, 12))
    jl, jcache = jeng.prefill(jeng.new_cache(1), prompt, np.zeros(1, np.int32))
    _, pcache = peng.prefill(peng.new_cache(1), prompt, np.zeros(1, np.int32))
    first = int(np.asarray(argmax_last_jax(jl))[0])
    want, _ = jeng.decode_chunk(jcache, first, 12, 10, temperature=0.0)
    got, _ = peng.decode_chunk(pcache, first, 12, 10, temperature=0.0)
    assert calls["mega"] >= 1
    assert got.tolist() == np.asarray(want).tolist()
    assert len(set(got.tolist())) > 1


@pytest.mark.parametrize("cfg", [CFG, SMALL], ids=["megakernel", "per-layer"])
def test_decode_chunk_is_the_host_greedy_stream(cfg):
    _, _, pw = _weights(cfg, 25, peaked=True)
    eng = Engine(config=cfg, weights=pw, device="cpu")
    prompt = np.random.default_rng(25).integers(0, cfg.vocab_size, (1, 9))
    logits, cache = eng.prefill(eng.new_cache(1), prompt, np.zeros(1, np.int32))
    first = int(argmax_last(logits)[0])
    chunk, _ = eng.decode_chunk(cache, first, 9, 8)
    _, cache = eng.prefill(eng.new_cache(1), prompt, np.zeros(1, np.int32))
    tok, host = first, []
    for i in range(8):
        logits, cache = eng.decode_step(cache, [tok], [9 + i])
        tok = int(argmax_last(logits)[0])
        host.append(tok)
    assert chunk.tolist() == host
    with pytest.raises(ValueError, match="does not fit"):
        eng.decode_chunk(cache, first, cfg.seq_len - 3, 4)


def test_sample_tokens_greedy_is_argmax_last_with_ties():
    rng = np.random.default_rng(26)
    logits = rng.integers(0, 4, (16, 700)).astype(np.float32)  # many ties at the top
    want = np.asarray(argmax_last_jax(jnp.asarray(logits)))
    gen = torch.Generator()
    got = sample_tokens(torch.from_numpy(logits), gen, 0.0, 0.9)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert (got.numpy() != logits.argmax(-1)).any()  # the first maximum would differ


def _nucleus(probs, topp):
    """The reference's kept set: descending probabilities while the mass
    before each is at most topp."""
    order = np.argsort(-probs, kind="stable")
    before = np.cumsum(probs[order]) - probs[order]
    return order[before <= topp]


@pytest.mark.parametrize("vocab", [300, 4000], ids=["sorted", "top256"])
def test_sample_tokens_draws_from_the_nucleus(vocab):
    assert 300 <= 2 * NUCLEUS_TOPK < 4000  # the two cases take the two branches
    rng = np.random.default_rng(vocab)
    base = rng.normal(0, 1, vocab).astype(np.float32)
    base[rng.choice(vocab, 12, replace=False)] = np.linspace(9.0, 10.0, 12, dtype=np.float32)
    t, topp, n = 0.8, 0.9, 20000
    logits = torch.from_numpy(np.tile(base, (n, 1)))

    def draw(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return sample_tokens(logits, gen, t, topp).numpy()

    a, b, c = draw(7), draw(7), draw(8)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    p = torch.softmax(torch.from_numpy(base) / t, -1).double().numpy()
    kept = _nucleus(p, topp)
    assert 3 <= len(kept) <= 16
    assert np.isin(a, kept).all()
    expect = p[kept] / p[kept].sum() * n
    counts = np.array([(a == k).sum() for k in kept])
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 50.0, chi2


def test_sample_tokens_full_distribution_and_per_row_parameters():
    rng = np.random.default_rng(27)
    logits = torch.from_numpy(rng.normal(0, 2, (4, 50)).astype(np.float32))
    gen = torch.Generator()
    gen.manual_seed(1)
    full = sample_tokens(logits, gen, 1.0, 1.0)  # topp outside (0, 1): the whole distribution
    assert full.shape == (4,) and full.dtype == torch.int32
    temp = torch.tensor([0.0, 0.7, 0.0, 1.3])
    topp = torch.tensor([0.9, 0.5, 2.0, 0.0])
    rows = sample_tokens(logits, gen, temp, topp)
    greedy = argmax_last(logits)
    assert rows[0] == greedy[0] and rows[2] == greedy[2]
    p1 = torch.softmax(logits[1] / 0.7, -1).double().numpy()
    assert int(rows[1]) in _nucleus(p1, 0.5).tolist()


def test_device_token_sampler_repeats_per_seed():
    logits = torch.from_numpy(np.random.default_rng(28).normal(0, 1, (1, 64)).astype(np.float32))

    def stream(seed, skip):
        s = TokenSampler(0.9, 0.95, seed, device=True)
        s.skip_draws(skip)
        gens = [s.next_generator("cpu") for _ in range(2)]
        return [s.sample(logits) for _ in range(20)] + [int(torch.randint(1 << 30, (1,), generator=g)) for g in gens]

    assert stream(3, 0) == stream(3, 0)
    assert stream(3, 0) != stream(4, 0) and stream(3, 0) != stream(3, 2)
    greedy = TokenSampler(0.0, 0.9, 3, device=True)
    assert greedy.sample(logits) == int(argmax_last(logits)[0])


def test_dense_serving_decode_takes_the_megakernel_and_idle_slots_write_nothing(spy):
    """Three dense slots, one request: every decode step is one megakernel
    call over all slots, and the idle slots' rows never change."""
    _, _, pw = _weights(CFG, 29)
    eng = ContinuousBatchingEngine(config=CFG, weights=pw, n_slots=3, kv_layout="dense", cache_dtype=torch.bfloat16,
                                   device="cpu")
    eng.submit(Request(0, [5, 6, 7, 8, 9], max_new_tokens=6))
    eng.step()  # admits the request into slot 0
    assert eng.slot_request[0] is not None and eng.slot_request[1] is None
    before = [t.clone() for t in eng.cache]
    spy.clear()
    done = eng.run()
    assert len(done) == 1 and len(done[0].generated) == 6
    assert spy and set(spy) == {3}
    for new, old in zip(eng.cache, before):
        assert torch.equal(new[:, 1:], old[:, 1:])
        assert not torch.equal(new[:, 0], old[:, 0])
