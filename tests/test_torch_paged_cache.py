"""The page pool and its allocator: the port's ``PageAllocator`` against the
JAX package's under one seeded random sequence of allocate / release /
match_prefix / adopt / register_prefix calls (identical tables, refcounts,
free counts, cached pages and matches after every call), the pool
constructors, and the conversion of a JAX pool."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.serving.paged_cache import PageAllocator as JaxAllocator
from qwen3_rs_tpu.serving.paged_cache import init_paged_cache as jax_init_paged_cache
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.serving.paged_cache import (
    PageAllocator,
    PagedKVCache,
    QuantizedPagedKVCache,
    init_paged_cache,
    paged_cache_from_jax_numpy,
)

PAGE = 4


def _state(a):
    return (a.tables.tolist(), a.used.tolist(), a.refcount.tolist(), a.free_pages, a.cached_pages,
            list(a._free), list(a._cached), dict(a._index), dict(a._page_key))


def _apply(a, op, args):
    try:
        return ("ok", getattr(a, op)(*args))
    except RuntimeError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax_under_random_calls(seed):
    rng = np.random.default_rng(seed)
    n_slots, n_pages, max_pages = 4, 14, 6
    ours, ref = PageAllocator(n_pages, n_slots, max_pages), JaxAllocator(n_pages, n_slots, max_pages)
    # A few shared prefixes so that matches, adoptions and evictions happen.
    stems = [list(rng.integers(0, 9, 3 * PAGE)) for _ in range(3)]
    prompts: dict[int, list[int]] = {}
    counts = {}
    for _ in range(400):
        slot = int(rng.integers(n_slots))
        op = rng.choice(["admit", "grow", "release", "match"], p=[0.35, 0.2, 0.3, 0.15])
        if op == "admit" and not ours.used[slot]:
            stem = stems[int(rng.integers(len(stems)))]
            tokens = stem[: int(rng.integers(0, len(stem) + 1))] + list(rng.integers(0, 9, int(rng.integers(1, 9))))
            calls = [("match_prefix", (tokens, PAGE))]
            got = [_apply(a, *calls[0]) for a in (ours, ref)]
            assert got[0] == got[1]
            pages, rows = got[0][1]
            if pages:
                calls.append(("adopt", (slot, pages)))
            calls += [("ensure_capacity", (slot, len(tokens) + int(rng.integers(0, 6)), PAGE)),
                      ("register_prefix", (slot, tokens, PAGE))]
            prompts[slot] = tokens
        elif op == "grow" and ours.used[slot]:
            calls = [("ensure_capacity", (slot, int(ours.used[slot]) * PAGE + int(rng.integers(1, 2 * PAGE)), PAGE))]
        elif op == "release":
            calls = [("release", (slot,))]
        else:
            calls = [("match_prefix", (list(rng.choice(stems)) + [1], PAGE)), ("can_admit", (int(rng.integers(1, 40)), PAGE))]
        for op_name, args in calls:
            got = [_apply(a, op_name, args) for a in (ours, ref)]
            assert got[0] == got[1], (op_name, args)
            assert _state(ours) == _state(ref), (op_name, args)
            counts[(op_name, got[0][0])] = counts.get((op_name, got[0][0]), 0) + 1
    # The sequence reached every path: hits, adoptions, evictions, exhaustion.
    assert counts.get(("adopt", "ok"), 0) > 5
    assert counts.get(("ensure_capacity", "raised"), 0) > 0
    assert counts.get(("register_prefix", "ok"), 0) > 10


def test_chain_hash_is_the_reference_key():
    """The prefix index keys are the reference's tuple hashes, not bytes."""
    toks = [5, 6, 7, 8]
    assert PageAllocator._chain(0, toks) == JaxAllocator._chain(0, toks) == hash((0, 5, 6, 7, 8))


CONFIG = ModelConfig(
    architecture_id=1, dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=16, seq_len=64, vocab_size=256, group_size=16, shared_classifier=True,
)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_pool_from_jax_numpy(dtype):
    from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
    import dataclasses
    import jax

    jdt = jnp.bfloat16 if dtype == "bf16" else "int8"
    pool = jax_init_paged_cache(JaxConfig(**dataclasses.asdict(CONFIG)), 5, PAGE, dtype=jdt)
    rng = np.random.default_rng(0)
    pool = jax.tree.map(lambda a: (a + rng.integers(-3, 4, a.shape)).astype(a.dtype), pool)
    ours = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, pool))
    ref = init_paged_cache(CONFIG, 5, PAGE, dtype=torch.bfloat16 if dtype == "bf16" else "int8", device="cpu")
    assert type(ours) is type(ref) is (PagedKVCache if dtype == "bf16" else QuantizedPagedKVCache)
    for a, b, j in zip(ours, ref, pool):
        assert a.shape == b.shape == j.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(j, np.float32))
    assert ours.n_pages == 5 and ours.page_size == PAGE


def test_pool_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_paged_cache(CONFIG, 4, PAGE)
