"""Model forward: the port's ``qwen3_forward`` (plain kernel versions on the
CPU) against the JAX package's ``qwen3_forward`` in fast mode, for a prefill
window and 4 decode steps, f32/bf16/INT8 caches, Qwen3 and Llama; and the
long-window slice: a fresh 512-row window and a 384-row continuation (the
causal prefill, row-blocked and dequant kernels), an exact-mode (W8A8)
prefill with decode steps, and all-logits windows; and the serving slice:
the forward over the page pool (``page_table``: a fresh group prefill, a
continued window through the paged window kernel, decode steps through the
paged decode kernel; bf16, f32 and INT8 pools) with ``write_mask``, and the
dense cache's ``write_mask``.

Two references:

* the JAX CPU path (XLA fallbacks, no Pallas), at the logit tolerance of the
  JAX package's own fused-path test (atol 0.25);
* the JAX path the port follows, with the decode megakernel off: the fused
  W8A16 kernel, the classifier kernel and flash decode run in Pallas
  interpret mode.  Same bf16 roundings as the port: most steps agree bit for
  bit.  f32 summation order and rsqrt/sigmoid/exp can flip a bf16 rounding
  of the residual stream, which moves the logits by up to ~0.7% of their
  largest magnitude here: tolerance ``2e-2 · max|logits|``.

Weight scales are powers of two so that ``code · scale`` is exact in bf16
(XLA on the CPU skips that rounding, see ``test_torch_qmatmul.py``).
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, lower_xdot_gate, route_jax_through_interpret_kernels

from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
import qwen3_rs_tpu_torch.ops.matmul as port_matmul
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import (
    cast_weight_scales,
    init_kv_cache,
    qwen3_forward,
    weights_from_jax_numpy,
)

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=128, seq_len=256, vocab_size=2176, group_size=64, shared_classifier=True,
)
LLAMA = dataclasses.replace(CONFIG, architecture_id=2, use_qk_norm=False)
PROMPT_LEN, OUT_IDX, STEPS = 6, [5, 3], 4  # row 1's prompt is 4 tokens, right-padded


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX forward through its Pallas kernels in interpret mode."""
    return route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)


def _run_both(config, cache_dtype, seed):
    rng = np.random.default_rng(seed)
    tree = jax_numpy_weights(config, seed)
    jcfg = JaxConfig(**dataclasses.asdict(config))
    jw = jax.tree.map(jnp.asarray, tree)
    pw = weights_from_jax_numpy(tree)
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast"))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8"}[cache_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8"}[cache_dtype]
    jcache = jax_init_cache(jcfg, 2, dtype=jdt)
    pcache = init_kv_cache(config, 2, dtype=tdt, device="cpu")

    tokens = rng.integers(0, config.vocab_size, (2, PROMPT_LEN))
    pos = np.zeros(2, np.int32)
    jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos),
                     out_idx=jnp.asarray(OUT_IDX, jnp.int32))
    pl_, pcache = qwen3_forward(config, pw, tokens, pcache, pos, out_idx=OUT_IDX)
    pairs = [(np.asarray(jl), pl_.numpy())]
    pos = np.asarray(OUT_IDX, np.int32) + 1
    for _ in range(STEPS):
        tok = rng.integers(0, config.vocab_size, (2, 1))
        jl, jcache = fwd(jw, jnp.asarray(tok, jnp.int32), jcache, jnp.asarray(pos))
        pl_, pcache = qwen3_forward(config, pw, tok, pcache, pos)
        pairs.append((np.asarray(jl), pl_.numpy()))
        pos = pos + 1
    return pairs, jcache, pcache


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _cache_f32(cache, part):
    """Cache rows as f32 (INT8 codes times their row scales)."""
    rows = _f32(getattr(cache, part))
    if hasattr(cache, "k_scale"):
        rows = rows * _f32(getattr(cache, f"{part}_scale"))[..., None]
    return rows


CASES = [(CONFIG, "f32"), (CONFIG, "bf16"), (CONFIG, "int8"), (LLAMA, "f32")]
IDS = ["qwen3-f32", "qwen3-bf16", "qwen3-int8", "llama-f32"]


@pytest.mark.parametrize("config,cache_dtype", CASES, ids=IDS)
def test_matches_jax_cpu_path(config, cache_dtype):
    pairs, jcache, pcache = _run_both(config, cache_dtype, seed=1)
    for ref, out in pairs:
        assert out.shape == ref.shape == (2, config.vocab_size)
        np.testing.assert_allclose(out, ref, rtol=0.0, atol=0.25)
    np.testing.assert_allclose(_cache_f32(pcache, "k"), _cache_f32(jcache, "k"), rtol=0.0, atol=0.05)


@pytest.mark.parametrize("config,cache_dtype", CASES, ids=IDS)
def test_matches_jax_kernel_path(config, cache_dtype, interpret_kernels):
    pairs, jcache, pcache = _run_both(config, cache_dtype, seed=2)
    assert interpret_kernels["fused"] > 0 and interpret_kernels["head"] > 0
    assert interpret_kernels["flash"] > 0
    for ref, out in pairs:
        err = float(np.abs(out - ref).max())
        assert err <= 2e-2 * float(np.abs(ref).max()), err
    np.testing.assert_allclose(_cache_f32(pcache, "v"), _cache_f32(jcache, "v"), rtol=0.0, atol=0.02)


def test_scales_cast_keeps_codes():
    pw = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 0))
    cast = cast_weight_scales(pw)
    assert cast.layers.wqkv.scales.dtype == torch.bfloat16
    assert cast.embed.scales.dtype == pw.embed.scales.dtype
    assert cast.layers.w2.q is pw.layers.w2.q


def test_init_kv_cache_takes_the_card_by_default(monkeypatch):
    """Like every entry point of the port, ``init_kv_cache`` builds on the
    card unless the caller asks for the CPU: with no device and no CUDA it
    raises rather than build a CPU cache."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dtype in (torch.float32, "int8"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_kv_cache(CONFIG, 1, dtype=dtype)
        cache = init_kv_cache(CONFIG, 1, dtype=dtype, device="cpu")
        assert all(t.device.type == "cpu" for t in cache)


def test_window_past_the_cache_is_refused():
    pw = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 0))
    cache = init_kv_cache(CONFIG, 1, seq_len=8, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        qwen3_forward(CONFIG, pw, np.zeros((1, 4), np.int64), cache, [5])


# ------------------------------------------------------------- long windows
LONG = dataclasses.replace(CONFIG, seq_len=1024)


def _spy_port(monkeypatch) -> collections.Counter:
    """Count the port's calls of each kernel wrapper on the forward's path."""
    calls = collections.Counter()
    targets = [(port_qwen3, n) for n in ("causal_prefill_attention", "qmatmul_w8a16_rows",
                                         "dequant_w8_stacked", "flash_decode", "qmatmul_w8a16",
                                         "paged_decode", "paged_window_attention")]
    targets += [(port_matmul, "qmatmul_w8a8_rows"), (port_matmul, "qmatmul_w8a16")]  # classifier
    for mod, name in targets:
        def wrap(*args, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(mod, name, wrap)
    return calls


@pytest.fixture
def long_kernels(monkeypatch):
    """The JAX forward through its interpret-mode kernels #1-#8, the xdot
    gate lowered in both packages (down-projections from 384 rows), and the
    port's kernel wrappers counted."""
    jax_calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    lower_xdot_gate(monkeypatch, min_rows=384, min_elems=0)
    return jax_calls, _spy_port(monkeypatch)


def _both(config, seed, mode):
    # The exact engine keeps the checkpoint's f32 scales, the fast one casts them.
    tree = jax_numpy_weights(config, seed, fast_scales=mode == "fast")
    jcfg = JaxConfig(**dataclasses.asdict(config))
    return jcfg, jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree)


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max()) / float(np.abs(ref).max())


def test_long_fast_windows_match_jax(long_kernels):
    """A fresh 512-row window, then a 384-row continuation at position 512."""
    jax_calls, port_calls = long_kernels
    jcfg, jw, pw = _both(LONG, 5, "fast")
    rng = np.random.default_rng(5)
    jcache, pcache = jax_init_cache(jcfg, 1), init_kv_cache(LONG, 1, device="cpu")
    for s, p0, fresh in ((512, 0, True), (384, 512, False)):
        tokens = rng.integers(0, LONG.vocab_size, (1, s))
        pos = np.full(1, p0, np.int32)
        fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast", fresh_prefill=fresh))
        jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos))
        pl_, pcache = qwen3_forward(LONG, pw, tokens, pcache, pos, fresh_prefill=fresh)
        assert pl_.shape == (1, LONG.vocab_size)
        assert _rel_err(pl_.numpy(), jl) <= 2e-2
    assert jax_calls["prefill"] and jax_calls["rows"] and jax_calls["dequant"]
    n = LONG.n_layers
    # wo and w2 (n > d) take the dequant kernel, wqkv and w13 the rows kernel.
    assert port_calls == {"causal_prefill_attention": n, "qmatmul_w8a16_rows": 4 * n,
                          "dequant_w8_stacked": 4 * n, "qmatmul_w8a16": 2}
    # A flipped bf16 rounding of the residual stream moves layer 1's rows.
    assert _rel_err(_cache_f32(pcache, "v")[..., :896, :], _cache_f32(jcache, "v")[..., :896, :]) <= 2e-2


def test_exact_prefill_and_decode_match_jax(long_kernels):
    """Exact mode: a 256-row window (the W8A8 kernel on both sides), then 3
    decode steps (the group scan on both sides)."""
    jax_calls, port_calls = long_kernels
    jcfg, jw, pw = _both(LONG, 6, "exact")
    rng = np.random.default_rng(6)
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="exact"))
    jcache, pcache = jax_init_cache(jcfg, 1), init_kv_cache(LONG, 1, device="cpu")
    tokens, pos = rng.integers(0, LONG.vocab_size, (1, 256)), np.zeros(1, np.int32)
    errs = []
    for step in range(4):
        jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos))
        pl_, pcache = qwen3_forward(LONG, pw, tokens, pcache, pos, mode="exact")
        errs.append(_rel_err(pl_.numpy(), jl))
        pos = pos + tokens.shape[1]
        tokens = np.asarray([[int(np.argmax(np.asarray(jl)[0]))]])
    assert jax_calls["a8"] == 4  # traced once for the layer scan's body
    assert port_calls == {"qmatmul_w8a8_rows": 4 * LONG.n_layers}
    # Summation orders and the FMA that XLA on the CPU makes of the W8A8
    # epilogue differ by an f32 rounding, which can flip an activation's int8
    # code: the JAX package's own two routes (kernel and scan, which differ
    # only in the scale order) are 0.9% apart on this window.
    assert max(errs) <= 2e-2, errs


@pytest.mark.parametrize("s", [384, 512])
def test_all_logits_match_jax(long_kernels, s):
    """return_all_logits: the per-group classifier form below 512 rows, the
    dense bf16 one from 512."""
    jcfg, jw, pw = _both(LONG, 7, "fast")
    tokens = np.random.default_rng(7).integers(0, LONG.vocab_size, (1, s))
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast", return_all_logits=True))
    jl, _ = fwd(jw, jnp.asarray(tokens, jnp.int32), jax_init_cache(jcfg, 1), jnp.zeros(1, jnp.int32))
    pl_, _ = qwen3_forward(LONG, pw, tokens, init_kv_cache(LONG, 1, device="cpu"), [0], return_all_logits=True)
    assert pl_.shape == (1, s, LONG.vocab_size) and pl_.dtype == torch.float32
    assert _rel_err(pl_.numpy(), jl) <= 2e-2


def test_fresh_prefill_needs_position_zero():
    pw = weights_from_jax_numpy(jax_numpy_weights(CONFIG, 0))
    with pytest.raises(ValueError, match="fresh"):
        qwen3_forward(CONFIG, pw, np.zeros((1, 4), np.int64), init_kv_cache(CONFIG, 1, device="cpu"), [3],
                      fresh_prefill=True)


@pytest.mark.parametrize("mode", ["f32", "exact"])
def test_unfused_body_matches_jax_without_excess_precision(mode):
    """XLA on the CPU keeps bf16 intermediates in f32 between fused ops
    (``xla_allow_excess_precision``, on by default), so the JAX reference
    rounds the residual stream less often than its source says.  Compiled
    without it, the JAX forward and the port's unfused layer body (the f32
    and exact modes at a short window) agree to f32 rounding: within 1e-5 of
    max|logits| on every row but at most one, where an f32 sum in another
    order may flip one bf16 rounding (one row of 8 on 2 of 8 seeds tried)."""
    cfg = dataclasses.replace(LONG, n_layers=1)
    jcfg, jw, pw = _both(cfg, 0, mode)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 8))
    args = (jw, jnp.asarray(tokens, jnp.int32), jax_init_cache(jcfg, 1), jnp.zeros(1, jnp.int32))
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode=mode, return_all_logits=True))
    jl, _ = fwd.lower(*args).compile({"xla_allow_excess_precision": False})(*args)
    pl_, _ = qwen3_forward(cfg, pw, tokens, init_kv_cache(cfg, 1, device="cpu"), [0], mode=mode, return_all_logits=True)

    def rows_apart(ref):
        ref = np.asarray(ref, np.float32)[0]
        return int((np.abs(pl_.numpy()[0] - ref).max(-1) > 1e-5 * np.abs(ref).max()).sum())

    assert rows_apart(jl) <= 1
    if mode == "f32":  # the bf16 residual stream: the default compile rounds it less often
        assert rows_apart(fwd(*args)[0]) >= 4


def test_engine_prefills_in_windows_and_marks_only_the_first_fresh(monkeypatch):
    from qwen3_rs_tpu_torch.inference import engine as engine_mod

    seen = []

    def spy(config, weights, tokens, cache, pos, **kw):
        seen.append((np.asarray(tokens).shape[1], int(np.asarray(pos)[0]),
                     kw.get("fresh_prefill", kw.get("return_all_logits")), kw["mode"]))
        return torch.zeros(1, config.vocab_size), cache

    monkeypatch.setattr(engine_mod, "qwen3_forward", spy)
    tree = jax_numpy_weights(LONG, 0, fast_scales=False)
    eng = engine_mod.Engine(config=LONG, weights=weights_from_jax_numpy(tree), mode="exact", device="cpu")
    assert eng.MAX_PREFILL_WINDOW == 2048 and eng.weights.lm_head.scales.dtype == torch.float32
    monkeypatch.setattr(eng, "MAX_PREFILL_WINDOW", 300)
    eng.prefill(eng.new_cache(1), np.zeros((1, 700), np.int64), np.zeros(1, np.int64))
    eng.prefill(eng.new_cache(1), np.zeros((1, 10), np.int64), np.full(1, 5))
    eng.all_logits(eng.new_cache(1), np.zeros((1, 7), np.int64), [0])  # (rows, pos, all logits, mode)
    assert seen == [(300, 0, True, "exact"), (300, 300, False, "exact"), (100, 600, False, "exact"),
                    (10, 5, False, "exact"), (7, 0, True, "exact")]


# -------------------------------------------------------------- page pool
PAGED = dataclasses.replace(CONFIG, seq_len=1024)
PAGE = 128


def _pool_f32(pool, part):
    """Pool rows as f32 without the null page (padding rows write it in any
    order)."""
    return _cache_f32(pool, part)[:, 1:]


@pytest.mark.parametrize("pool_dtype", ["bf16", "f32", "int8"])
def test_paged_forward_matches_jax(pool_dtype, long_kernels):
    """Three slots on one shuffled pool: a fresh prefill of 200 and 150 rows
    with a padding row (all-null table, write masked), a continued 16-row
    window (the paged window kernel), then 3 decode steps with one slot
    idle (write masked).  Logits and the pool's rows against the JAX forward
    through its interpret-mode kernels."""
    from qwen3_rs_tpu.serving.paged_cache import init_paged_cache as jax_init_pool
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache, paged_cache_from_jax_numpy

    jax_calls, port_calls = long_kernels
    jcfg, jw, pw = _both(PAGED, 8, "fast")
    rng = np.random.default_rng(8)
    n_pages, max_pages = 1 + 2 * 8, 8
    jdt = {"bf16": jnp.bfloat16, "f32": jnp.float32, "int8": "int8"}[pool_dtype]
    jpool = jax_init_pool(jcfg, n_pages, PAGE, dtype=jdt)
    ppool = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, jpool))
    assert type(ppool) is type(init_paged_cache(PAGED, 2, PAGE, dtype=jdt if jdt == "int8" else ppool.k.dtype,
                                                device="cpu"))
    ids = rng.permutation(np.arange(1, n_pages)).reshape(2, max_pages)
    table = np.zeros((3, max_pages), np.int32)
    table[:2] = ids  # row 2 pads the group: all-null table
    lens = [200, 150]

    def step(tokens, pos, mask, fresh=False, out_idx=None):
        nonlocal jpool, ppool
        kw = dict(page_table=table, write_mask=np.asarray(mask, bool), out_idx=out_idx)
        fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast", fresh_prefill=fresh))
        jl, jpool = fwd(jw, jnp.asarray(tokens, jnp.int32), jpool, jnp.asarray(pos, jnp.int32),
                        **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
        pl_, ppool = qwen3_forward(PAGED, pw, tokens, ppool, pos, fresh_prefill=fresh, **kw)
        assert _rel_err(pl_.numpy()[:2], np.asarray(jl)[:2]) <= 2e-2
        for part in ("k", "v"):
            assert _rel_err(_pool_f32(ppool, part), _pool_f32(jpool, part)) <= 2e-2
        return np.asarray(jl)

    tokens = rng.integers(0, PAGED.vocab_size, (3, 200))
    step(tokens, [0, 0, 0], [1, 1, 0], fresh=True, out_idx=[199, 149, 0])
    pos = np.asarray(lens + [0])
    tokens = rng.integers(0, PAGED.vocab_size, (3, 16))
    jl = step(tokens, pos, [1, 1, 0])
    pos = pos + [16, 16, 0]
    for _ in range(3):
        tok = np.asarray(jl).argmax(-1)[:, None]
        jl = step(tok, pos, [1, 0, 0])  # slot 1 idle: its pages must not change
        pos = pos + [1, 0, 0]
    assert jax_calls["paged"] and jax_calls["window"]
    n = PAGED.n_layers
    assert port_calls["paged_decode"] == 3 * n and port_calls["paged_window_attention"] == n


@pytest.mark.parametrize("pool_dtype", ["bf16", "int8"])
def test_small_paged_windows_match_jax_row_for_row(pool_dtype, long_kernels):
    """Small windows on the pool (S·kv_mul ≤ 128: the window path, fresh or
    continued) and decode steps, one layer, every row's logits against the
    JAX forward through its interpret-mode kernels, compiled to round as
    written: within 1e-5 of max|logits| on all rows but a few, where an f32
    sum in another order flips one bf16 rounding (up to 2 of 32 rows seen).
    A fresh window's attention in bf16 instead of the reference's f32 puts
    nearly every row apart."""
    from qwen3_rs_tpu.serving.paged_cache import init_paged_cache as jax_init_pool
    from qwen3_rs_tpu_torch.serving.paged_cache import paged_cache_from_jax_numpy

    cfg = dataclasses.replace(PAGED, n_layers=1, seq_len=512)
    jcfg, jw, pw = _both(cfg, 3, "fast")
    rng = np.random.default_rng(3)
    jpool = jax_init_pool(jcfg, 9, PAGE, dtype=jnp.bfloat16 if pool_dtype == "bf16" else "int8")
    ppool = paged_cache_from_jax_numpy(jax.tree.map(np.asarray, jpool))
    table = np.asarray([[3, 1, 0, 0], [5, 2, 4, 0]], np.int32)
    pos = np.zeros(2, np.int32)
    for s, fresh in ((16, True), (16, False), (1, False), (1, False)):
        tokens = rng.integers(0, cfg.vocab_size, (2, s))
        args = (jw, jnp.asarray(tokens, jnp.int32), jpool, jnp.asarray(pos))
        fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast", fresh_prefill=fresh,
                                        page_table=jnp.asarray(table), return_all_logits=True))
        jl, jpool = fwd.lower(*args).compile({"xla_allow_excess_precision": False})(*args)
        pl_, ppool = qwen3_forward(cfg, pw, tokens, ppool, pos, fresh_prefill=fresh, page_table=table,
                                   return_all_logits=True)
        ref = np.asarray(jl, np.float32).reshape(-1, cfg.vocab_size)
        rel = np.abs(pl_.numpy().reshape(-1, cfg.vocab_size) - ref).max(-1) / np.abs(ref).max()
        assert rel.max() <= 2e-2 and (rel > 1e-5).sum() <= max(1, len(rel) // 10), (s, fresh, rel)
        pos = pos + s
    jax_calls, port_calls = long_kernels
    assert jax_calls["window"] and jax_calls["paged"]
    assert port_calls["paged_window_attention"] == 2 and port_calls["paged_decode"] == 2


def test_masked_paged_rows_write_nothing():
    """Masked requests and rows past the table leave the pool untouched, bit
    for bit; unmasked rows land at table[b, p // page], row p % page."""
    from qwen3_rs_tpu_torch.serving.paged_cache import init_paged_cache

    cfg = dataclasses.replace(CONFIG, seq_len=32)
    pw = weights_from_jax_numpy(jax_numpy_weights(cfg, 0))
    for dtype in (torch.bfloat16, "int8"):
        pool = init_paged_cache(cfg, 6, 8, dtype=dtype, device="cpu")
        table = np.asarray([[3, 1, 0, 0], [5, 2, 4, 0]], np.int32)
        qwen3_forward(cfg, pw, np.ones((2, 6), np.int64), pool, [6, 2], page_table=table,
                      write_mask=np.asarray([True, False]))
        written = {(int(p), int(r)) for p, r in zip(*np.nonzero(pool.k[0, :, 0].float().abs().sum(-1).numpy()))}
        assert written == {(3, 6), (3, 7), (1, 0), (1, 1), (1, 2), (1, 3)}
        before = [t.clone() for t in pool]
        qwen3_forward(cfg, pw, np.ones((2, 1), np.int64), pool, [10, 3], page_table=table,
                      write_mask=np.asarray([False, False]))
        assert all(torch.equal(a, b) for a, b in zip(before, pool))


@pytest.mark.parametrize("cache_dtype", ["bf16", "int8"])
def test_dense_write_mask_matches_jax(cache_dtype):
    """The dense cache's write_mask: a masked slot's rows stay as they were,
    as the reference's ``_scatter_dense`` keeps them."""
    tree = jax_numpy_weights(CONFIG, 4)
    jcfg = JaxConfig(**dataclasses.asdict(CONFIG))
    jw, pw = jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if cache_dtype == "bf16" else ("int8", "int8")
    jcache, pcache = jax_init_cache(jcfg, 2, dtype=jdt), init_kv_cache(CONFIG, 2, dtype=tdt, device="cpu")
    rng = np.random.default_rng(4)
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast"))
    for tokens, pos, mask in ((rng.integers(0, CONFIG.vocab_size, (2, 5)), [0, 0], [True, True]),
                              (rng.integers(0, CONFIG.vocab_size, (2, 1)), [5, 3], [True, False])):
        before = [t.clone() for t in pcache]
        jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos, jnp.int32),
                         write_mask=jnp.asarray(mask))
        pl_, pcache = qwen3_forward(CONFIG, pw, tokens, pcache, pos, write_mask=np.asarray(mask))
        assert _rel_err(pl_.numpy(), jl) <= 2e-2
        assert _rel_err(_cache_f32(pcache, "k"), _cache_f32(jcache, "k")) <= 2e-2
    assert all(torch.equal(a[:, 1], b[:, 1]) for a, b in zip(before, pcache))
