"""Model forward: the port's ``qwen3_forward`` (plain kernel versions on the
CPU) against the JAX package's ``qwen3_forward`` in fast mode, for a prefill
window and 4 decode steps, f32/bf16/INT8 caches, Qwen3 and Llama.

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

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import route_jax_through_interpret_kernels

from qwen3_rs_tpu.checkpoint import _classifier_from
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.models.qwen3 import Qwen3LayerWeights as JaxLayers
from qwen3_rs_tpu.models.qwen3 import Qwen3Weights as JaxWeights
from qwen3_rs_tpu.models.qwen3 import cast_weight_scales as jax_cast_scales
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu.ops.quant import quantize_weights_np
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


def _pow2(s):
    return (2.0 ** np.round(np.log2(s))).astype(np.float32)


def _jax_numpy_weights(c, seed):
    """JAX ``Qwen3Weights`` with numpy leaves, fast-mode bf16 scales."""
    rng = np.random.default_rng(seed)
    g = c.group_size

    def rowmajor(*shape):
        q, s, _ = quantize_weights_np(rng.normal(0, 0.08, shape).astype(np.float32), g)
        return q, _pow2(s)

    def linear(out_dim, in_dim):  # → in-major [L, in, out]
        q, s = rowmajor(c.n_layers, out_dim, in_dim)
        return np.swapaxes(q, 1, 2).copy(), np.swapaxes(s, 1, 2).copy()

    def fused(*parts):
        return JaxQT(np.concatenate([p[0] for p in parts], -1), np.concatenate([p[1] for p in parts], -1))

    def norm(*shape):
        return rng.normal(1, 0.05, shape).astype(np.float32)

    eq, es = rowmajor(c.vocab_size, c.dim)
    head = _classifier_from(eq, es)
    tree = JaxWeights(
        embed=JaxQT(eq, es),
        layers=JaxLayers(
            rms_att=norm(c.n_layers, c.dim),
            rms_ffn=norm(c.n_layers, c.dim),
            q_norm=norm(c.n_layers, c.head_dim),
            k_norm=norm(c.n_layers, c.head_dim),
            wqkv=fused(linear(c.all_heads_dim, c.dim), linear(c.kv_dim, c.dim), linear(c.kv_dim, c.dim)),
            wo=fused(linear(c.dim, c.all_heads_dim)),
            w13=fused(linear(c.hidden_dim, c.dim), linear(c.hidden_dim, c.dim)),
            w2=fused(linear(c.dim, c.hidden_dim)),
        ),
        rms_final=norm(c.dim),
        lm_head=JaxQT(np.asarray(head.q), np.asarray(head.scales)),
    )
    return jax.tree.map(np.asarray, jax_cast_scales(jax.tree.map(jnp.asarray, tree)))


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX forward through its Pallas kernels in interpret mode."""
    return route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)


def _run_both(config, cache_dtype, seed):
    rng = np.random.default_rng(seed)
    tree = _jax_numpy_weights(config, seed)
    jcfg = JaxConfig(**dataclasses.asdict(config))
    jw = jax.tree.map(jnp.asarray, tree)
    pw = weights_from_jax_numpy(tree)
    fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast"))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": "int8"}[cache_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": "int8"}[cache_dtype]
    jcache = jax_init_cache(jcfg, 2, dtype=jdt)
    pcache = init_kv_cache(config, 2, dtype=tdt)

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
    pw = weights_from_jax_numpy(_jax_numpy_weights(CONFIG, 0))
    cast = cast_weight_scales(pw)
    assert cast.layers.wqkv.scales.dtype == torch.bfloat16
    assert cast.embed.scales.dtype == pw.embed.scales.dtype
    assert cast.layers.w2.q is pw.layers.w2.q


def test_window_past_the_cache_is_refused():
    pw = weights_from_jax_numpy(_jax_numpy_weights(CONFIG, 0))
    cache = init_kv_cache(CONFIG, 1, seq_len=8)
    with pytest.raises(ValueError, match="does not fit"):
        qwen3_forward(CONFIG, pw, np.zeros((1, 4), np.int64), cache, [5])
