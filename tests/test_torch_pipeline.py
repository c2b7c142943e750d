"""Pipeline parallelism: the port's ``parallel/pipeline.py`` on 2 ranks
(gloo on the CPU; rank 0 this process, rank 1 spawned) against the JAX
package's ``pipelined_forward`` on its virtual CPU mesh.

* A prefill of 4 requests and then two decode steps on one cache, with 1
  and 2 microbatches, against the JAX pipeline compiled without
  ``xla_allow_excess_precision`` (fast mode routed through its
  ``_project``'s interpret-mode W8A16 kernel, #1), within 2e-2 of the
  largest logit: the residual stream is bf16 in both modes, and an f32 sum
  in another order flips some of its roundings (0.03 of 5.9 at 4 layers in
  f32 mode, the dense forwards alike).  Against the port's own dense
  ``qwen3_forward``, whose sums are the pipeline's, f32 mode holds at the
  JAX test's 2e-4.
* Each rank's ``shard_for_pp`` slab bit for bit the JAX shard on device s,
  and the cache slab after the calls equal to JAX's.
* ``validate_pp`` and ``create_pp_mesh`` raising as JAX's; a one-rank
  pipeline's all-position logits against the port's ``qwen3_forward``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, route_jax_through_interpret_kernels
from torch_tp_ranks import Ranks, pipeline_calls, pp_shards

import qwen3_rs_tpu.models.qwen3 as jax_qwen3
import qwen3_rs_tpu.parallel.pipeline as jax_pp
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.parallel import create_pp_mesh, pipelined_forward, validate_pp

torch.set_num_threads(2)

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=4, n_heads=4, n_kv_heads=2, head_dim=128,
    seq_len=32, vocab_size=256, group_size=16, shared_classifier=True,
)
JCONFIG = JaxConfig(**dataclasses.asdict(CONFIG))
B, S = 4, 8
TOL = 2e-2  # of max |ref|


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def ranks():
    group = Ranks(["cpu", "cpu"], "pp")
    yield group
    group.close()


@pytest.fixture(scope="module")
def trees():
    return {mode: jax_numpy_weights(CONFIG, 21, fast_scales=mode == "fast") for mode in ("fast", "f32")}


def _calls():
    rng = np.random.default_rng(3)
    prefill = (rng.integers(0, CONFIG.vocab_size, (B, S)), np.zeros(B, np.int64))
    steps = [(rng.integers(0, CONFIG.vocab_size, (B, 1)), np.full(B, S + i, np.int64)) for i in range(2)]
    return [prefill, *steps]


def _jax_run(tree, calls, m, mode):
    """The JAX pipeline, compiled without ``xla_allow_excess_precision`` (on
    the CPU XLA otherwise keeps the bf16 stream in f32 between fused ops:
    ``test_torch_model.py``), so that it rounds as its source says."""
    w = jax.tree.map(jnp.asarray, tree)
    cache = jax_qwen3.init_kv_cache(JCONFIG, B)
    fwd = jax.jit(functools.partial(jax_pp.pipelined_forward, JCONFIG, mesh=jax_pp.create_pp_mesh(2),
                                    n_microbatches=m, mode=mode))
    out = []
    for tokens, pos in calls:
        args = (w, jnp.asarray(tokens, jnp.int32), cache, jnp.asarray(pos, jnp.int32))
        logits, cache = fwd.lower(*args).compile({"xla_allow_excess_precision": False})(*args)
        out.append(np.asarray(logits))
    return out, cache


@pytest.mark.parametrize("mode", ["f32", "fast"])
@pytest.mark.parametrize("m", [1, 2])
def test_pipeline_matches_jax(ranks, trees, monkeypatch, mode, m):
    if mode == "fast":
        calls_seen = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    calls = _calls()
    want, jcache = _jax_run(trees[mode], calls, m, mode)
    if mode == "fast":
        assert calls_seen["head"]  # every projection through JAX qmatmul's kernel
    got, slab = ranks.run(pipeline_calls, CONFIG, weights_from_jax_numpy(trees[mode]), calls, m, mode)
    for g, w in zip(got, want):
        assert g.shape == (B, CONFIG.vocab_size)
        assert float(np.abs(g.numpy() - w).max()) <= TOL * float(np.abs(w).max())
    # Rank 0's slab: the first half of the layers of the JAX cache.
    jk = np.asarray(jcache.k, np.float32)[: CONFIG.n_layers // 2]
    assert slab.k.shape == jk.shape
    assert float(np.abs(slab.k.numpy() - jk).max()) <= TOL * float(np.abs(jk).max())


def test_pipeline_matches_the_dense_forward(ranks, trees):
    """The 2-rank pipeline (f32 mode) against the port's own ``qwen3_forward``."""
    calls = _calls()
    weights = weights_from_jax_numpy(trees["f32"])
    got, _ = ranks.run(pipeline_calls, CONFIG, weights, calls, 2, "f32")
    cache = init_kv_cache(CONFIG, B, device="cpu")
    for g, (tokens, pos) in zip(got, calls):
        want, cache = qwen3_forward(CONFIG, weights, tokens, cache, pos, mode="f32")
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


def test_shards_equal_the_jax_shards(ranks, trees):
    tree = trees["fast"]
    jmesh = jax_pp.create_pp_mesh(2)
    jw, jc = jax_pp.shard_for_pp(jax.tree.map(jnp.asarray, tree), jax_qwen3.init_kv_cache(JCONFIG, B), jmesh)
    w, c = ranks.run(pp_shards, weights_from_jax_numpy(tree), init_kv_cache(CONFIG, B, device="cpu"))
    dev0 = jmesh.devices.flat[0]

    def shard0(leaf):
        return next(np.asarray(s.data) for s in leaf.addressable_shards if s.device == dev0)

    port_leaves = [t for f in w.layers for t in (f if isinstance(f, tuple) else (f,))]
    jax_leaves = jax.tree.leaves(jw.layers)
    assert len(port_leaves) == len(jax_leaves)
    for p, j in zip(port_leaves, jax_leaves):
        assert p.shape[0] == CONFIG.n_layers // 2
        assert np.array_equal(_np(p), _np(shard0(j)))
    for p, j in zip(c, jc):
        assert np.array_equal(_np(p), _np(shard0(j)))
    # The embedding, final norm and classifier stay whole.
    assert np.array_equal(w.embed.q.numpy(), np.asarray(tree.embed.q))
    assert np.array_equal(w.rms_final.numpy(), np.asarray(tree.rms_final))


def test_validation_matches_jax():
    for args in ((CONFIG, 3, B, 2), (CONFIG, 2, 3, 2)):
        with pytest.raises(ValueError) as want:
            jax_pp.validate_pp(JCONFIG, *args[1:])
        with pytest.raises(ValueError) as got:
            validate_pp(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="exceeds"):
        jax_pp.create_pp_mesh(pp=99)
    with pytest.raises(ValueError, match="exceeds"):
        create_pp_mesh(pp=99, devices=["cpu"])


def test_one_rank_all_logits(trees):
    """pp = 1 (no process group): the pipeline's logits at every position
    equal the dense forward's, as JAX's test has them."""
    weights = weights_from_jax_numpy(trees["f32"])
    tokens = np.random.default_rng(8).integers(0, CONFIG.vocab_size, (2, 4))
    pos = np.zeros(2, np.int64)
    got, _ = pipelined_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 2, device="cpu"), pos,
                               create_pp_mesh(1, ["cpu"]), mode="f32", return_all_logits=True)
    want, _ = qwen3_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 2, device="cpu"), pos, mode="f32",
                            return_all_logits=True)
    assert got.shape == (2, 4, CONFIG.vocab_size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
