"""Sequence parallelism: the port's ring attention (``parallel/context.py``),
``qwen3_forward(sp_mesh=...)``, the engine's sp prefill and ``inference
--sp`` against the JAX package's on its virtual CPU mesh.  Rank 0 is this
process; the others are spawned (gloo on the CPU).

* The ring on 2 and 4 ranks, whole and inner form, against JAX
  ``ring_prefill_attention`` and ``gqa_attention_xla`` at 1e-4; a length
  that does not divide raises as JAX's.
* ``inference --sp 2 --sp-threshold 8 --device cpu,cpu`` prints the JAX
  CLI's text (``--sp 2``, its kernels in interpret mode).
* ``skip_head`` returns the residual stream, and ``greedy_head`` refuses it
  as JAX does; the sp forward on 2 ranks returns the one-rank forward's
  stream (``skip_head``) and logits at every row (``return_all_logits``) at
  2e-4, for 2 requests with their own ``out_idx``.
* The engine's sp prefill on 2 ranks on the 16-token prompt of JAX's
  ``test_engine_sp_prefill_matches_single_device``: its logits against the
  port's one-rank prefill at that test's 2e-4 and against JAX
  ``Engine(sp_mesh=..., sp_threshold=8)`` within 2e-2 of the largest logit
  (a bf16 stream whose roundings an f32 sum in another order may flip,
  ``test_torch_pipeline.py``); then a decode step from the sp-built cache,
  alike.  A prompt at the threshold whose bucket does not divide over the
  ranks is one plain window, in both packages.
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from test_model_parity import make_weights
from test_torch_generate import exported  # noqa: F401  (the exported fixture checkpoint)
from torch_parity import route_jax_through_interpret_kernels
from torch_tp_ranks import Ranks, model, ring, sp_forward
from utils import TINY_CONFIG

import qwen3_rs_tpu_torch.inference.engine as port_engine
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu.cli import main as jax_main
from qwen3_rs_tpu.inference.engine import Engine as JaxEngine
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_kv_cache
from qwen3_rs_tpu.ops.attention import gqa_attention_xla
from qwen3_rs_tpu.parallel.context import SP_AXIS, ring_prefill_attention as jax_ring
from qwen3_rs_tpu_torch.cli import main as port_main
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.inference.engine import Engine, start_sp_engine
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.parallel import Mesh, ring_prefill_attention

torch.set_num_threads(2)

CONFIG = ModelConfig(**dataclasses.asdict(TINY_CONFIG))
PROMPT = np.asarray([[5, 9, 3, 11, 2, 7, 8, 1, 4, 6, 10, 12, 13, 14, 15, 16]], np.int64)
TOL = 2e-2  # of max |ref|


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), (SP_AXIS,))


# ------------------------------------------------------------------ the ring
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax(n):
    rng = np.random.default_rng(n)
    b, s, n_kv, kv_mul, hd = 2, 64, 2, 2, 64
    q = rng.normal(0, 1, (b, s, n_kv * kv_mul, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, n_kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, n_kv, hd)).astype(np.float32)
    want = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _jax_mesh(n)))
    dense = np.asarray(gqa_attention_xla(jnp.asarray(q), jnp.asarray(np.transpose(k, (0, 2, 1, 3))),
                                         jnp.asarray(np.transpose(v, (0, 2, 1, 3))),
                                         jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))))
    group = Ranks(["cpu"] * n, "sp")
    try:
        got, inner = group.run(ring, *(torch.from_numpy(a) for a in (q, k, v)))
    finally:
        group.close()
    assert got.shape == (b, s, n_kv * kv_mul, hd) and inner.shape == (b, s // n, n_kv * kv_mul, hd)
    for ref in (want, dense):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(inner.numpy(), ref[:, : s // n], rtol=1e-4, atol=1e-4)


def test_uneven_sequence_rejected():
    q, k = torch.zeros(1, 30, 2, 64), torch.zeros(1, 30, 2, 64)
    mesh = Mesh(tuple(torch.device("cpu") for _ in range(4)), {"sp": 4})  # the check needs no group
    with pytest.raises(ValueError, match="divide") as got:
        ring_prefill_attention(q, k, k, mesh)
    with pytest.raises(ValueError, match="divide") as want:
        jax_ring(jnp.zeros((1, 30, 2, 64)), jnp.zeros((1, 30, 2, 64)), jnp.zeros((1, 30, 2, 64)), _jax_mesh(4))
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------------- the CLI
def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_cli_sp_matches_jax_cli(exported, monkeypatch):  # noqa: F811
    """Greedy generate on a 33-token prompt, past the threshold: the ring
    prefill of a 64-row bucket over 2 ranks, then decode on rank 0."""
    route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    ckpt = str(exported / "m.qtpu")
    run = ["-m", "generate", "-i", "the quick brown fox jumps over it", "-t", "0", "-s", "1",
           "--sp", "2", "--sp-threshold", "8"]
    seen = []
    real = port_qwen3.qwen3_forward

    def spy(*a, **kw):
        seen.append(kw.get("sp_mesh") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(port_engine, "qwen3_forward", spy)
    want = _stdout(jax_main, ["inference", ckpt, "--engine-mode", "fast", *run])
    got = _stdout(port_main, ["inference", ckpt, "--device", "cpu,cpu", *run])
    assert len(want) > 40 and got == want
    assert seen[0] and not any(seen[1:])  # the prompt on the ring, decode on rank 0
    with pytest.raises(ValueError, match="--sp 2 needs 2 devices, have 1"):
        port_main(["inference", ckpt, "--device", "cpu", *run])


# ------------------------------------------------------------------ skip_head
def test_skip_head_returns_the_stream():
    _, tree = make_weights(TINY_CONFIG, np.random.default_rng(4))
    weights = weights_from_jax_numpy(jax.tree.map(np.asarray, tree))
    tokens = PROMPT[:, :6]
    x, _ = qwen3_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 1, device="cpu"), [0], skip_head=True)
    assert x.shape == (1, 6, CONFIG.dim) and x.dtype == torch.bfloat16
    logits, _ = qwen3_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 1, device="cpu"), [0])
    head = port_qwen3._head(CONFIG, weights, x[:, -1], "fast")
    assert torch.equal(head, logits)
    with pytest.raises(ValueError, match="no skip_head"):
        qwen3_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 1, device="cpu"), [0], skip_head=True,
                      greedy_head=True)


def test_sp_forward_rows_match_one_rank():
    _, tree = make_weights(TINY_CONFIG, np.random.default_rng(5))
    weights = weights_from_jax_numpy(jax.tree.map(np.asarray, tree))
    tokens = np.random.default_rng(6).integers(0, CONFIG.vocab_size, (2, 16))
    group = Ranks(["cpu", "cpu"], "sp")
    try:
        stream, _ = group.run(sp_forward, CONFIG, weights, tokens, {"skip_head": True})
        every, _ = group.run(sp_forward, CONFIG, weights, tokens, {"return_all_logits": True})
        picked, cache = group.run(sp_forward, CONFIG, weights, tokens, {"out_idx": [12, 5]})
    finally:
        group.close()
    kw = dict(fresh_prefill=True)
    one = [qwen3_forward(CONFIG, weights, tokens, init_kv_cache(CONFIG, 2, device="cpu"), [0, 0], **kw, **extra)
           for extra in ({"skip_head": True}, {"return_all_logits": True}, {"out_idx": [12, 5]})]
    assert stream.shape == (2, 16, CONFIG.dim)
    for got, (want, _) in zip((stream, every, picked), one):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=2e-4, atol=2e-4)
    # Rows past each request's out_idx are padding: they wrote nothing.
    assert cache.k[:, 0, :, :13].abs().sum(-1).all() and not cache.k[:, 0, :, 13:].any()
    assert cache.k[:, 1, :, :6].abs().sum(-1).all() and not cache.k[:, 1, :, 6:].any()
    np.testing.assert_allclose(cache.k[:, 0, :, :13].numpy(), one[2][1].k[:, 0, :, :13].numpy(), rtol=2e-4,
                               atol=2e-4)


# ----------------------------------------------------------- the sp engine
@pytest.fixture(scope="module")
def sp():
    _, tree = make_weights(TINY_CONFIG, np.random.default_rng(0))
    tree = jax.tree.map(np.asarray, tree)
    weights = weights_from_jax_numpy(tree)
    engine = start_sp_engine(functools.partial(model, CONFIG, weights), ["cpu", "cpu"], sp_threshold=8)
    yield engine, weights, tree
    engine.close()


def test_engine_sp_prefill_matches_one_rank_and_jax(sp):
    engine, weights, tree = sp
    base = Engine(config=CONFIG, weights=weights, device="cpu")
    pos = np.zeros(1, np.int64)
    want, base_cache = base.prefill(base.new_cache(), PROMPT, pos)
    engine.reset_counters()
    got, cache = engine.prefill(engine.new_cache(), PROMPT, pos)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    # The bucket's 32 rows: 16 a rank; the 16 padding rows wrote nothing.
    assert [r["collectives"]["exchange"] for r in engine.rank_reports()] == [
        1 + CONFIG.n_layers * 1, 1 + CONFIG.n_layers * 1]
    assert not cache.k[:, :, :, 16:].any()
    np.testing.assert_allclose(cache.k[:, :, :, :16].numpy(), base_cache.k[:, :, :, :16].numpy(), rtol=2e-4,
                               atol=2e-4)

    jeng = JaxEngine(config=TINY_CONFIG, weights=jax.tree.map(jnp.asarray, tree), sp_mesh=_jax_mesh(2),
                     sp_threshold=8)
    jlogits, jcache = jeng.prefill(jeng.new_cache(), PROMPT.astype(np.int32), pos.astype(np.int32))
    jlogits = np.asarray(jlogits)
    assert float(np.abs(got.numpy() - jlogits).max()) <= TOL * float(np.abs(jlogits).max())

    # And decode from the sp-built cache.
    step, _ = engine.decode_step(cache, [3], [16])
    base_step, _ = base.decode_step(base_cache, [3], [16])
    np.testing.assert_allclose(step.numpy(), base_step.numpy(), rtol=2e-4, atol=2e-4)
    jstep, _ = jeng.decode_step(jcache, jnp.asarray([3], jnp.int32), jnp.asarray([16], jnp.int32))
    jstep = np.asarray(jstep)
    assert float(np.abs(step.numpy() - jstep).max()) <= TOL * float(np.abs(jstep).max())


def test_engine_sp_routing_matches_jax(sp, monkeypatch):
    """A prompt at the threshold is one window (never chunked); it takes the
    ring where its bucket divides over the ranks, and one plain window where
    the room in the cache cuts the bucket to an odd width (33 rows, a
    41-row cache), as the JAX engine routes them.  A window routes by its
    bucket: 7 rows, below the threshold of 8, pad to 32 and take the ring,
    in both packages."""
    engine, _, tree = sp
    seen = []
    real = port_qwen3.qwen3_forward

    def spy(config, weights, tokens, *a, **kw):
        seen.append((np.asarray(tokens).shape[1], kw.get("sp_mesh") is not None))
        return real(config, weights, tokens, *a, **kw)

    monkeypatch.setattr(port_engine, "qwen3_forward", spy)
    jeng = JaxEngine(config=TINY_CONFIG, weights=jax.tree.map(jnp.asarray, tree), sp_mesh=_jax_mesh(2),
                     sp_threshold=8)
    jseen = []
    for name in ("_prefill", "_prefill_sp"):
        fn = getattr(jeng, name)
        setattr(jeng, name, lambda w, t, *a, _fn=fn, _name=name: (jseen.append((t.shape[1], _name)), _fn(w, t, *a))[1])
    prompt = np.random.default_rng(1).integers(0, CONFIG.vocab_size, (1, 33))
    for rows in (64, 41):
        engine.prefill(init_kv_cache(CONFIG, 1, seq_len=rows, device="cpu"), prompt, np.zeros(1, np.int64))
        jeng.prefill(jax_init_kv_cache(TINY_CONFIG, 1, seq_len=rows), prompt.astype(np.int32), np.zeros(1, np.int32))
    engine.prefill(engine.new_cache(), prompt[:, :7], np.zeros(1, np.int64))
    jeng.prefill(jeng.new_cache(), prompt[:, :7].astype(np.int32), np.zeros(1, np.int32))
    assert seen == [(64, True), (33, False), (32, True)]
    assert jseen == [(64, "_prefill_sp"), (41, "_prefill"), (32, "_prefill_sp")]
