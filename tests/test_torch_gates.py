"""The port's kernel shape gates against the JAX package's, and the routes
they give.

The gates are plain Python on both sides: ``decode_supported``,
``splash_prefill_supported``, ``paged_decode_supported`` /
``paged_window_supported`` and the W8A16 tiling gates ``supports_shapes``,
``rows_supported`` and ``dequant_supported`` are held equal to the JAX ones
over grids of head_dims (64, 128, 256), page sizes, window and cache lengths, INT4
group sizes from 32 to 512 and row counts.  The forward asks them alone
before a launch (the port's kernels take every shape they admit): a refused
shape takes the plain path, as the JAX forward takes XLA, and an admitted one
the kernel.  A head_dim-64 Llama (refused), an INT4 checkpoint with 512-row
groups, a model with 5 query heads per kv head and a head_dim-256 model (all
three admitted) call the kernel wrappers the JAX gates say, and agree with
the JAX forward within 2e-2 of the largest logit; so does a head_dim-512
model's fresh 512-row window, the JAX forward through its interpret-mode
splash kernel (#5).  The attention kernels say which head_dims they are built
for (``takes_head_dim``): #4, #5, #9 and #10 every positive multiple of 128.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, route_jax_through_interpret_kernels

import qwen3_rs_tpu.ops.pallas.flash_attention as jax_flash
import qwen3_rs_tpu.ops.pallas.paged_attention as jax_paged
import qwen3_rs_tpu.ops.pallas.prefill_attention as jax_prefill
import qwen3_rs_tpu.ops.pallas.qmatmul as jax_qmm
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.models.qwen3 import init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.kernels import flash_attention, paged_attention, prefill_attention, qmatmul

torch.set_num_threads(2)

GATE_ENV = ("QWEN3_TPU_DISABLE_FLASH_DECODE", "QWEN3_TPU_SPLASH_BLOCK", "QWEN3_TPU_TILES", "QWEN3_TPU_DEQUANT_TILES",
            "QWEN3_TPU_DISABLE_PAGED_FLASH")
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for name in GATE_ENV:
        monkeypatch.delenv(name, raising=False)


def test_attention_gates_match_jax():
    heads = [(32, 8), (16, 8), (4, 2), (40, 8), (6, 4)]
    for (h, kv), hd in itertools.product(heads, (64, 128, 256)):
        for t in (20, 128, 200, 256, 384, 500, 512, 640, 1024, 4096):
            assert flash_attention.decode_supported(h, kv, hd, t) == jax_flash.decode_supported(h, kv, hd, t)
        for s in (2, 100, 256, 300, 512, 700, 1024, 1536, 2048, 3000, 4096):
            want = jax_prefill.splash_prefill_supported(s, hd, h, kv)
            assert prefill_attention.splash_prefill_supported(s, hd, h, kv) == want, (s, hd, h, kv)
    for hd, page, (dt, jdt) in itertools.product((64, 128, 256), (16, 64, 128, 256), DTYPES.items()):
        assert paged_attention.paged_decode_supported(hd, page, dt) == jax_paged.paged_decode_supported(hd, page, jdt)
        for s, mul in itertools.product((1, 2, 16, 32, 64, 129), (1, 2, 4, 8)):
            want = jax_paged.paged_window_supported(hd, page, jdt, s, mul)
            assert paged_attention.paged_window_supported(hd, page, dt, s, mul) == want


def test_matmul_gates_match_jax():
    shapes = [(4096, 6144), (4096, 24576), (12288, 4096), (1024, 3072), (2560, 9728), (256, 512), (512, 1040),
              (96, 64), (64, 16), (4096, 96), (200, 384), (768, 500)]
    seen = set()
    for (n, d), g, q4 in itertools.product(shapes, (16, 32, 63, 64, 128, 256, 512), (False, True)):
        if n % g:
            continue
        got = qmatmul.supports_shapes(n, d, g, q4)
        assert got == jax_qmm.supports_shapes(n, d, g, q4=q4), (n, d, g, q4)
        assert qmatmul.dequant_supported(n, d, g, q4) == jax_qmm.dequant_supported(n, d, g, q4=q4), (n, d, g, q4)
        for rows in (128, 256, 300, 512, 1024, 2048, 4096, 8192):
            want = jax_qmm.rows_supported(n, d, g, rows, q4=q4)
            assert qmatmul.rows_supported(n, d, g, rows, q4) == want, (n, d, g, rows, q4)
            seen.add(want)
        seen.add(got)
    assert seen == {True, False}


LLAMA_HD64 = ModelConfig(architecture_id=2, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                         head_dim=64, seq_len=512, vocab_size=512, group_size=64, shared_classifier=False,
                         use_qk_norm=False)
INT4_G512 = ModelConfig(architecture_id=1, dim=512, hidden_dim=1024, n_layers=2, n_heads=4, n_kv_heads=2,
                        head_dim=128, seq_len=512, vocab_size=512, group_size=512, shared_classifier=True)
KV_MUL5 = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=5, n_kv_heads=1,
                      head_dim=128, seq_len=512, vocab_size=512, group_size=64, shared_classifier=True)
HD256 = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=256, seq_len=512, vocab_size=512, group_size=64, shared_classifier=True)
ROUTES = {  # whether the forward calls each kernel wrapper on the shape (the JAX gates' answer)
    "head_dim 64": (LLAMA_HD64, 8, {"flash_decode": False, "causal_prefill_attention": False}),
    "INT4 g512": (INT4_G512, 4, {"qmatmul_w8a16": True}),
    "kv_mul 5": (KV_MUL5, 8, {"flash_decode": True, "causal_prefill_attention": True}),
    "head_dim 256": (HD256, 8, {"flash_decode": True, "causal_prefill_attention": True}),
}


def test_attention_kernels_say_their_head_dims():
    for hd in (0, 64, 128, 192, 256, 384, 512, 576, 640, 768, 1024, 2048):
        built = hd > 0 and hd % 128 == 0  # every head_dim the JAX gates admit
        assert flash_attention.takes_head_dim(hd) == paged_attention.takes_head_dim(hd) == built, hd
        assert prefill_attention.takes_head_dim(hd) == built, hd


@pytest.mark.parametrize("case", list(ROUTES))
def test_shapes_route_as_the_jax_gates_say(case, monkeypatch):
    """A 300-row fresh window (the prefill kernel's length), a 20-row window
    and two decode steps on each shape: the forward calls a kernel's wrapper
    exactly where the JAX gate admits the shape; the logits agree with the
    JAX forward."""
    cfg, bits, routes = ROUTES[case]
    assert not port_qwen3.megakernel_route(cfg, init_kv_cache(cfg, 1, device="cpu"), 1, 1)
    called = {name: 0 for name in routes}
    for name in routes:
        def spy(*a, _name=name, _real=getattr(port_qwen3, name), **k):
            called[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(port_qwen3, name, spy)
    tree = jax_numpy_weights(cfg, 9, bits=bits)
    pw = weights_from_jax_numpy(tree)
    jw = jax.tree.map(jnp.asarray, tree)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(9)
    pcache, jcache = init_kv_cache(cfg, 1, device="cpu"), jax_init_cache(jcfg, 1, dtype=jnp.float32)
    pos = 0
    for rows in (300, 20, 1, 1):
        toks = rng.integers(0, cfg.vocab_size, (1, rows))
        logits, pcache = qwen3_forward(cfg, pw, toks, pcache, [pos], fresh_prefill=pos == 0)
        ref, jcache = jax_forward(jcfg, jw, jnp.asarray(toks, jnp.int32), jcache, jnp.asarray([pos], jnp.int32),
                                  mode="fast", fresh_prefill=pos == 0)
        ref = np.asarray(ref, np.float32)
        err = float(np.abs(logits.float().numpy() - ref).max())
        assert np.isfinite(err) and err <= 2e-2 * float(np.abs(ref).max()), (rows, err)
        pos += rows
    assert {name: n > 0 for name, n in called.items()} == routes


HD512 = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=512, seq_len=512, vocab_size=512, group_size=64, shared_classifier=True)


def test_head_dim_512_fresh_window_matches_jax_through_its_prefill_kernel(monkeypatch):
    """A fresh 512-row window of a head_dim-512 model: the port's forward
    calls #5 (its plain version here) where the JAX forward runs its splash
    kernel in interpret mode; the logits agree within 2e-2 of the largest."""
    jax_calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    called = []

    def spy(*a, _real=port_qwen3.causal_prefill_attention, **k):
        called.append(a[0].shape)
        return _real(*a, **k)

    monkeypatch.setattr(port_qwen3, "causal_prefill_attention", spy)
    tree = jax_numpy_weights(HD512, 12)
    pw = weights_from_jax_numpy(tree)
    jw = jax.tree.map(jnp.asarray, tree)
    jcfg = JaxConfig(**dataclasses.asdict(HD512))
    toks = np.random.default_rng(12).integers(0, HD512.vocab_size, (1, 512))
    logits, _ = qwen3_forward(HD512, pw, toks, init_kv_cache(HD512, 1, device="cpu"), [0], fresh_prefill=True)
    fwd = jax.jit(lambda w, t, c, p: jax_forward(jcfg, w, t, c, p, mode="fast", fresh_prefill=True))
    ref, _ = fwd(jw, jnp.asarray(toks, jnp.int32), jax_init_cache(jcfg, 1, dtype=jnp.float32),
                 jnp.asarray([0], jnp.int32))
    ref = np.asarray(ref, np.float32)
    assert jax_calls["prefill"] >= 1 and called == [(1, 512, 4, 512)] * HD512.n_layers
    err = float(np.abs(logits.float().numpy() - ref).max())
    assert np.isfinite(err) and err <= 2e-2 * float(np.abs(ref).max()), err


HD640 = ModelConfig(architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
                    head_dim=640, seq_len=1024, vocab_size=512, group_size=64, shared_classifier=True)


def test_head_dim_640_window_and_decode_match_jax_through_its_kernels(monkeypatch):
    """A head_dim past 512: a fresh 512-row window and a decode step of a
    head_dim-640 model.  The port's forward calls #5 and #4 (their plain
    versions here; the column-blocked kernels on the card) where the JAX
    forward runs its splash and flash-decode kernels in interpret mode; the
    logits agree within 2e-2 of the largest."""
    jax_calls = route_jax_through_interpret_kernels(monkeypatch, min_seq_len=128)
    called = {"causal_prefill_attention": 0, "flash_decode": 0}
    for name in called:
        def spy(*a, _name=name, _real=getattr(port_qwen3, name), **k):
            called[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(port_qwen3, name, spy)
    tree = jax_numpy_weights(HD640, 13)
    pw = weights_from_jax_numpy(tree)
    jw = jax.tree.map(jnp.asarray, tree)
    jcfg = JaxConfig(**dataclasses.asdict(HD640))
    toks = np.random.default_rng(13).integers(0, HD640.vocab_size, (1, 512))
    pcache, jcache = init_kv_cache(HD640, 1, device="cpu"), jax_init_cache(jcfg, 1, dtype=jnp.float32)
    for fresh, t, pos in ((True, toks, 0), (False, toks[:, -1:], 512)):
        logits, pcache = qwen3_forward(HD640, pw, t, pcache, [pos], fresh_prefill=fresh)
        fwd = jax.jit(lambda w, t_, c, p, _f=fresh: jax_forward(jcfg, w, t_, c, p, mode="fast", fresh_prefill=_f))
        ref, jcache = fwd(jw, jnp.asarray(t, jnp.int32), jcache, jnp.asarray([pos], jnp.int32))
        ref = np.asarray(ref, np.float32)
        err = float(np.abs(logits.float().numpy() - ref).max())
        assert np.isfinite(err) and err <= 2e-2 * float(np.abs(ref).max()), (pos, err)
    assert jax_calls["prefill"] >= 1 and jax_calls["flash"] >= 1, jax_calls
    assert called == {"causal_prefill_attention": HD640.n_layers, "flash_decode": HD640.n_layers}
