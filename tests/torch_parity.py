"""Shared set-up for the PyTorch port's parity tests: route the JAX package's
forward through its Pallas kernels in interpret mode, as its own parity tests
do (``tests/test_model_parity.py``), so that it follows the numerics the
port's kernels follow."""

import collections

import jax
import jax.numpy as jnp
import numpy as np

import qwen3_rs_tpu.models.qwen3 as jax_qwen3
import qwen3_rs_tpu.ops.pallas as pallas_pkg
import qwen3_rs_tpu.ops.pallas.flash_attention as jax_flash
import qwen3_rs_tpu.ops.pallas.megakernel as jax_mega
import qwen3_rs_tpu.ops.pallas.paged_attention as jax_paged
import qwen3_rs_tpu.ops.pallas.prefill_attention as jax_prefill
import qwen3_rs_tpu.ops.pallas.qmatmul as jax_qmm
from qwen3_rs_tpu.checkpoint import _classifier_from
from qwen3_rs_tpu.models.qwen3 import Qwen3LayerWeights as JaxLayers
from qwen3_rs_tpu.models.qwen3 import Qwen3Weights as JaxWeights
from qwen3_rs_tpu.models.qwen3 import cast_weight_scales as jax_cast_scales
from qwen3_rs_tpu.ops.pallas.qmatmul import qmatmul_pallas, qmatmul_pallas_stacked, qmatmul_pallas_stacked_fused
from qwen3_rs_tpu.ops.quant import Q4Tensor as JaxQ4
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu.ops.quant import pack_q4_np, quantize_weights_np, quantize_weights_q4_np

import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3


def _counted(calls, name, fn):
    def wrapper(*args, **kw):
        calls[name] += 1
        return fn(*args, interpret=True, **kw)

    return wrapper


def route_jax_through_interpret_kernels(monkeypatch, min_seq_len: int) -> collections.Counter:
    """Megakernel off; in interpret mode the fused W8A16 kernel, the
    classifier kernel, flash decode (from ``min_seq_len`` cache rows), the
    row-blocked W8A16 kernel, the dequant kernel, the W8A8 rows kernel, the
    causal prefill kernel and the paged decode and window kernels (pages of
    128 rows).  Returns the count of kernel calls seen while tracing."""
    monkeypatch.setenv("QWEN3_TPU_DISABLE_MEGAKERNEL", "1")
    return _route_per_layer_kernels(monkeypatch, min_seq_len)


def route_jax_through_interpret_megakernel(monkeypatch, min_seq_len: int) -> collections.Counter:
    """The JAX forward as it runs with Pallas on: decode steps whose shapes
    pass its gate through the whole-step megakernel, every other call through
    the per-layer kernels, all in interpret mode (the megakernel's count is
    ``"mega"``).  ``QWEN3_TPU_DISABLE_MEGAKERNEL`` is left unset."""
    monkeypatch.delenv("QWEN3_TPU_DISABLE_MEGAKERNEL", raising=False)
    calls = _route_per_layer_kernels(monkeypatch, min_seq_len)
    monkeypatch.setattr(jax_mega, "decode_stack_megakernel", _counted(calls, "mega", jax_mega.decode_stack_megakernel))
    return calls


def route_jax_q4_through_interpret_kernels(monkeypatch, min_seq_len: int) -> collections.Counter:
    """``route_jax_through_interpret_kernels`` for INT4 weights, with the JAX
    package's fused-glue projections off (``QWEN3_TPU_DISABLE_FUSED=1``): its
    fused kernel misreads packed Q4 codes (``test_torch_q4.py``), so a
    projection of at most 256 rows takes its stacked kernel (count
    ``"stacked"``) with RMSNorm, SwiGLU and the residual add in XLA."""
    monkeypatch.setenv("QWEN3_TPU_DISABLE_FUSED", "1")
    return route_jax_through_interpret_kernels(monkeypatch, min_seq_len)


def _route_per_layer_kernels(monkeypatch, min_seq_len: int) -> collections.Counter:
    calls = collections.Counter()

    def counted(name, fn):
        return _counted(calls, name, fn)

    monkeypatch.setattr(pallas_pkg, "pallas_enabled", lambda: True)
    monkeypatch.setattr(
        pallas_pkg, "qmatmul_pallas_stacked_fused", counted("fused", qmatmul_pallas_stacked_fused)
    )
    monkeypatch.setattr(pallas_pkg, "qmatmul_pallas", counted("head", qmatmul_pallas))
    monkeypatch.setattr(pallas_pkg, "qmatmul_pallas_stacked", counted("stacked", qmatmul_pallas_stacked))
    monkeypatch.setattr(
        jax_flash, "flash_gqa_decode_stacked", counted("flash", jax_flash.flash_gqa_decode_stacked)
    )
    monkeypatch.setattr(jax_flash, "MIN_SEQ_LEN", min_seq_len)
    monkeypatch.setattr(
        pallas_pkg, "qmatmul_pallas_stacked_rows", counted("rows", jax_qmm.qmatmul_pallas_stacked_rows)
    )
    monkeypatch.setattr(jax_qmm, "dequant_pallas_stacked", counted("dequant", jax_qmm.dequant_pallas_stacked))
    monkeypatch.setattr(
        jax_qmm, "qmatmul_pallas_stacked_rows_a8", counted("a8", jax_qmm.qmatmul_pallas_stacked_rows_a8)
    )
    monkeypatch.setattr(
        jax_prefill, "causal_prefill_attention", counted("prefill", jax_prefill.causal_prefill_attention)
    )
    monkeypatch.setattr(
        jax_paged, "paged_gqa_decode_stacked", counted("paged", jax_paged.paged_gqa_decode_stacked)
    )
    monkeypatch.setattr(
        jax_paged, "paged_gqa_window_stacked", counted("window", jax_paged.paged_gqa_window_stacked)
    )
    return calls


def lower_xdot_gate(monkeypatch, min_rows: int, min_elems: int) -> None:
    """Lower the long-prefill "xdot" gate in both packages alike, so that a
    tiny model's down-projection reaches the dequant kernel."""
    monkeypatch.delenv("QWEN3_TPU_PREFILL_XDOT", raising=False)
    for mod in (jax_qwen3, port_qwen3):
        monkeypatch.setattr(mod, "_XDOT_PREFILL_MIN_ROWS", min_rows)
        monkeypatch.setattr(mod, "_XDOT_MIN_WEIGHT_ELEMS", min_elems)


def _pow2(s):
    return (2.0 ** np.round(np.log2(s))).astype(np.float32)


def jax_numpy_weights(c, seed, fast_scales: bool = True, bits: int = 8):
    """JAX ``Qwen3Weights`` with numpy leaves drawn from ``seed``: power-of-two
    scales (``code · scale`` is exact in bf16, which XLA on the CPU would not
    round), cast to bf16 as the fast engine casts them, or f32 as the exact
    engine and the evaluation keep them.  ``bits=4``: INT4 linear layers
    (``Q4Tensor``, nibble-packed), the embedding and the classifier INT8."""
    rng = np.random.default_rng(seed)
    g = c.group_size

    def rowmajor(*shape):
        q, s, _ = quantize_weights_np(rng.normal(0, 0.08, shape).astype(np.float32), g)
        return q, _pow2(s)

    def linear(out_dim, in_dim):  # → in-major [L, in, out]
        w = rng.normal(0, 0.08, (c.n_layers, out_dim, in_dim)).astype(np.float32)
        q, s, _ = (quantize_weights_q4_np if bits == 4 else quantize_weights_np)(w, g)
        return np.swapaxes(q, 1, 2).copy(), np.swapaxes(_pow2(s), 1, 2).copy()

    def fused(*parts):
        q, s = np.concatenate([p[0] for p in parts], -1), np.concatenate([p[1] for p in parts], -1)
        return JaxQ4(pack_q4_np(q, g), s) if bits == 4 else JaxQT(q, s)

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
    if fast_scales:
        tree = jax_cast_scales(jax.tree.map(jnp.asarray, tree))
    return jax.tree.map(np.asarray, tree)
