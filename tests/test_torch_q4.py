"""INT4 (``Q4Tensor``) weights: the port's packing, quantizers and the Q4
variants' plain versions against the JAX package.

* ``pack_q4_np``, ``unpack_q4_np``, ``quantize_weights_q4_np`` (and the INT8
  ``quantize_weights_np``), the torch ``unpack_q4`` and
  ``dequantize_q4_inmajor``: bit for bit, nibble 0 (code -8) included.
* The Q4 plain versions of the W8A16 kernel (#1-#3: 2-D, stacked, each
  prologue and epilogue), the row-blocked kernel (#6) and the dequant (#7)
  against the JAX Pallas kernels in interpret mode.  The fused kernel (#3)
  is held against the JAX stacked kernel (#2) with the fused kernel's
  prologue and epilogue applied around it: the JAX fused kernel reads the
  contraction length from the packed axis and so computes something else on
  Q4 weights (``test_jax_fused_kernel_misreads_packed_q4``).  Each weight is
  ``bf16(code · bf16(scale))`` on both sides; only the f32 summation order
  differs: tolerance ``1e-4 · max|ref|`` with power-of-two scales, whose
  products are exact in bf16 (XLA on the CPU keeps the product in f32, see
  ``test_torch_qmatmul.py``).  General bf16 scales: ``1e-2 · max|ref|``, the
  size of a bf16 rounding of the weights that XLA skips.  The Q4 dequant
  rounds the scales to bf16 and then the product once (the reference's "int"
  unpack): bit for bit with general f32 scales.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_numpy_weights, lower_xdot_gate, route_jax_q4_through_interpret_kernels

import qwen3_rs_tpu.ops.quant as jq
from qwen3_rs_tpu.configuration import ModelConfig as JaxConfig
from qwen3_rs_tpu.evaluation import compute_perplexity as jax_perplexity
from qwen3_rs_tpu.models.qwen3 import init_kv_cache as jax_init_cache
from qwen3_rs_tpu.models.qwen3 import qwen3_forward as jax_forward
from qwen3_rs_tpu.ops.pallas.qmatmul import (
    dequant_pallas_stacked,
    qmatmul_pallas,
    qmatmul_pallas_stacked,
    qmatmul_pallas_stacked_fused,
    qmatmul_pallas_stacked_rows,
)
import qwen3_rs_tpu_torch.models.qwen3 as port_qwen3
import qwen3_rs_tpu_torch.ops.kernels.qmatmul as kq
import qwen3_rs_tpu_torch.ops.quant as tq
from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.evaluation import compute_perplexity
from qwen3_rs_tpu_torch.models.qwen3 import cast_weight_scales, init_kv_cache, qwen3_forward, weights_from_jax_numpy
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
    dequant_q4_stacked,
    dequant_q4_stacked_plain,
    qmatmul_w8a16,
    qmatmul_w8a16_plain,
    qmatmul_w8a16_rows,
    qmatmul_w8a16_rows_plain,
)
from qwen3_rs_tpu_torch.ops.quant import Q4Tensor

torch.set_num_threads(2)

L, N, D, G = 2, 256, 256, 64
RTOL = 1e-4
RTOL_BF16 = 1e-2


@pytest.mark.parametrize("g", [4, 16, 64])
def test_quantizers_and_packing_bit_exact(g):
    rng = np.random.default_rng(g)
    w = rng.normal(0, 0.05, (3, 48, 128)).astype(np.float32)
    w[0, :, :g] = 0.0  # all-zero groups take scale 1.0
    for port_fn, jax_fn in ((tq.quantize_weights_np, jq.quantize_weights_np),
                            (tq.quantize_weights_q4_np, jq.quantize_weights_q4_np)):
        pq, ps, perr = port_fn(w, g)
        jqq, js, jerr = jax_fn(w, g)
        assert pq.dtype == jqq.dtype and ps.dtype == js.dtype and perr == jerr
        np.testing.assert_array_equal(pq, jqq)
        np.testing.assert_array_equal(ps, js)
    # Codes over the whole nibble range, -8 (nibble 0) included, in-major [.., N, D].
    codes = rng.integers(-8, 8, (2, 4 * g, 32)).astype(np.int8)
    packed = tq.pack_q4_np(codes, g)
    np.testing.assert_array_equal(packed, jq.pack_q4_np(codes, g))
    assert packed.dtype == np.uint8 and packed.shape == (2, 2 * g, 32)
    assert (packed & 0xF).min() == 0 and (packed >> 4).max() == 15
    np.testing.assert_array_equal(tq.unpack_q4_np(packed, g), codes)
    np.testing.assert_array_equal(tq.unpack_q4_np(packed, g), jq.unpack_q4_np(packed, g))
    unpacked = tq.unpack_q4(torch.from_numpy(packed), g)
    assert unpacked.dtype == torch.int8
    np.testing.assert_array_equal(unpacked.numpy(), codes)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.asarray(jq.unpack_q4(jnp.asarray(packed), g, dtype=jnp.int32))
    )


def test_packing_is_group_split_half():
    """Byte row k·g/2 + j holds in-row k·g + j (low nibble) and k·g + g/2 + j
    (high nibble), each as code + 8."""
    g = 8
    codes = np.arange(16, dtype=np.int8).reshape(16, 1) - 8  # in-row i has code i - 8
    packed = tq.pack_q4_np(codes, g)[:, 0]
    for k in range(2):
        for j in range(g // 2):
            byte = int(packed[k * g // 2 + j])
            assert byte & 0xF == k * g + j and byte >> 4 == k * g + g // 2 + j


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dequantize_q4_inmajor_bit_exact(dtype):
    rng = np.random.default_rng(3)
    packed = rng.integers(0, 256, (L, N // 2, D)).astype(np.uint8)
    scales = rng.uniform(0.001, 0.02, (L, N // G, D)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jq.dequantize_q4_inmajor(jq.Q4Tensor(jnp.asarray(packed), jnp.asarray(scales)), jdt)
    qt = Q4Tensor(torch.from_numpy(packed), torch.from_numpy(scales))
    assert qt.shape == (L, N, D) and qt.group_size == G
    out = tq.dequantize_q4_inmajor(qt, tdt)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def _weights(seed, stacked=True, pow2=True, n=N, d=D, g=G):
    """Random packed bytes (every nibble value occurs), bf16 scales."""
    rng = np.random.default_rng(seed)
    lead = (L,) if stacked else ()
    packed = rng.integers(0, 256, (*lead, n // 2, d)).astype(np.uint8)
    if pow2:
        scales = (2.0 ** rng.integers(-9, -5, (*lead, n // g, d))).astype(np.float32)
    else:
        scales = rng.uniform(0.001, 0.02, (*lead, n // g, d)).astype(np.float32)
    jw = jq.Q4Tensor(jnp.asarray(packed), jnp.asarray(scales).astype(jnp.bfloat16))
    tw = Q4Tensor(torch.from_numpy(packed), torch.from_numpy(scales).to(torch.bfloat16))
    return jw, tw, rng


def _close(out, ref, rtol=RTOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


@pytest.mark.parametrize("b", [1, 256])
def test_unstacked_matches_qmatmul_pallas(b):
    """#1's Q4 variant (a 2-D weight; no path hands it one, the classifier stays INT8)."""
    jw, tw, rng = _weights(b, stacked=False)
    x = rng.normal(0, 1, (b, N)).astype(np.float32)
    ref = qmatmul_pallas(jnp.asarray(x), jw, interpret=True)
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw), ref)


@pytest.mark.parametrize("pow2", [True, False], ids=["pow2-scales", "bf16-scales"])
def test_stacked_matches_qmatmul_pallas_stacked(pow2):
    jw, tw, rng = _weights(10, pow2=pow2)
    x = rng.normal(0, 1, (5, N)).astype(np.float32)
    ref = qmatmul_pallas_stacked(jnp.asarray(x), jw, 1, interpret=True)
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 1), ref, RTOL if pow2 else RTOL_BF16)


@pytest.mark.parametrize("b", [1, 256])
@pytest.mark.parametrize("prologue", [None, "rms", "swiglu"])
@pytest.mark.parametrize("residual", [None, "f32", "bf16"])
def test_fused_matches_the_stacked_kernel_with_its_prologue(b, prologue, residual):
    jw, tw, rng = _weights(100 + b)
    width = 2 * N if prologue == "swiglu" else N
    x = rng.normal(0, 1, (b, width)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.normal(0, 1, (L, N))).astype(np.float32)
    res = rng.normal(0, 1, (b, D)).astype(np.float32)
    tkw = {}
    if prologue == "rms":
        tkw["norm_w"] = torch.from_numpy(nw)
    if prologue == "swiglu":
        tkw["swiglu"] = True
    if residual is not None:
        tkw["residual"] = torch.from_numpy(res).to(torch.float32 if residual == "f32" else torch.bfloat16)
    # The fused kernel's prologue (f32, then bf16 at the dot) and residual (the
    # f32 accumulator's start), around the JAX stacked Q4 kernel.
    xf = jnp.asarray(x)
    if prologue == "rms":
        inv = 1.0 / jnp.sqrt(jnp.mean(xf * xf, axis=-1, keepdims=True) + 1e-6)
        xf = xf * inv * jnp.asarray(nw[0])
    if prologue == "swiglu":
        gate, up = xf[:, :N], xf[:, N:]
        xf = gate * (1.0 / (1.0 + jnp.exp(-gate))) * up
    ref = qmatmul_pallas_stacked(xf, jw, 0, interpret=True)
    if residual is not None:
        ref = ref + jnp.asarray(tkw["residual"].float().numpy())
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 0, eps=1e-6, **tkw), ref)


def test_jax_fused_kernel_misreads_packed_q4():
    """A fault of the reference, pinned: ``_qmatmul_stacked_fused_2d`` takes N
    from the codes' second axis, which INT4 packing halves.  On Q4 weights it
    contracts x's first N/2 columns against the first N/4 packed rows,
    unpacked with group size g/2, and so differs from its stacked kernel.
    The port computes the stacked kernel's function with the prologue and
    epilogue fused (``test_fused_matches_the_stacked_kernel_with_its_prologue``)."""
    jw, tw, rng = _weights(101)
    x = rng.normal(0, 1, (1, N)).astype(np.float32)
    fused = np.asarray(qmatmul_pallas_stacked_fused(jnp.asarray(x), jw, 0, interpret=True))
    stacked = np.asarray(qmatmul_pallas_stacked(jnp.asarray(x), jw, 0, interpret=True))
    assert np.abs(fused - stacked).max() > 0.5 * np.abs(stacked).max()
    codes = tq.unpack_q4_np(np.asarray(jw.q[0])[: N // 4], G // 2).astype(np.float32)
    s = np.asarray(jw.scales[0].astype(jnp.float32)).repeat(G // 2, 0)
    misread = np.asarray(jnp.asarray(x[:, : N // 2]).astype(jnp.bfloat16), np.float32) @ (codes * s)
    _close(fused, misread)
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 0), stacked)


def test_weight_products_round_to_bf16():
    """General bf16 scales: the plain version equals x_bf16 · bf16(code · scale)
    summed in f64, up to f32 summation order; the rounding is visible."""
    _, tw, rng = _weights(11, stacked=False, pow2=False)
    x = torch.from_numpy(rng.normal(0, 1, (3, N)).astype(np.float32))
    codes = tq.unpack_q4(tw.q, G).double()
    s = tw.scales.double().repeat_interleave(G, 0)
    w = (codes * s).to(torch.bfloat16).double()
    ref = x.to(torch.bfloat16).double() @ w
    out = qmatmul_w8a16_plain(x, tw)
    assert float((out.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    unrounded = x.to(torch.bfloat16).double() @ (codes * s)
    assert float((out.double() - unrounded).abs().max()) > 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("rows", [384, 512])
def test_rows_matches_qmatmul_pallas_stacked_rows(rows):
    jw, tw, rng = _weights(20 + rows, d=384)
    x = rng.normal(0, 1, (rows, N)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = qmatmul_pallas_stacked_rows(xb, jw, 1, interpret=True)
    out = qmatmul_w8a16_rows_plain(torch.from_numpy(np.array(xb, np.float32)), tw, 1)
    _close(out, ref)


@pytest.mark.parametrize("g,scale_dtype", [(64, "f32"), (64, "bf16"), (32, "f32")])
def test_dequant_bit_exact(g, scale_dtype):
    """The Q4 dequant rounds the scales to bf16 first (unlike the INT8 dequant)."""
    rng = np.random.default_rng(g)
    packed = rng.integers(0, 256, (L, N // 2, 512)).astype(np.uint8)
    scales = rng.uniform(0.001, 0.02, (L, N // g, 512)).astype(np.float32)
    js = jnp.asarray(scales) if scale_dtype == "f32" else jnp.asarray(scales).astype(jnp.bfloat16)
    ref = dequant_pallas_stacked(jq.Q4Tensor(jnp.asarray(packed), js), 1, interpret=True)
    ts = torch.from_numpy(np.array(js, np.float32))
    tw = Q4Tensor(torch.from_numpy(packed), ts if scale_dtype == "f32" else ts.to(torch.bfloat16))
    out = dequant_q4_stacked_plain(tw, 1)
    assert out.dtype == torch.bfloat16 and out.shape == (N, 512)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    if scale_dtype == "f32":  # an f32-scale product rounded once would differ
        once = (tq.unpack_q4(tw.q[1], g).float() * ts[1].repeat_interleave(g, 0)).to(torch.bfloat16)
        assert not torch.equal(once, out)


def test_cpu_wrappers_are_the_plain_versions():
    _, tw, rng = _weights(3)
    x = torch.from_numpy(rng.normal(0, 1, (4, N)).astype(np.float32))
    before = dict(LAUNCHES)
    assert torch.equal(qmatmul_w8a16(x, tw, 0), qmatmul_w8a16_plain(x, tw, 0))
    xr = torch.from_numpy(rng.normal(0, 1, (300, N)).astype(np.float32))
    assert torch.equal(qmatmul_w8a16_rows(xr, tw, 1), qmatmul_w8a16_rows_plain(xr, tw, 1))
    assert torch.equal(dequant_q4_stacked(tw, 0), dequant_q4_stacked_plain(tw, 0))
    assert LAUNCHES == before  # plain calls are not launches


# ------------------------------------------------------------------- model
# The forward with INT4 linear layers against the JAX forward through its
# interpret-mode Q4 kernels (stacked, rows, dequant; fused glue off, see
# ``torch_parity.route_jax_q4_through_interpret_kernels``), at the widths that
# pass the JAX Q4 gates, power-of-two scales.  A flipped bf16 rounding of the
# residual stream moves the logits by up to ~1% of their largest magnitude:
# tolerance ``2e-2 · max|logits|``, as for INT8 (``test_torch_model.py``).

CONFIG = ModelConfig(
    architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    head_dim=128, seq_len=1024, vocab_size=2176, group_size=64, shared_classifier=True, weight_bits=4,
)


def _both(seed, fast_scales=True):
    tree = jax_numpy_weights(CONFIG, seed, fast_scales=fast_scales, bits=4)
    return JaxConfig(**dataclasses.asdict(CONFIG)), jax.tree.map(jnp.asarray, tree), weights_from_jax_numpy(tree)


def _rel_err(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max()) / float(np.abs(ref).max())


def _spy_port(monkeypatch):
    calls = collections.Counter()
    for name in ("qmatmul_w8a16", "qmatmul_w8a16_rows", "dequant_q4_stacked", "dequant_w8_stacked",
                 "decode_stack_megakernel"):
        def wrap(*args, _fn=getattr(port_qwen3, name), _name=name, **kw):
            if _name != "qmatmul_w8a16" or isinstance(args[1], Q4Tensor):  # not the INT8 classifier
                calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(port_qwen3, name, wrap)
    return calls



def test_weights_carry_q4_across(monkeypatch):
    _, jw, pw = _both(0)
    assert isinstance(pw.layers.w13, Q4Tensor) and pw.layers.w13.q.dtype == torch.uint8
    assert pw.layers.w13.shape == (2, 256, 1024) and type(pw.lm_head).__name__ == "QuantizedTensor"
    np.testing.assert_array_equal(pw.layers.wqkv.q.numpy(), np.asarray(jw.layers.wqkv.q))
    cast = cast_weight_scales(pw, torch.float32)
    assert isinstance(cast.layers.wo, Q4Tensor) and cast.layers.wo.scales.dtype == torch.float32
    moved = port_qwen3.weights_to(pw, "cpu")
    assert isinstance(moved.layers.w2, Q4Tensor)


def test_decode_and_long_windows_match_jax(monkeypatch):
    """A fresh 512-row window (causal prefill; wqkv and w13 through the Q4
    row-blocked kernel, wo and w2 through the Q4 dequant, the xdot gate
    lowered), a 384-row continuation, then 3 decode steps (the fused Q4
    kernel; never the megakernel)."""
    jax_calls = route_jax_q4_through_interpret_kernels(monkeypatch, min_seq_len=128)
    lower_xdot_gate(monkeypatch, min_rows=384, min_elems=0)
    port_calls = _spy_port(monkeypatch)
    jcfg, jw, pw = _both(5)
    rng = np.random.default_rng(5)
    jcache, pcache = jax_init_cache(jcfg, 1), init_kv_cache(CONFIG, 1, device="cpu")
    errs, p0 = [], 0
    for s, fresh in ((512, True), (384, False), (1, False), (1, False), (1, False)):
        tokens = rng.integers(0, CONFIG.vocab_size, (1, s))
        pos = np.full(1, p0, np.int32)
        fwd = jax.jit(functools.partial(jax_forward, jcfg, mode="fast", fresh_prefill=fresh))
        jl, jcache = fwd(jw, jnp.asarray(tokens, jnp.int32), jcache, jnp.asarray(pos))
        pl_, pcache = qwen3_forward(CONFIG, pw, tokens, pcache, pos, fresh_prefill=fresh)
        errs.append(_rel_err(pl_.numpy(), jl))
        p0 += s
    assert max(errs) <= 2e-2, errs
    assert jax_calls["rows"] and jax_calls["dequant"] and jax_calls["stacked"] and not jax_calls["fused"]
    n = CONFIG.n_layers
    assert port_calls == {"qmatmul_w8a16_rows": 4 * n, "dequant_q4_stacked": 4 * n, "qmatmul_w8a16": 3 * 4 * n}


def test_f32_perplexity_matches_jax():
    """f32 mode dequantizes the INT4 codes to f32 (code · f32 scale) and takes
    full-f32 products on both sides; the residual stream stays bf16, whose
    roundings XLA on the CPU partly skips: the average NLL agrees to 1e-3
    relative, as for INT8 (``test_torch_evaluation.py``; 8.5e-5 here)."""
    jcfg, jw, pw = _both(9, fast_scales=False)
    cfg = dataclasses.replace(CONFIG, seq_len=64)
    tokens = np.random.default_rng(9).integers(0, CONFIG.vocab_size, 100).tolist()
    ref = jax_perplexity(dataclasses.replace(jcfg, seq_len=64), jw, tokens, mode="f32")
    got = compute_perplexity(cfg, pw, tokens, mode="f32")
    assert got.n_tokens == ref.n_tokens
    assert abs(got.avg_nll - ref.avg_nll) <= 1e-3 * abs(ref.avg_nll)


def test_exact_mode_raises_in_both_packages():
    jcfg, jw, pw = _both(0, fast_scales=False)
    tokens = np.zeros((1, 4), np.int64)
    with pytest.raises(ValueError, match="INT4 weights have no reference-exact"):
        jax_forward(jcfg, jw, jnp.asarray(tokens, jnp.int32), jax_init_cache(jcfg, 1), jnp.zeros(1, jnp.int32),
                    mode="exact")
    with pytest.raises(ValueError, match="INT4 weights have no reference-exact"):
        qwen3_forward(CONFIG, pw, tokens, init_kv_cache(CONFIG, 1, device="cpu"), [0], mode="exact")


def test_dequant_wrappers_refuse_the_other_kind():
    _, tw, _ = _weights(4)
    qt8 = tq.QuantizedTensor(tq.unpack_q4(tw.q, G), tw.scales)
    with pytest.raises(ValueError, match="take dequant_q4_stacked"):
        kq.dequant_w8_stacked(tw, 0)
    with pytest.raises(ValueError, match="take dequant_w8_stacked"):
        dequant_q4_stacked(qt8, 0)
