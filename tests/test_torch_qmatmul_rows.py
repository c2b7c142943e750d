"""The long-window matmul kernels' plain versions against the JAX package's
Pallas kernels in interpret mode, and exact mode's activation quantization.

* Row-blocked W8A16 (``qmatmul_w8a16_rows``) against
  ``qmatmul_pallas_stacked_rows``: both round x to bf16 and each weight to
  ``bf16(code · bf16(scale))`` and sum in f32; only the summation order
  differs, tolerance ``1e-4 · max|ref|``.  Power-of-two scales, because XLA on
  the CPU keeps the dequant product in f32 (see ``test_torch_qmatmul.py``).
* Dequant (``dequant_w8_stacked``) against ``dequant_pallas_stacked``: one f32
  product rounded once to bf16, bit for bit, with general scales.
* W8A8 rows (``qmatmul_w8a8_rows``) against
  ``qmatmul_pallas_stacked_rows_a8``: exact integer group dots, then the same
  rounded f32 operations in the same order, bit for bit.
* ``qmatmul_exact`` under 128 rows against the JAX ``qmatmul_exact`` (its
  group scan, the other scale order), bit for bit.

XLA on the CPU contracts the last multiply and the add of
``acc + (dot · s1) · s2`` into one FMA; the reference engine (Rust, which
never contracts) and the port round the product first.  The two agree
whenever ``s2`` is a power of two (the product is then exact), so the
bit-exact comparisons draw the last factor's scales as powers of two, and
``test_xla_cpu_contracts_the_last_multiply_add`` pins the difference down
with general scales.
* ``quantize_activations`` against the JAX function, bit for bit, half-way
  values included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.matmul import qmatmul_exact as jax_qmatmul_exact
from qwen3_rs_tpu.ops.pallas.qmatmul import (
    dequant_pallas_stacked,
    qmatmul_pallas_stacked_rows,
    qmatmul_pallas_stacked_rows_a8,
)
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu.ops.quant import quantize_activations as jax_quantize_activations
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
    dequant_w8_stacked,
    dequant_w8_stacked_plain,
    qmatmul_w8a16_rows,
    qmatmul_w8a16_rows_plain,
)
from qwen3_rs_tpu_torch.ops.kernels.qmatmul_a8 import (
    MAGIC_BITS,
    MAGIC_FLOAT,
    magic_group_float,
    qmatmul_w8a8_rows,
    qmatmul_w8a8_rows_plain,
)
from qwen3_rs_tpu_torch.ops.matmul import qmatmul_exact
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor, quantize_activations

torch.set_num_threads(2)

L, N, D, G = 2, 256, 384, 64


def _codes(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _stacked(seed, pow2):
    rng = np.random.default_rng(seed)
    codes = _codes(rng, (L, N, D))
    if pow2:
        scales = (2.0 ** rng.integers(-9, -5, (L, N // G, D))).astype(np.float32)
    else:
        scales = rng.uniform(0.001, 0.02, (L, N // G, D)).astype(np.float32)
    return codes, scales, rng


def _tw(codes, scales, dtype=torch.float32):
    return QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales).to(dtype))


@pytest.mark.parametrize("rows", [384, 512])
@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_rows_matches_qmatmul_pallas_stacked_rows(rows, scale_dtype):
    codes, scales, rng = _stacked(rows, pow2=True)
    x = rng.normal(0, 1, (rows, N)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if scale_dtype == "bf16" else (jnp.float32, torch.float32)
    ref = qmatmul_pallas_stacked_rows(
        jnp.asarray(x), JaxQT(jnp.asarray(codes), jnp.asarray(scales).astype(jdt)), 1, interpret=True
    )
    out = qmatmul_w8a16_rows(torch.from_numpy(x), _tw(codes, scales, tdt), 1)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape == (rows, D) and out.dtype == torch.float32
    err = float(np.abs(out.numpy() - ref).max())
    assert err <= 1e-4 * float(np.abs(ref).max()), err


def test_rows_rounds_f32_scales_to_bf16():
    """General f32 scales give the same result as their bf16 rounding, and
    the rounding is visible (the check has teeth)."""
    codes, scales, rng = _stacked(5, pow2=False)
    x = torch.from_numpy(rng.normal(0, 1, (300, N)).astype(np.float32))
    f32 = qmatmul_w8a16_rows(x, _tw(codes, scales), 0)
    assert torch.equal(f32, qmatmul_w8a16_rows(x, _tw(codes, scales, torch.bfloat16), 0))
    exact = x.to(torch.bfloat16).double() @ (
        torch.from_numpy(codes[0]).double() * torch.from_numpy(scales[0]).double().repeat_interleave(G, 0)
    )
    assert float((f32.double() - exact).abs().max()) > 1e-4 * float(exact.abs().max())


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_dequant_matches_dequant_pallas_stacked_bit_exact(scale_dtype):
    codes, scales, _ = _stacked(7, pow2=False)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if scale_dtype == "bf16" else (jnp.float32, torch.float32)
    ref = dequant_pallas_stacked(
        JaxQT(jnp.asarray(codes), jnp.asarray(scales).astype(jdt)), 1, interpret=True
    )
    out = dequant_w8_stacked(_tw(codes, scales, tdt), 1)
    assert out.dtype == torch.bfloat16 and out.shape == (N, D)
    ref_bits = np.asarray(ref).view(np.uint16)
    assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16), ref_bits)


def _pow2(rng, shape):
    return (2.0 ** rng.integers(-12, -5, shape)).astype(np.float32)


def _a8_inputs(seed, rows, pow2_x):
    """Codes and scales of activations and weights; the scale that multiplies
    last (x's for the kernel's order, w's for the scan's) is a power of two."""
    codes, scales, rng = _stacked(seed, pow2=not pow2_x)
    xq = _codes(rng, (rows, N))
    xs = _pow2(rng, (rows, N // G)) if pow2_x else rng.uniform(0.001, 0.05, (rows, N // G)).astype(np.float32)
    return codes, scales, xq, xs


def _fma_emulated(acc, a, b):
    """f32 fma(a, b, acc): the f32 product is exact in f64."""
    return (a.astype(np.float64) * b.astype(np.float64) + acc.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("rows", [128, 384])
def test_a8_matches_qmatmul_pallas_stacked_rows_a8_bit_exact(rows):
    codes, scales, xq, xs = _a8_inputs(rows + 1, rows, pow2_x=True)
    ref = qmatmul_pallas_stacked_rows_a8(
        JaxQT(jnp.asarray(xq), jnp.asarray(xs)), JaxQT(jnp.asarray(codes), jnp.asarray(scales)), 1,
        interpret=True,
    )
    out = qmatmul_w8a8_rows(torch.from_numpy(xq), torch.from_numpy(xs), _tw(codes, scales), 1)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("rows", [1, 5, 127])
def test_exact_scan_matches_jax_qmatmul_exact_bit_exact(rows):
    codes, scales, xq, xs = _a8_inputs(rows + 2, rows, pow2_x=False)
    ref = jax_qmatmul_exact(JaxQT(jnp.asarray(xq), jnp.asarray(xs)), JaxQT(jnp.asarray(codes[0]), jnp.asarray(scales[0])))
    x = QuantizedTensor(torch.from_numpy(xq), torch.from_numpy(xs))
    out = qmatmul_exact(x, _tw(codes, scales), 0)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_xla_cpu_contracts_the_last_multiply_add():
    """General scales: the JAX kernel on the CPU equals an FMA of the last
    multiply and the add; the port's kernel rounds the product first, as the
    reference engine does, and stays within a few f32 roundings of it."""
    rng = np.random.default_rng(12)
    codes, scales, _ = _stacked(12, pow2=False)
    xq = _codes(rng, (128, N))
    xs = rng.uniform(0.001, 0.05, (128, N // G)).astype(np.float32)
    ref = np.asarray(qmatmul_pallas_stacked_rows_a8(
        JaxQT(jnp.asarray(xq), jnp.asarray(xs)), JaxQT(jnp.asarray(codes), jnp.asarray(scales)), 0,
        interpret=True,
    ))
    acc = np.zeros((128, D), np.float32)
    for gi in range(N // G):
        sl = slice(gi * G, (gi + 1) * G)
        dot = (xq[:, sl].astype(np.int64) @ codes[0, sl].astype(np.int64)).astype(np.float32)
        acc = _fma_emulated(acc, dot * scales[0, gi][None, :], xs[:, gi : gi + 1])
    assert np.array_equal(acc, ref)
    out = qmatmul_w8a8_rows(torch.from_numpy(xq), torch.from_numpy(xs), _tw(codes, scales), 0).numpy()
    assert not np.array_equal(out, ref)
    assert float(np.abs(out - ref).max()) <= 1e-5 * float(np.abs(ref).max())


def test_exact_routes_by_rows_and_the_two_orders_differ():
    """From 128 rows ``qmatmul_exact`` is the kernel's sum, below it the scan's;
    on the same rows the two scale orders give different roundings."""
    codes, scales, rng = _stacked(9, pow2=False)
    xq = _codes(rng, (128, N))
    xs = rng.uniform(0.001, 0.05, (128, N // G)).astype(np.float32)
    x = QuantizedTensor(torch.from_numpy(xq), torch.from_numpy(xs))
    w = _tw(codes, scales)
    kernel = qmatmul_w8a8_rows_plain(x.q, x.scales, w, 1)
    assert torch.equal(qmatmul_exact(x, w, 1), kernel)
    scan = torch.cat([qmatmul_exact(QuantizedTensor(x.q[i : i + 64], x.scales[i : i + 64]), w, 1) for i in (0, 64)])
    assert not torch.equal(scan, kernel)
    assert float((scan - kernel).abs().max()) <= 1e-5 * float(kernel.abs().max())


def test_quantize_activations_bit_exact_with_half_way_values():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (3, 4, N)).astype(np.float32)
    # A group whose scale is 1: codes are the values themselves, half-way
    # values round away from zero (2.5 -> 3, -3.5 -> -4, 0.5 -> 1).
    x[0, 0, :G] = np.linspace(-63.5, 63.5, G).astype(np.float32)
    x[0, 0, 0] = 127.0
    x[0, 1, :G] = 0.0  # an all-zero group: scale 0, codes 0
    x[0, 2, :G] = np.float32(0.49999997)  # x/scale + 0.5 rounds up in f32
    x[0, 2, 0] = 127.0
    ref = jax_quantize_activations(jnp.asarray(x), G)
    out = quantize_activations(torch.from_numpy(x), G)
    assert out.q.dtype == torch.int8 and out.scales.dtype == torch.float32
    assert np.array_equal(out.q.numpy(), np.asarray(ref.q))
    assert np.array_equal(out.scales.numpy(), np.asarray(ref.scales))
    assert out.q[0, 0, 1] == np.asarray(ref.q)[0, 0, 1] and int(out.q[0, 1, :G].abs().sum()) == 0


def test_cpu_wrappers_are_the_plain_versions():
    codes, scales, rng = _stacked(4, pow2=False)
    w = _tw(codes, scales)
    x = torch.from_numpy(rng.normal(0, 1, (260, N)).astype(np.float32))
    xq = quantize_activations(x, G)
    before = dict(LAUNCHES)
    assert torch.equal(qmatmul_w8a16_rows(x, w, 0), qmatmul_w8a16_rows_plain(x, w, 0))
    assert torch.equal(dequant_w8_stacked(w, 0), dequant_w8_stacked_plain(w, 0))
    assert torch.equal(qmatmul_w8a8_rows(xq.q, xq.scales, w, 0), qmatmul_w8a8_rows_plain(xq.q, xq.scales, w, 0))
    assert LAUNCHES == before  # plain calls are not launches


def test_magic_group_float_is_exact_over_its_range():
    """Every int32 dot in [-2^22, 2^22): the bits MAGIC_BITS + dot read as an
    f32, less 12582912, are f32(dot) exactly (the W8A8 kernel's conversion of
    a group's sum for g <= 128, where |dot| <= 128·128·128 = 2^21)."""
    dot = np.arange(-(2**22), 2**22, dtype=np.int64)
    bits = (np.int64(MAGIC_BITS) + dot).astype(np.uint32)
    assert np.array_equal(bits.view(np.float32) - np.float32(MAGIC_FLOAT), dot.astype(np.float32))
    assert np.array_equal(magic_group_float(dot), dot.astype(np.float32))


def _a8_kernel_order(xq, xs, codes, scales, g):
    """numpy emulation of the W8A8 kernel's fix-up: per group in order, the
    int dot through the magic conversion (g <= 128) or a plain int-to-float
    one, then acc = acc + (d · w_scale) · x_scale, each operation rounded to
    f32 on its own."""
    acc = np.zeros((xq.shape[0], codes.shape[1]), np.float32)
    for gi in range(codes.shape[0] // g):
        sl = slice(gi * g, (gi + 1) * g)
        dot = xq[:, sl].astype(np.int64) @ codes[sl].astype(np.int64)
        d = magic_group_float(dot) if g <= 128 else dot.astype(np.float32)
        t = (d * scales[gi][None, :]).astype(np.float32)
        acc = (acc + (t * xs[:, gi : gi + 1]).astype(np.float32)).astype(np.float32)
    return acc


@pytest.mark.parametrize("g", [32, 64, 128, 256])
@pytest.mark.parametrize("extreme", [False, True])
def test_a8_kernel_order_matches_plain_bit_exact(g, extreme):
    """The emulated kernel order equals ``qmatmul_w8a8_rows_plain`` bit for
    bit on general scales; ``extreme``: every code -128, the largest |dot|."""
    rng = np.random.default_rng(g + extreme)
    n, d, rows = 512, 48, 9
    if extreme:
        xq = np.full((rows, n), -128, np.int8)
        codes = np.full((n, d), -128, np.int8)
    else:
        xq = _codes(rng, (rows, n))
        codes = _codes(rng, (n, d))
    xs = rng.uniform(0.001, 0.05, (rows, n // g)).astype(np.float32)
    scales = rng.uniform(0.001, 0.05, (n // g, d)).astype(np.float32)
    want = _a8_kernel_order(xq, xs, codes, scales, g)
    got = qmatmul_w8a8_rows_plain(torch.from_numpy(xq), torch.from_numpy(xs),
                                  QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales)))
    assert np.array_equal(got.numpy(), want)
