"""W8A16 matmul: the port's plain version against the JAX package's Pallas
kernels run in interpret mode (``impl="scale_w"``, bf16 scales).

Both sides round the activations to bf16, take each weight element as
``bf16(code · scale)`` and accumulate in f32, so only the f32 summation order
differs: tolerance ``1e-4 · max|ref|``.  XLA on the CPU fuses the dequant
multiply into the dot and keeps the product in f32 (excess precision), where
the TPU rounds it to bf16 before the matrix unit.  So the interpret-mode
comparisons use power-of-two scales, whose products are exact in bf16, and
``test_weight_products_round_to_bf16`` holds the rounding itself against
numpy with general scales.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.pallas.qmatmul import (
    qmatmul_pallas,
    qmatmul_pallas_stacked,
    qmatmul_pallas_stacked_fused,
)
from qwen3_rs_tpu.ops.quant import QuantizedTensor as JaxQT
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import (
    MAX_ROWS,
    qmatmul_w8a16,
    qmatmul_w8a16_plain,
    split_plan,
)
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
from qwen3_rs_tpu_torch.testing import QWEN3_CONFIGS

torch.set_num_threads(2)

L, N, D, G = 2, 256, 256, 64
RTOL = 1e-4


def _weights(seed, stacked=True):
    rng = np.random.default_rng(seed)
    shape = (L, N, D) if stacked else (N, D)
    codes = rng.integers(-127, 128, shape).astype(np.int8)
    # Powers of two: code · scale is exact in bf16 (see the module note).
    scales = (2.0 ** rng.integers(-9, -5, (*shape[:-2], N // G, D))).astype(np.float32)
    jw = JaxQT(jnp.asarray(codes), jnp.asarray(scales).astype(jnp.bfloat16))
    tw = QuantizedTensor(torch.from_numpy(codes), torch.from_numpy(scales).to(torch.bfloat16))
    return jw, tw, rng


def _close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= RTOL * float(np.abs(ref).max()), (err, float(np.abs(ref).max()))


@pytest.mark.parametrize("b", [1, 5, 256])
def test_unstacked_matches_qmatmul_pallas(b):
    jw, tw, rng = _weights(b, stacked=False)
    x = rng.normal(0, 1, (b, N)).astype(np.float32)
    ref = qmatmul_pallas(jnp.asarray(x), jw, interpret=True, impl="scale_w")
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw), ref)


@pytest.mark.parametrize("b", [1, 5, 256])
def test_stacked_matches_qmatmul_pallas_stacked(b):
    jw, tw, rng = _weights(10 + b)
    x = rng.normal(0, 1, (b, N)).astype(np.float32)
    ref = qmatmul_pallas_stacked(jnp.asarray(x), jw, 1, interpret=True, impl="scale_w")
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 1), ref)


@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("prologue", [None, "rms", "swiglu"])
@pytest.mark.parametrize("residual", [None, "f32", "bf16"])
def test_fused_matches_qmatmul_pallas_stacked_fused(b, prologue, residual):
    jw, tw, rng = _weights(100 + b)
    width = 2 * N if prologue == "swiglu" else N
    x = rng.normal(0, 1, (b, width)).astype(np.float32)
    nw = (1.0 + 0.1 * rng.normal(0, 1, (L, N))).astype(np.float32)
    res = rng.normal(0, 1, (b, D)).astype(np.float32)
    jkw, tkw = {}, {}
    if prologue == "rms":
        jkw["norm_w"], tkw["norm_w"] = jnp.asarray(nw), torch.from_numpy(nw)
    if prologue == "swiglu":
        jkw["swiglu"] = tkw["swiglu"] = True
    if residual is not None:
        dt = jnp.float32 if residual == "f32" else jnp.bfloat16
        jkw["residual"] = jnp.asarray(res).astype(dt)
        tkw["residual"] = torch.from_numpy(np.array(jkw["residual"], np.float32)).to(
            torch.float32 if residual == "f32" else torch.bfloat16
        )
    ref = qmatmul_pallas_stacked_fused(
        jnp.asarray(x), jw, 0, eps=1e-6, interpret=True, impl="scale_w", **jkw
    )
    _close(qmatmul_w8a16_plain(torch.from_numpy(x), tw, 0, eps=1e-6, **tkw), ref)


def test_bf16_activations_and_leading_dims():
    """bf16 x (the residual stream) with a [B, S, N] shape."""
    jw, tw, rng = _weights(7)
    x = rng.normal(0, 1, (2, 3, N)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    nw = (1.0 + 0.1 * rng.normal(0, 1, (L, N))).astype(np.float32)
    ref = qmatmul_pallas_stacked_fused(
        xj, jw, 1, norm_w=jnp.asarray(nw), interpret=True, impl="scale_w"
    )
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = qmatmul_w8a16(xt, tw, 1, norm_w=torch.from_numpy(nw))
    assert out.shape == (2, 3, D) and out.dtype == torch.float32
    _close(out, ref)


def test_weight_products_round_to_bf16():
    """General bf16 scales: the plain version equals x_bf16 · bf16(code · scale)
    summed in f64, up to f32 summation order."""
    rng = np.random.default_rng(11)
    codes = rng.integers(-127, 128, (N, D)).astype(np.int8)
    scales = torch.from_numpy(rng.uniform(0.001, 0.02, (N // G, D)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (3, N)).astype(np.float32))
    sb = scales.to(torch.bfloat16)
    w = (torch.from_numpy(codes).float() * sb.float().repeat_interleave(G, 0)).to(torch.bfloat16)
    ref = x.to(torch.bfloat16).double() @ w.double()
    out = qmatmul_w8a16_plain(x, QuantizedTensor(torch.from_numpy(codes), sb))
    assert float((out.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    exact_w = torch.from_numpy(codes).double() * sb.double().repeat_interleave(G, 0)
    unrounded = x.to(torch.bfloat16).double() @ exact_w
    # The rounding is visible at this tolerance, so the check above has teeth.
    assert float((out.double() - unrounded).abs().max()) > 1e-4 * float(ref.abs().max())


def test_cpu_wrapper_is_the_plain_version():
    _, tw, rng = _weights(3)
    x = torch.from_numpy(rng.normal(0, 1, (4, N)).astype(np.float32))
    from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES

    before = LAUNCHES["qmatmul_w8a16"]
    got = qmatmul_w8a16(x, tw, 0)
    assert torch.equal(got, qmatmul_w8a16_plain(x, tw, 0))
    assert LAUNCHES["qmatmul_w8a16"] == before  # plain calls are not launches


@pytest.mark.parametrize("rows", [1, 7, MAX_ROWS])
def test_split_plan_covers_the_contraction_at_8b(rows):
    c = QWEN3_CONFIGS["8b"]
    ah, kvd = c["n_heads"] * c["head_dim"], c["n_kv_heads"] * c["head_dim"]
    shapes = [
        (c["dim"], ah + 2 * kvd), (ah, c["dim"]), (c["dim"], 2 * c["hidden_dim"]),
        (c["hidden_dim"], c["dim"]), (c["dim"], 153600),
    ]
    for n, d in shapes:
        bt = 1 if rows == 1 else 8
        splits, kc = split_plan(n, d, rows, bt, 132)
        assert kc % 4 == 0 and (kc % 64 == 0 or kc == n)
        assert (splits - 1) * kc < n <= splits * kc
        blocks = -(-d // 512) * -(-rows // bt) * splits
        assert blocks >= 132 or splits * 64 >= n
