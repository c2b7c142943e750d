"""Decode attention: the port's plain version against the JAX package's
``flash_gqa_decode_stacked`` run in interpret mode.

f32 throughout on both sides (bf16 and INT8 caches are widened to f32 as they
are read), one softmax over the same scores: tolerance 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.pallas.flash_attention import flash_gqa_decode_stacked
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.flash_attention import flash_decode, flash_decode_plain

torch.set_num_threads(2)

L, N_KV, HD, T = 2, 2, 128, 384  # T = 3 blocks of 128 in the Pallas kernel
BLK = 128
POS = [0, 1, BLK + 3, T - 1]  # one batch row each
TOL = 1e-5


def _inputs(seed, kv_mul, cache):
    rng = np.random.default_rng(seed)
    b, h = len(POS), N_KV * kv_mul
    q = rng.normal(0, 1, (b, h, HD)).astype(np.float32)
    kn = rng.normal(0, 1, (b, N_KV, HD)).astype(np.float32)
    vn = rng.normal(0, 1, (b, N_KV, HD)).astype(np.float32)
    shape = (L, b, N_KV, T, HD)
    scales = {}
    if cache == "int8":
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        scales = {
            "k_scale_all": rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32),
            "v_scale_all": rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32),
        }
    else:
        k = rng.normal(0, 1, shape).astype(np.float32)
        v = rng.normal(0, 1, shape).astype(np.float32)
    return q, kn, vn, k, v, scales


@pytest.mark.parametrize("kv_mul", [1, 2, 4])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_plain_matches_flash_gqa_decode_stacked(kv_mul, cache):
    q, kn, vn, k, v, scales = _inputs(kv_mul, kv_mul, cache)
    pos = np.asarray(POS, np.int32)
    layer = 1
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if cache == "bf16":
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    ref = flash_gqa_decode_stacked(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jk, jv, jnp.asarray(pos), layer,
        interpret=True, **{n: jnp.asarray(s) for n, s in scales.items()},
    )
    out = flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
        torch.from_numpy(pos), layer, **{n: torch.from_numpy(s) for n, s in scales.items()},
    )
    ref = np.asarray(ref)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    # pos 0 attends to the self key only: the output is v_self.
    np.testing.assert_array_equal(
        out[0].numpy(), np.repeat(vn[0], kv_mul, axis=0)
    )


def test_rows_at_or_past_pos_are_not_read():
    """NaN in every cache row >= pos must not reach the output."""
    q, kn, vn, k, v, _ = _inputs(5, 2, "f32")
    for b, p in enumerate(POS):
        k[:, b, :, p:] = np.nan
        v[:, b, :, p:] = np.nan
    out = flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(k), torch.from_numpy(v), torch.tensor(POS, dtype=torch.int32), 0,
    )
    assert torch.isfinite(out).all()


def test_cpu_wrapper_is_the_plain_version():
    q, kn, vn, k, v, _ = _inputs(9, 4, "f32")
    args = [torch.from_numpy(a) for a in (q, kn, vn, k, v)]
    pos = torch.tensor(POS, dtype=torch.int32)
    before = LAUNCHES["flash_decode"]
    assert torch.equal(flash_decode(*args, pos, 1), flash_decode_plain(*args, pos, 1))
    assert LAUNCHES["flash_decode"] == before
