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
from qwen3_rs_tpu_torch.ops.kernels.flash_attention import (
    decode_supported,
    flash_decode,
    flash_decode_plain,
    flash_decode_two_pass,
    one_launch_takes,
)
from qwen3_rs_tpu_torch.ops.kernels.paged_attention import WIDE_MAX_HEAD_DIM, paged_decode_plain

torch.set_num_threads(2)

L, N_KV, HD, T = 2, 2, 128, 384  # T = 3 blocks of 128 in the Pallas kernel
BLK = 128
POS = [0, 1, BLK + 3, T - 1]  # one batch row each
TOL = 1e-5


def _inputs(seed, kv_mul, cache, hd=HD):
    rng = np.random.default_rng(seed)
    b, h = len(POS), N_KV * kv_mul
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    kn = rng.normal(0, 1, (b, N_KV, hd)).astype(np.float32)
    vn = rng.normal(0, 1, (b, N_KV, hd)).astype(np.float32)
    shape = (L, b, N_KV, T, hd)
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
    _plain_matches_flash_gqa_decode_stacked(kv_mul, cache, HD, kv_mul)


@pytest.mark.parametrize("hd", [384, 640])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_plain_matches_flash_gqa_decode_stacked_past_256(hd, cache):
    """As above at head_dims the decode kernel past 256 takes, 3 query heads
    a kv head (one head tile there)."""
    _plain_matches_flash_gqa_decode_stacked(3, cache, hd, 31 + hd)


def _plain_matches_flash_gqa_decode_stacked(kv_mul, cache, hd, seed):
    q, kn, vn, k, v, scales = _inputs(seed, kv_mul, cache, hd)
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
    assert torch.equal(flash_decode_two_pass(*args, pos, 1), flash_decode_plain(*args, pos, 1))
    assert LAUNCHES["flash_decode"] == before


@pytest.mark.parametrize("pos", [[0, 0, 0, 0], POS, [5, T, 17, 300]])
@pytest.mark.parametrize("kv_mul", [1, 2, 4])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_dense_layer_as_pages_is_the_plain_version(cache, kv_mul, pos):
    """The one-launch kernel's view of the dense cache: the layer
    ``[B, n_kv, T, hd]`` as a pool of B pages of T rows with the table
    ``arange(B)[:, None]``.  The paged kernel's plain version over that view
    equals ``flash_decode_plain`` (which the test above holds to the JAX
    kernel) at pos 0 and ragged positions, T among them."""
    q, kn, vn, k, v, scales = _inputs(20 + kv_mul, kv_mul, cache)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if cache == "bf16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (q, kn, vn)]
    p = torch.tensor(pos, dtype=torch.int32)
    table = torch.arange(len(pos), dtype=torch.int32)[:, None]
    ref = flash_decode_plain(*args, tk, tv, p, 1, **{n: torch.from_numpy(s) for n, s in scales.items()})
    got = paged_decode_plain(*args, tk, tv, table, p, 1,
                             **{n.replace("_all", "_pool"): torch.from_numpy(s) for n, s in scales.items()})
    assert float((got - ref).abs().max()) <= TOL * max(1.0, float(ref.abs().max()))
    for b, pb in enumerate(pos):
        if pb == 0:
            assert torch.equal(got[b], ref[b])


def test_one_launch_takes_the_split_kernels_shapes():
    """``flash_decode`` takes the one-launch kernel exactly where the paged
    kernel would take a page of T rows: every head_dim that is a multiple of
    128 up to 1024 (past 256 the kernel past 256) and T a multiple of 16
    (every T the JAX gate admits, a multiple of 128, included), over f32,
    bf16 and INT8 caches alike (an INT8 cache took the two-pass kernel until
    its stage split q and P into three bf16 terms); the two-pass kernel keeps
    the other T and head_dims past 1024."""
    for hd in (128, 256, 384, 512, 640, 1024, 1152):
        for t in (16, 200, 208, 384, 4096, 4100):
            assert one_launch_takes(hd, t) == (hd <= WIDE_MAX_HEAD_DIM and t % 16 == 0)
            if decode_supported(32, 8, hd, t, min_seq_len=0) and hd <= WIDE_MAX_HEAD_DIM:
                assert one_launch_takes(hd, t)
