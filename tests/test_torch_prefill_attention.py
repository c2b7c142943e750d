"""Causal prefill attention: the port's plain version against the JAX
package's ``causal_prefill_attention`` (the splash kernel) in interpret mode.

Both scale q by ``bf16(1/√128)`` and round it to bf16, take scores and the
softmax in f32 and round the normalised output to bf16.  The f32 sums run in
another order, which can flip the output's bf16 rounding: tolerance one bf16
step per element, counted on the ordered bit patterns of the two bf16 values
(a relative bound of ``2^-7 · |ref|`` sits exactly on one step for values at
a power of two, where a host's last-bit difference in an f32 sum or ``exp``
tips it over).  Outputs that cancel to near zero carry the sums' absolute
noise instead, which spans many bf16 steps there: they keep the absolute
tolerance of 1e-6.  The splash kernel needs its window to be
a multiple of 128 rows; a ragged window is held against the first rows of a
longer one, which causal attention leaves unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_rs_tpu.ops.pallas.prefill_attention import causal_prefill_attention as jax_prefill
from qwen3_rs_tpu_torch.ops.attention import gqa_attention_split
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import (
    causal_prefill_attention,
    causal_prefill_attention_plain,
    q_scale,
)

torch.set_num_threads(2)

HD = 128
ATOL = 1e-6


def _inputs(seed, b, s, n_kv, kv_mul, hd=HD):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, n_kv * kv_mul, hd), (b, s, n_kv, hd), (b, s, n_kv, hd)]
    return [jnp.asarray(rng.normal(0, 1.5, sh).astype(np.float32)).astype(jnp.bfloat16) for sh in shapes]


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns → integers in the order of their values (±0 → 0):
    neighbouring bf16 values differ by 1."""
    bits = bits.astype(np.int32)
    mag = bits & 0x7FFF
    return np.where(bits & 0x8000, -mag, mag)


def _close(out, ref, atol=ATOL):
    assert out.dtype == torch.bfloat16
    ref = jnp.asarray(ref).astype(jnp.bfloat16)
    a = out.contiguous().view(torch.int16).numpy().view(np.uint16)
    b = np.asarray(ref).view(np.uint16)
    assert a.shape == b.shape
    steps = np.abs(_ordered(a) - _ordered(b))
    noise = np.abs(out.float().numpy() - np.asarray(ref, np.float32)) <= atol
    assert ((steps <= 1) | noise).all(), (int(steps.max()), int((steps > 1).sum()))


@pytest.mark.parametrize("s,n_kv,kv_mul", [(512, 2, 4), (384, 1, 2), (512, 1, 8)])
def test_plain_matches_splash_interpret(s, n_kv, kv_mul):
    q, k, v = _inputs(s + kv_mul, 1, s, n_kv, kv_mul)
    ref = jax_prefill(q, k, v, interpret=True)
    out = causal_prefill_attention_plain(_torch(q), _torch(k), _torch(v))
    _close(out, ref)


@pytest.mark.parametrize("hd", [384, 640])
def test_plain_matches_splash_interpret_past_256(hd):
    """The plain version at the head_dims the kernel past 256 takes (one
    column slice at 384, two at 640) against the splash kernel: one kv head,
    two query heads, a 512-row window.  Outputs that cancel to near zero
    keep the absolute tolerance the card tests hold the kernel to (1e-5):
    the f32 scores' sums over the longer head move such outputs by up to
    ~2e-6 here, past 1e-6 (one element in ~400,000 at this seed)."""
    q, k, v = _inputs(hd, 1, 512, 1, 2, hd)
    ref = jax_prefill(q, k, v, interpret=True)
    out = causal_prefill_attention_plain(_torch(q), _torch(k), _torch(v))
    _close(out, ref, atol=1e-5)


@pytest.mark.parametrize("s", [300, 1])
def test_ragged_window_matches_the_first_rows_of_a_longer_one(s):
    q, k, v = _inputs(7, 2, 384, 2, 4)
    ref = jax_prefill(q, k, v, interpret=True)[:, :s]
    out = causal_prefill_attention_plain(_torch(q[:, :s]), _torch(k[:, :s]), _torch(v[:, :s]))
    _close(out, ref)


def test_q_is_scaled_in_bf16():
    """The reference multiplies a bf16 q by the scale taken to bf16: 2^-3.5
    is not a power of two, so that product rounds."""
    assert q_scale(HD) == 0.08837890625 != 1 / HD**0.5
    q = torch.full((1, 1, 1, HD), 1.5, dtype=torch.bfloat16)
    k = torch.zeros(1, 1, 1, HD, dtype=torch.bfloat16)
    v = torch.arange(HD, dtype=torch.float32).reshape(1, 1, 1, HD).to(torch.bfloat16)
    assert torch.equal(causal_prefill_attention_plain(q, k, v), v)  # one key: its value


def test_plain_agrees_with_split_attention_at_position_zero():
    """The plain split attention (f32 q, scale after the dot) differs only
    by the bf16 roundings of the scaled q and of the output."""
    q, k, v = (_torch(t) for t in _inputs(3, 1, 600, 2, 4))
    out = causal_prefill_attention_plain(q, k, v).float()
    cache = torch.zeros(1, 2, 8, HD)
    ref = gqa_attention_split(q.float(), cache, cache, k.float(), v.float(), [0])
    assert float((out - ref).abs().max()) <= 2e-2 * float(ref.abs().max())


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = (_torch(t) for t in _inputs(4, 1, 260, 1, 4))
    before = LAUNCHES["causal_prefill_attention"]
    assert torch.equal(causal_prefill_attention(q, k, v), causal_prefill_attention_plain(q, k, v))
    assert LAUNCHES["causal_prefill_attention"] == before


@pytest.mark.parametrize("hd,plan", [
    (384, dict(npv=3, slices=1, qres=1, vstages=4, kslots=16, smem=231776)),
    (512, dict(npv=2, slices=2, qres=1, vstages=4, kslots=16, smem=215392)),
    (640, dict(npv=3, slices=2, qres=1, vstages=4, kslots=8, smem=231776)),
    (1024, dict(npv=3, slices=3, qres=1, vstages=2, kslots=8, smem=231776)),
    (1408, dict(npv=3, slices=4, qres=0, vstages=4, kslots=16, smem=199008)),
])
def test_wide_plan_hand_worked(hd, plan):
    """The kernel past 256's block (``wide_plan``, the source's ``plan_of``;
    a card test holds them equal) against cases worked by hand: 18,784
    fixed bytes (1 KB of alignment, two 8 KB P buffers, their 1 KB of rescale
    factors and sums, 352 bytes of barriers), q 128·hd bytes where resident,
    each V stage npv·8 KB, each K slot 4 KB, at most 232,448 in all; e.g. 640:
    five column pieces in two slices of three, q 81,920, four V stages 98,304,
    then 33,440 bytes left: eight slots."""
    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import wide_plan

    assert wide_plan(hd) == plan


def test_wide_plan_covers_the_head_and_fits():
    """At every head_dim past 256 up to 4096: the slices' P.V warpgroups cover
    the column pieces with fewer than one slice to spare, at most three a block
    (a fourth leaves 80 registers a thread), the shared memory fits, and the
    head_dims 128 and 256 and the others are refused."""
    from qwen3_rs_tpu_torch.ops.kernels.prefill_attention import SMEM_MAX, WIDE_MAX_PV, wide_plan

    for hd in range(384, 4097, 128):
        p = wide_plan(hd)
        pieces = hd // 128
        assert (p["slices"] - 1) * p["npv"] < pieces <= p["slices"] * p["npv"] and p["npv"] <= WIDE_MAX_PV
        assert p["smem"] <= SMEM_MAX and p["kslots"] >= 4 and p["vstages"] >= 1
        assert p["qres"] == (hd <= 1280)
    for hd in (128, 256, 320, 0):
        with pytest.raises(ValueError):
            wide_plan(hd)
