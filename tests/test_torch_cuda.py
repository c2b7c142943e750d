"""The port's CUDA kernels against their plain versions, on the card, at
small and ragged shapes (the 8B shapes are ``chip_smoke.py``'s).

Marked ``cuda``: without a card every test skips.  It imports neither JAX
nor the repository's conftest, so on a machine with a card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from qwen3_rs_tpu_torch.configuration import ModelConfig
from qwen3_rs_tpu_torch.inference.engine import Engine
from qwen3_rs_tpu_torch.models.qwen3 import weights_to
from qwen3_rs_tpu_torch.ops.kernels import LAUNCHES
from qwen3_rs_tpu_torch.ops.kernels.flash_attention import flash_decode, flash_decode_plain
from qwen3_rs_tpu_torch.ops.kernels.qmatmul import qmatmul_w8a16, qmatmul_w8a16_plain
from qwen3_rs_tpu_torch.ops.quant import QuantizedTensor
from qwen3_rs_tpu_torch.testing import random_weights

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("rows", [1, 2, 3, 8, 9, 37, 256])
@pytest.mark.parametrize(
    "n,d,g,prologue,residual",
    [
        (256, 48, 64, None, None),  # D below one 512-column strip
        (512, 1040, 16, "rms", None),  # ragged last strip, g = 16
        (1024, 512, 64, "swiglu", "bf16"),
        (4096, 4096, 64, None, "f32"),  # split contraction + residual added once
    ],
)
def test_qmatmul_matches_plain(card, rows, n, d, g, prologue, residual):
    gen = _gen(rows * 7 + d)
    layers = 3
    codes = torch.randint(-127, 128, (layers, n, d), generator=gen, device=card, dtype=torch.int8)
    scales = (torch.rand(layers, n // g, d, generator=gen, device=card) * 0.02).to(torch.bfloat16)
    w = QuantizedTensor(codes, scales)
    width = 2 * n if prologue == "swiglu" else n
    x = torch.randn(rows, width, generator=gen, device=card)
    kw = {}
    if prologue == "rms":
        kw["norm_w"] = 1 + 0.1 * torch.randn(layers, n, generator=gen, device=card)
    if prologue == "swiglu":
        kw["swiglu"] = True
    if residual:
        dt = torch.float32 if residual == "f32" else torch.bfloat16
        kw["residual"] = torch.randn(rows, d, generator=gen, device=card).to(dt)
    before = LAUNCHES["qmatmul_w8a16"]
    got = qmatmul_w8a16(x, w, 2, **kw)
    assert LAUNCHES["qmatmul_w8a16"] == before + 1
    ref = qmatmul_w8a16_plain(x, w, 2, **kw)
    torch.cuda.synchronize()
    # f32 sums in another order; a prologue may flip a bf16 rounding.
    rel = 2e-3 if prologue else 1e-4
    assert float((got - ref).abs().max()) <= rel * float(ref.abs().max())


def test_qmatmul_unstacked_classifier_shape(card):
    gen = _gen(5)
    n, d = 256, 4096
    w = QuantizedTensor(
        torch.randint(-127, 128, (n, d), generator=gen, device=card, dtype=torch.int8),
        (torch.rand(n // 64, d, generator=gen, device=card) * 0.02).to(torch.bfloat16),
    )
    x = torch.randn(1, n, generator=gen, device=card).to(torch.bfloat16)
    got, ref = qmatmul_w8a16(x, w), qmatmul_w8a16_plain(x, w)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_qmatmul_refuses_what_it_cannot_take(card):
    w = QuantizedTensor(
        torch.zeros(2, 128, 64, dtype=torch.int8, device=card),
        torch.ones(2, 2, 64, dtype=torch.bfloat16, device=card),
    )
    with pytest.raises(ValueError, match="activation rows"):
        qmatmul_w8a16(torch.zeros(257, 128, device=card), w, 0)
    with pytest.raises(ValueError, match="bf16"):
        qmatmul_w8a16(torch.zeros(1, 128, device=card), QuantizedTensor(w.q, w.scales.float()), 0)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kv_mul", [1, 2, 4, 8])
def test_flash_decode_matches_plain(card, cache, kv_mul):
    gen = _gen(kv_mul * 3 + len(cache))
    layers, n_kv, t, hd = 2, 2, 200, 128  # T not a multiple of the 128-row chunk
    pos_list = [0, 1, 127, 128, 129, t]
    b = len(pos_list)
    shape = (layers, b, n_kv, t, hd)
    sc = {}
    if cache == "int8":
        k_all = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        v_all = torch.randint(-127, 128, shape, generator=gen, device=card, dtype=torch.int8)
        sc = {name: torch.rand(shape[:-1], generator=gen, device=card) * 0.02 + 0.005
              for name in ("k_scale_all", "v_scale_all")}
    else:
        dt = torch.float32 if cache == "f32" else torch.bfloat16
        k_all = torch.randn(shape, generator=gen, device=card).to(dt)
        v_all = torch.randn(shape, generator=gen, device=card).to(dt)
    q = torch.randn(b, n_kv * kv_mul, hd, generator=gen, device=card)
    kn = torch.randn(b, n_kv, hd, generator=gen, device=card)
    vn = torch.randn(b, n_kv, hd, generator=gen, device=card)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=card)
    got = flash_decode(q, kn, vn, k_all, v_all, pos, 1, **sc)
    ref = flash_decode_plain(q, kn, vn, k_all, v_all, pos, 1, **sc)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5
    assert torch.equal(got[0], vn[0].repeat_interleave(kv_mul, dim=0))  # pos 0: v_self


def test_flash_decode_reads_no_row_at_or_past_pos(card):
    gen = _gen(11)
    shape = (1, 3, 2, 300, 128)
    k_all = torch.randn(shape, generator=gen, device=card)
    v_all = torch.randn(shape, generator=gen, device=card)
    pos_list = [0, 5, 260]
    for b, p in enumerate(pos_list):
        k_all[:, b, :, p:] = float("nan")
        v_all[:, b, :, p:] = float("nan")
    q = torch.randn(3, 8, 128, generator=gen, device=card)
    kn, vn = torch.randn(2, 3, 2, 128, generator=gen, device=card)
    out = flash_decode(q, kn, vn, k_all, v_all, torch.tensor(pos_list, dtype=torch.int32, device=card), 0)
    assert bool(torch.isfinite(out).all())


def test_small_model_card_matches_cpu(card):
    cfg = ModelConfig(
        architecture_id=1, dim=256, hidden_dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, seq_len=300, vocab_size=2176, group_size=64, shared_classifier=True,
    )
    weights = random_weights(cfg, seed=3, device=card)
    gpu = Engine(config=cfg, weights=weights, device=card)
    cpu = Engine(config=cfg, weights=weights_to(weights, "cpu"), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 40))
    caches = [gpu.new_cache(), cpu.new_cache()]
    lg, caches[0] = gpu.prefill(caches[0], prompt, [0])
    lc, caches[1] = cpu.prefill(caches[1], prompt, [0])
    for step in range(6):
        a, b = lg.float().cpu(), lc.float()
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max()), step
        tok = [int(b.argmax())]
        lg, caches[0] = gpu.decode_step(caches[0], tok, [40 + step])
        lc, caches[1] = cpu.decode_step(caches[1], tok, [40 + step])
