"""Synthetic model builders for smoke runs and measurements."""

from __future__ import annotations

import torch

from .checkpoint import VOCAB_PAD_MULTIPLE
from .configuration import ARCHITECTURE_QWEN3, ModelConfig
from .device import resolve_device
from .models.qwen3 import Qwen3LayerWeights, Qwen3Weights
from .ops.quant import QuantizedTensor

# Real Qwen3 family shapes (HF configs).
QWEN3_CONFIGS = {
    "0.6b": dict(dim=1024, hidden_dim=3072, n_layers=28, n_heads=16, n_kv_heads=8,
                 head_dim=128, vocab_size=151936),
    "1.7b": dict(dim=2048, hidden_dim=6144, n_layers=28, n_heads=16, n_kv_heads=8,
                 head_dim=128, vocab_size=151936),
    "4b": dict(dim=2560, hidden_dim=9728, n_layers=36, n_heads=32, n_kv_heads=8,
               head_dim=128, vocab_size=151936),
    "8b": dict(dim=4096, hidden_dim=12288, n_layers=36, n_heads=32, n_kv_heads=8,
               head_dim=128, vocab_size=151936),
}


def qwen3_config(name: str = "0.6b", seq_len: int = 4096, group_size: int = 64,
                 n_layers: int | None = None) -> ModelConfig:
    base = dict(QWEN3_CONFIGS[name])
    if n_layers is not None:
        base["n_layers"] = n_layers
    return ModelConfig(
        architecture_id=ARCHITECTURE_QWEN3,
        seq_len=seq_len,
        group_size=group_size,
        shared_classifier=True,
        **base,
    ).validate()


def padded_vocab(vocab_size: int) -> int:
    """The classifier's out axis as the checkpoint loader pads it."""
    if vocab_size >= VOCAB_PAD_MULTIPLE and vocab_size % VOCAB_PAD_MULTIPLE:
        return vocab_size + VOCAB_PAD_MULTIPLE - vocab_size % VOCAB_PAD_MULTIPLE
    return vocab_size


def random_weights(config: ModelConfig, seed: int = 0, device=None) -> Qwen3Weights:
    """Random INT8 weights with plausible scales, drawn on ``device`` (the
    card unless the caller asks for the CPU) from a ``torch.Generator``.

    Codes are uniform int8 with -128 folded to 0 (the Q8_0 range is ±127),
    scales uniform in [0, 0.02), norm weights 1 + 0.02·N(0, 1).  Linear
    weights are in-major; the classifier is the transposed embedding with its
    vocab axis padded as the loader pads it (zero codes, unit scales).
    """
    dev = resolve_device(device)
    c = config
    g = c.group_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def codes(*shape):
        out = torch.empty(shape, dtype=torch.int8, device=dev)
        for part in out.view(-1, *shape[-2:]):  # one matrix at a time bounds the temporaries
            part.random_(-128, 128, generator=gen)
            part.masked_fill_(part == -128, 0)
        return out

    def scales(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 0.02

    def norm(*shape):
        return 1.0 + 0.02 * torch.randn(shape, generator=gen, device=dev)

    def stack(in_dim, out_dim):
        return QuantizedTensor(
            codes(c.n_layers, in_dim, out_dim), scales(c.n_layers, in_dim // g, out_dim)
        )

    embed = QuantizedTensor(codes(c.vocab_size, c.dim), scales(c.vocab_size, c.dim // g))
    v_pad = padded_vocab(c.vocab_size)
    lm_q = torch.zeros(c.dim, v_pad, dtype=torch.int8, device=dev)
    lm_q[:, : c.vocab_size] = embed.q.T
    lm_s = torch.ones(c.dim // g, v_pad, dtype=torch.float32, device=dev)
    lm_s[:, : c.vocab_size] = embed.scales.T
    layers = Qwen3LayerWeights(
        rms_att=norm(c.n_layers, c.dim),
        rms_ffn=norm(c.n_layers, c.dim),
        q_norm=norm(c.n_layers, c.head_dim),
        k_norm=norm(c.n_layers, c.head_dim),
        wqkv=stack(c.dim, c.all_heads_dim + 2 * c.kv_dim),
        wo=stack(c.all_heads_dim, c.dim),
        w13=stack(c.dim, 2 * c.hidden_dim),
        w2=stack(c.hidden_dim, c.dim),
    )
    return Qwen3Weights(
        embed=embed, layers=layers, rms_final=norm(c.dim), lm_head=QuantizedTensor(lm_q, lm_s)
    )


def weight_bytes_per_decode_token(config: ModelConfig, scale_bytes: int = 4) -> int:
    """Device-memory bytes of weights and scales streamed per decode step.

    The embedding gather reads one row; the classifier reads all of lm_head
    (counted at ``vocab_size`` columns, without the padding).
    ``scale_bytes``: the per-group scale width streamed (4 = f32 checkpoint
    scales, 2 = the fast engine's bf16 cast).
    """
    c = config
    scale_per_param = scale_bytes / c.group_size
    per_layer = (
        c.dim * c.all_heads_dim  # wq
        + 2 * c.dim * c.kv_dim  # wk, wv
        + c.all_heads_dim * c.dim  # wo
        + 3 * c.dim * c.hidden_dim  # w1, w2, w3
    )
    linear = c.n_layers * per_layer
    head = c.vocab_size * c.dim
    return int(linear * (1.0 + scale_per_param) + head * (1.0 + scale_per_param))
