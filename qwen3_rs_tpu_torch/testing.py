"""Synthetic model builders for smoke runs and measurements."""

from __future__ import annotations

import torch

from .checkpoint import VOCAB_PAD_MULTIPLE
from .configuration import ARCHITECTURE_QWEN3, ModelConfig
from .device import resolve_device
from .models.qwen3 import Qwen3LayerWeights, Qwen3Weights
from .ops.quant import Q4Tensor, QuantizedTensor

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


def random_weights(config: ModelConfig, seed: int = 0, device=None, bits: int = 8) -> Qwen3Weights:
    """Random INT8 (or, with ``bits=4``, INT4 linear) weights with plausible
    scales, drawn on ``device`` (the card unless the caller asks for the CPU)
    from a ``torch.Generator``.

    Codes are uniform int8 with -128 folded to 0 (the Q8_0 range is ±127);
    INT4 codes are uniform random bytes, each two packed codes (so nibble 0,
    code -8, occurs too).  Scales uniform in [0, 0.02), norm weights
    1 + 0.02·N(0, 1).  Linear weights are in-major; the embedding and the
    classifier stay INT8, the classifier the transposed embedding with its
    vocab axis padded as the loader pads it (zero codes, unit scales).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
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

    def packed(*shape):
        out = torch.empty(shape, dtype=torch.uint8, device=dev)
        for part in out.view(-1, *shape[-2:]):
            part.random_(0, 256, generator=gen)
        return out

    def stack(in_dim, out_dim):
        if bits == 4:
            return Q4Tensor(packed(c.n_layers, in_dim // 2, out_dim), scales(c.n_layers, in_dim // g, out_dim))
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


def random_model(config: ModelConfig, seed: int = 0, device=None, bits: int = 8):
    """``(config, random_weights(...))``: a weight source for a
    tensor-parallel engine's ranks (``serving.scheduler.start_tp_engine``),
    each of which draws the same weights and keeps its shard."""
    return config, random_weights(config, seed=seed, device=device, bits=bits)


def weight_bytes_per_decode_token(config: ModelConfig, scale_bytes: int = 4, bits: int = 8) -> int:
    """Device-memory bytes of weights and scales streamed per decode step.

    The embedding gather reads one row; the classifier reads all of lm_head
    (counted at ``vocab_size`` columns, without the padding).
    ``scale_bytes``: the per-group scale width streamed (4 = f32 checkpoint
    scales, 2 = the fast engine's bf16 cast).  ``bits``: the linear layers'
    code width (4 = nibble-packed INT4; the classifier stays INT8).
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
    return int(linear * (bits / 8.0 + scale_per_param) + head * (1.0 + scale_per_param))


def prefill_flops(config: ModelConfig, s: int, batch: int = 1) -> float:
    """MAC-derived FLOPs of one prefill forward (compute roofline input).

    Linear layers: 2 FLOPs per weight param per token.  Attention: the QKᵀ
    and PV causal contractions do ~S²/2 useful positions each per (layer,
    head), 2·head_dim MACs per position.  The classifier head runs on one
    row per request (logits are only fetched for the last real row).
    """
    c = config
    per_layer = (
        c.dim * (c.all_heads_dim + 2 * c.kv_dim)  # wqkv
        + c.all_heads_dim * c.dim  # wo
        + 3 * c.dim * c.hidden_dim  # w13, w2
    )
    linear = 2.0 * c.n_layers * per_layer * s
    attn = 2.0 * c.n_layers * c.n_heads * 2 * (s * s / 2.0) * c.head_dim
    head = 2.0 * c.dim * c.vocab_size  # one row per request
    return batch * (linear + attn + head)


def prefill_ops(config: ModelConfig, rows: int, cache_rows: int = 0) -> dict:
    """Operations (multiply and add counted apart) of one prefill window of
    ``rows`` rows after ``cache_rows`` cached rows, b = 1: the projections of
    every layer at 2 per weight per row, the causal attention at 4·hd per
    (query head, query row, visible key) (Q·Kᵀ and P·V), and the classifier
    on the window's last row.  Over the bf16 tensor-core rate it gives the
    least time the card could take for the window."""
    c = config
    per_layer = (
        c.dim * (c.all_heads_dim + 2 * c.kv_dim)  # wqkv
        + c.all_heads_dim * c.dim  # wo
        + 3 * c.dim * c.hidden_dim  # w13, w2
    )
    visible = rows * cache_rows + rows * (rows + 1) // 2  # (query, key) pairs with key <= query
    out = {
        "projections": 2 * rows * per_layer * c.n_layers,
        "attention": 4 * visible * c.head_dim * c.n_heads * c.n_layers,
        "classifier": 2 * c.dim * c.vocab_size,
    }
    out["total"] = sum(out.values())
    return out


def _kv_row_bytes(head_dim: int, elem_bytes: int) -> int:
    """Bytes of one K (or V) row of one kv head: ``elem_bytes`` 4 = f32,
    2 = bf16, 1 = INT8, which adds its f32 row scale."""
    return head_dim * elem_bytes + (4 if elem_bytes == 1 else 0)


def paged_pool_bytes(config: ModelConfig, n_pages: int, page_size: int, elem_bytes: int) -> int:
    """Device bytes of a K/V page pool of ``n_pages`` pages of ``page_size``
    rows, every layer."""
    rows = config.n_layers * n_pages * config.n_kv_heads * page_size
    return 2 * rows * _kv_row_bytes(config.head_dim, elem_bytes)


def paged_read_bytes(pos, n_kv: int, head_dim: int, elem_bytes: int) -> int:
    """K/V bytes a paged attention kernel must read for one layer: the rows
    below each request's position, once each (with an INT8 pool's row
    scales).  The least input of kernels #9 and #10; their query, output
    and page-table bytes come on top."""
    return 2 * sum(int(p) for p in pos) * n_kv * _kv_row_bytes(head_dim, elem_bytes)


def megakernel_bytes(config: ModelConfig, pos, elem_bytes: int, written: int, v_pad: int | None = None,
                     bits: int = 8) -> int:
    """Least device-memory bytes of one decode step through the megakernel
    (kernel #11) for rows at positions ``pos``: the weights and their bf16
    scales once (``weight_bytes_per_decode_token``, the classifier only with
    ``v_pad``; ``bits=4``: INT4 layers), the cache rows below each position
    read once (every layer, K and V; ``elem_bytes`` as in
    ``paged_read_bytes``), the ``written`` rows' K/V written once, and the f32
    stream in and out and the logits out."""
    c = config
    weights = weight_bytes_per_decode_token(c, scale_bytes=2, bits=bits)
    if v_pad is None:
        weights -= int(c.vocab_size * c.dim * (1.0 + 2 / c.group_size))
    rows = sum(min(int(p), c.seq_len) for p in pos) + written
    kv = 2 * c.n_layers * c.n_kv_heads * rows * _kv_row_bytes(c.head_dim, elem_bytes)
    return weights + kv + 2 * len(pos) * c.dim * 4 + (len(pos) * v_pad * 4 if v_pad else 0)


def rows_cols_counts(rows: int, n: int, dc: int, group_size: int) -> tuple[int, float]:
    """(bytes, operations) of a column window ``[c0, c0+dc)`` of the
    row-blocked W8A16 product (#6's ``out_cols``): the window's int8 codes
    and bf16 scales, the bf16 activations ``[rows, n]`` and the f32 output
    ``[rows, dc]``, each moved once; ``2·rows·n·dc`` multiply-adds."""
    return n * dc + (n // group_size) * dc * 2 + rows * n * 2 + rows * dc * 4, 2.0 * rows * n * dc
