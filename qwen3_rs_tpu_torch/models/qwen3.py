"""Qwen3 forward pass over stacked per-layer weights and a dense KV cache.

The port of the reference package's ``models/qwen3.py::qwen3_forward`` in
fast mode (W8A16), on the path it takes with its decode megakernel off:
every projection is the fused W8A16 kernel (RMSNorm prologue for wqkv and
w13, residual epilogue for wo and w2, SwiGLU prologue for w2), decode
attention (S = 1) is the flash-decode kernel, and the attention of prefill
windows (S > 1) is the plain split attention.  On CPU tensors the kernel
wrappers run their plain PyTorch versions.

Layouts as in the reference package: linear weights in-major, codes
``[L, in, out]`` with scales ``[L, in/g, out]``; the cache ``[L, B, kv, T, hd]``.
The residual stream is bf16.

Unlike the reference package, which emits the window's K/V rows from its
layer scan and scatters them into the cache once after the last layer, the
port writes each layer's rows into the cache **in place**, right after that
layer's attention.  Layer ``l`` reads only rows ``< pos`` of layer ``l``'s
cache plus the step's own K/V, so the result is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..configuration import ModelConfig
from ..ops.attention import gqa_attention_split
from ..ops.kernels.flash_attention import flash_decode
from ..ops.kernels.qmatmul import qmatmul_w8a16
from ..ops.matmul import qmatmul
from ..ops.norms import rms_norm
from ..ops.quant import QuantizedTensor, dequantize
from ..ops.rope import apply_rope, rope_table


class Qwen3LayerWeights(NamedTuple):
    """Per-layer weights stacked on a leading [n_layers] axis."""

    rms_att: torch.Tensor  # [L, dim] f32
    rms_ffn: torch.Tensor  # [L, dim] f32
    q_norm: torch.Tensor  # [L, head_dim] f32
    k_norm: torch.Tensor  # [L, head_dim] f32
    wqkv: QuantizedTensor  # [L, dim, all_heads_dim + 2·kv_dim]  (q | k | v)
    wo: QuantizedTensor  # [L, all_heads_dim, dim]
    w13: QuantizedTensor  # [L, dim, 2·hidden_dim]  (gate | up)
    w2: QuantizedTensor  # [L, hidden_dim, dim]


class Qwen3Weights(NamedTuple):
    embed: QuantizedTensor  # [vocab, dim] row-major; rows dequantize per token
    layers: Qwen3LayerWeights
    rms_final: torch.Tensor  # [dim] f32
    lm_head: QuantizedTensor  # [dim, vocab_padded] in-major


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, n_kv_heads, T, head_dim]
    v: torch.Tensor

    @property
    def seq_len(self) -> int:
        return self.k.shape[3]


class QuantizedKVCache(NamedTuple):
    """INT8 dense cache: codes plus one symmetric f32 scale per row and head."""

    k: torch.Tensor  # int8 [L, B, n_kv_heads, T, head_dim]
    v: torch.Tensor
    k_scale: torch.Tensor  # f32 [L, B, n_kv_heads, T]
    v_scale: torch.Tensor

    @property
    def seq_len(self) -> int:
        return self.k.shape[3]


def _map_weights(weights: Qwen3Weights, fn_dense, fn_qt) -> Qwen3Weights:
    lw = weights.layers
    return Qwen3Weights(
        embed=QuantizedTensor(fn_dense(weights.embed.q), fn_dense(weights.embed.scales)),
        layers=Qwen3LayerWeights(
            rms_att=fn_dense(lw.rms_att),
            rms_ffn=fn_dense(lw.rms_ffn),
            q_norm=fn_dense(lw.q_norm),
            k_norm=fn_dense(lw.k_norm),
            wqkv=fn_qt(lw.wqkv),
            wo=fn_qt(lw.wo),
            w13=fn_qt(lw.w13),
            w2=fn_qt(lw.w2),
        ),
        rms_final=fn_dense(weights.rms_final),
        lm_head=fn_qt(weights.lm_head),
    )


def weights_to(weights: Qwen3Weights, device) -> Qwen3Weights:
    """Every tensor of ``weights`` on ``device``."""
    return _map_weights(weights, lambda t: t.to(device), lambda qt: qt.to(device))


def cast_weight_scales(weights: Qwen3Weights, dtype=torch.bfloat16) -> Qwen3Weights:
    """Fast mode: the linear layers' scales as bf16.  The kernel rounds every
    scale to bf16 anyway, so this halves the streamed scale bytes without
    changing a result.  Embedding scales stay f32."""
    return _map_weights(
        weights, lambda t: t, lambda qt: QuantizedTensor(qt.q, qt.scales.to(dtype))
    )


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def weights_from_jax_numpy(tree) -> Qwen3Weights:
    """The reference package's ``Qwen3Weights`` with numpy leaves → the
    port's weights (CPU tensors, same layouts, same values)."""

    def qt(t):
        return QuantizedTensor(_from_numpy(t.q), _from_numpy(t.scales))

    lw = tree.layers
    return Qwen3Weights(
        embed=qt(tree.embed),
        layers=Qwen3LayerWeights(
            rms_att=_from_numpy(lw.rms_att),
            rms_ffn=_from_numpy(lw.rms_ffn),
            q_norm=_from_numpy(lw.q_norm),
            k_norm=_from_numpy(lw.k_norm),
            wqkv=qt(lw.wqkv),
            wo=qt(lw.wo),
            w13=qt(lw.w13),
            w2=qt(lw.w2),
        ),
        rms_final=_from_numpy(tree.rms_final),
        lm_head=qt(tree.lm_head),
    )


def init_kv_cache(
    config: ModelConfig,
    batch: int,
    dtype=torch.float32,
    seq_len: int | None = None,
    device="cpu",
) -> KVCache | QuantizedKVCache:
    """Zeroed dense cache; ``dtype="int8"`` builds the quantized cache."""
    t = seq_len or config.seq_len
    shape = (config.n_layers, batch, config.n_kv_heads, t, config.head_dim)
    if dtype == "int8":
        return QuantizedKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def _quant_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row INT8: scale ``max|x| / 127`` over head_dim."""
    xf = x.float()
    sc = xf.abs().amax(dim=-1) / 127.0
    safe = torch.where(sc == 0.0, torch.ones_like(sc), sc)
    return torch.round(xf / safe[..., None]).to(torch.int8), sc


def _write_rows(cache, layer: int, k: torch.Tensor, v: torch.Tensor, pos: np.ndarray) -> None:
    """Write the window's K/V rows ([B, S, kv, hd]) of ``layer`` into the
    cache at each request's offset, in place."""
    s = k.shape[1]
    quant = isinstance(cache, QuantizedKVCache)
    if quant:
        (k, k_sc), (v, v_sc) = _quant_rows(k), _quant_rows(v)
    for b, p in enumerate(pos.tolist()):
        cache.k[layer, b, :, p : p + s] = k[b].transpose(0, 1)
        cache.v[layer, b, :, p : p + s] = v[b].transpose(0, 1)
        if quant:
            cache.k_scale[layer, b, :, p : p + s] = k_sc[b].transpose(0, 1)
            cache.v_scale[layer, b, :, p : p + s] = v_sc[b].transpose(0, 1)


def qwen3_forward(
    config: ModelConfig,
    weights: Qwen3Weights,
    tokens,
    cache: KVCache | QuantizedKVCache,
    pos_start,
    *,
    out_idx=None,
) -> tuple[torch.Tensor, KVCache | QuantizedKVCache]:
    """One model step: prefill when S > 1, decode when S == 1.

    ``tokens`` [B, S] ints; ``pos_start`` [B] host ints, the absolute
    position of each row's first token; ``out_idx`` [B] host ints, the window
    row whose logits are returned (default: the last).  Returns
    (logits [B, vocab_size] f32, cache), the cache updated in place.
    """
    dev = weights.embed.q.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape
    pos = np.asarray(torch.as_tensor(pos_start).cpu(), np.int64).reshape(b)
    t_max = cache.seq_len
    if (pos < 0).any() or (pos + s > t_max).any():
        raise ValueError(
            f"window of {s} rows at positions {pos.tolist()} does not fit the cache of {t_max} rows"
        )
    c = config
    eps = c.norm_eps
    bf16 = torch.bfloat16
    ah, kvd, hd = c.all_heads_dim, c.kv_dim, c.head_dim
    ks_all, vs_all = (cache.k_scale, cache.v_scale) if isinstance(cache, QuantizedKVCache) else (None, None)

    # Embedding: gather the quantized rows, dequantize in f32, round to bf16.
    x = dequantize(QuantizedTensor(weights.embed.q[tokens], weights.embed.scales[tokens]))
    x = x.to(bf16)

    q_pos = torch.as_tensor(pos[:, None] + np.arange(s), device=dev)  # [B, S]
    cos_t, sin_t = rope_table(t_max, hd, c.rope_theta, dev)
    cos = cos_t[q_pos][:, :, None, :]  # [B, S, 1, hd/2]
    sin = sin_t[q_pos][:, :, None, :]
    pos_dev = torch.as_tensor(pos, dtype=torch.int32, device=dev) if s == 1 else None

    lw = weights.layers
    for l in range(c.n_layers):
        qkv = qmatmul_w8a16(x, lw.wqkv, l, norm_w=lw.rms_att, eps=eps)  # f32
        q = qkv[..., :ah].reshape(b, s, c.n_heads, hd)
        k = qkv[..., ah : ah + kvd].reshape(b, s, c.n_kv_heads, hd)
        v = qkv[..., ah + kvd :].reshape(b, s, c.n_kv_heads, hd)
        if c.use_qk_norm:
            q = rms_norm(q, lw.q_norm[l], eps)
            k = rms_norm(k, lw.k_norm[l], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if s == 1:
            att = flash_decode(
                q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, pos_dev, l,
                k_scale_all=ks_all, v_scale_all=vs_all,
            )
        else:
            att = gqa_attention_split(
                q.to(bf16), cache.k[l], cache.v[l], k.to(bf16), v.to(bf16), pos,
                k_scale_cache=None if ks_all is None else ks_all[l],
                v_scale_cache=None if vs_all is None else vs_all[l],
            )
        _write_rows(cache, l, k, v, pos)
        att = att.reshape(b, s, ah)
        x = qmatmul_w8a16(att, lw.wo, l, residual=x).to(bf16)
        gate_up = qmatmul_w8a16(x, lw.w13, l, norm_w=lw.rms_ffn, eps=eps)
        x = qmatmul_w8a16(gate_up, lw.w2, l, swiglu=True, residual=x).to(bf16)

    # Final norm + classifier on one row per request; drop the vocab padding.
    if out_idx is None:
        x = x[:, -1]
    else:
        rows = torch.as_tensor(np.asarray(out_idx, np.int64).reshape(b), device=dev)
        x = x[torch.arange(b, device=dev), rows]
    xn = rms_norm(x, weights.rms_final, eps)
    logits = qmatmul(xn, weights.lm_head)[:, : c.vocab_size]
    return logits, cache
