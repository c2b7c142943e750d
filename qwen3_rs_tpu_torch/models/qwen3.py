"""Qwen3 forward pass over stacked per-layer weights and a dense KV cache or
the serving page pool.

The port of the reference package's ``models/qwen3.py::qwen3_forward``.  A
fast-mode decode step (S = 1) over the dense cache whose shapes pass the
reference's gate (``megakernel_supported``: B ≤ 8, head_dim 128, tileable
widths; at 8B and ctx 4096 it passes) is one launch of the decode megakernel
(``megakernel_step``), the classifier fused where ``head_phase_supported``
admits it; its residual stream is f32.  Every other call takes the per-layer
path, in three modes:

* ``fast`` (W8A16).  Windows of at most 256 rows: every projection is the
  fused W8A16 kernel (RMSNorm prologue for wqkv and w13, residual epilogue
  for wo and w2, SwiGLU prologue for w2).  Longer windows: the RMSNorm,
  SwiGLU and residual adds run outside the projections, which take the
  row-blocked W8A16 kernel, or, where the reference's "xdot" gate admits
  them, the dequant kernel and one bf16 product.  Decode attention (S = 1)
  is the flash-decode kernel (the paged decode kernel on the pool), a fresh
  window (every position 0) of more than 256 rows takes the causal prefill
  kernel, a window on the pool with S·kv_mul ≤ 128 the paged window path
  (its kernel for a continued window's cache part; a fresh window has none),
  and every other window the plain split attention.
* ``exact`` (W8A8, reference parity): activations are quantized per group
  before each projection (``qmatmul_exact``); the residual stream and the
  attention are f32.
* ``f32``: weights dequantized to f32 and full-f32 products (the f32 side of
  the perplexity accuracy bar).

INT4 linear layers (``Q4Tensor``, an INT4 checkpoint) take the same routes
through the Q4 variants of the kernels, as the reference's
``_project_layer`` routes them: the megakernel's Q4 tiles only with the
reference's opt-in (``QWEN3_TPU_MEGA_Q4=1``), the fused Q4 kernel up to 256
rows, the Q4 dequant on the xdot path and the Q4 row-blocked kernel
otherwise; there is no exact mode for them.  The embedding and the
classifier stay INT8.

Every kernel sits behind the reference's shape gate for it, decided from
shapes before any launch; a shape the gate refuses takes the plain PyTorch
path, on the card too (the reference's XLA route there).  The port's kernels
take every shape the gates admit, except a head_dim of 384 or 512 in the
causal prefill kernel: the forward refuses it on the card before any launch
(ROADMAP §3).

Tensor parallelism (``tp_group``, the reference's ``tp_axis``): the weights
and the cache are one rank's shards (``parallel/tp.py``) and ``config`` is
the local config.  The embedding gathers the rank's vocab rows and
all-reduces; the row-parallel projections (wo, w2) all-reduce their f32
partial sums before the residual add (at windows of 512 reference rows or
more in column chunks, each chunk's all-reduce issued as soon as its
product is done, the row-blocked kernel reading only the chunk's columns);
the classifier's vocab columns are all-gathered before the slice to the
vocabulary, so every rank returns the same global logits.  The megakernel
is off under tp, as in the reference.

On CPU tensors the kernel wrappers run their plain PyTorch versions.

Layouts as in the reference package: linear weights in-major, codes
``[L, in, out]`` with scales ``[L, in/g, out]``; the cache ``[L, B, kv, T, hd]``,
the page pool ``[L, P, kv, page, hd]`` (``serving/paged_cache.py``).
The residual stream is bf16 (f32 in exact mode and in the megakernel).

Unlike the reference package, which emits the window's K/V rows from its
layer scan and scatters them into the cache once after the last layer, the
port writes each layer's rows into the cache **in place**, right after that
layer's attention.  Layer ``l`` reads only rows ``< pos`` of layer ``l``'s
cache plus the step's own K/V, and every request of the batch has read its
rows before any row is written, so the result is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..configuration import ModelConfig
from ..device import resolve_device
from ..ops.attention import gqa_attention_split, gqa_attention_split_paged
from ..ops.collectives import all_gather_last, all_reduce, exchange
from ..ops.kernels.flash_attention import decode_supported, flash_decode
from ..ops.kernels.megakernel import decode_stack_megakernel, head_phase_supported, megakernel_supported
from ..ops.kernels.paged_attention import (
    paged_decode,
    paged_decode_supported,
    paged_window_attention,
    paged_window_supported,
)
from ..ops.kernels.prefill_attention import causal_prefill_attention, splash_prefill_supported
from ..ops.kernels.qmatmul import (
    MAX_ROWS,
    dequant_q4_stacked,
    dequant_supported,
    dequant_w8_stacked,
    qmatmul_w8a16,
    qmatmul_w8a16_rows,
    qmatmul_w8a16_rows_plain,
    rows_supported,
    supports_shapes,
)
from ..ops.matmul import exact_float_products, f32_matmul, qmatmul, qmatmul_exact
from ..ops.norms import rms_norm
from ..ops.quant import Q4Tensor, QuantizedTensor, dequantize, dequantize_q4_inmajor, quantize_activations
from ..ops.rope import apply_rope, rope_table

MODES = ("fast", "exact", "f32")

# The reference package's measured gate for its long-prefill "xdot" path
# (dequantize one layer, then one bf16 product): only large down-projections
# (n > d) at long windows.  In the Qwen3 shapes it admits w2 (and the 4B's
# wo), both of whose products are rounded to bf16 before the residual add.
_XDOT_PREFILL_MIN_ROWS = 4096
_XDOT_MIN_WEIGHT_ELEMS = 10_000_000


# The reference's column chunks for the row-parallel projections under tp
# (its ``_tp_overlap_chunks`` defaults; its environment overrides are A/B
# knobs and are not carried): 4 chunks from 512 rows.
_TP_OVERLAP_CHUNKS = 4
_TP_OVERLAP_MIN_ROWS = 512


def _xdot_prefill_wins(rows: int, n: int, d: int) -> bool:
    return rows >= _XDOT_PREFILL_MIN_ROWS and n > d and n * d >= _XDOT_MIN_WEIGHT_ELEMS


def _tp_overlap_chunks(rows: int, d_out: int) -> int:
    """Column chunks of a row-parallel projection under tp: each chunk's
    all-reduce can start while the next chunk's product runs.  Only worth it
    for large payloads: decode-sized all-reduces are latency-bound, so the
    chunks engage at prefill row counts (``rows``: the reference's, the
    window's bucket)."""
    c = _TP_OVERLAP_CHUNKS
    if c <= 1 or rows < _TP_OVERLAP_MIN_ROWS:
        return 1
    while c > 1 and d_out % (c * 128):
        c //= 2
    return c


def reference_rows(s: int) -> int:
    """The window width the reference engine runs for ``s`` prompt rows: it
    pads every window to a power-of-two bucket (from 32 rows), which its
    shape gates then see.  The port runs the window unpadded and asks the
    copied gates at this width."""
    return max(32, 1 << (s - 1).bit_length())


class Qwen3LayerWeights(NamedTuple):
    """Per-layer weights stacked on a leading [n_layers] axis."""

    rms_att: torch.Tensor  # [L, dim] f32
    rms_ffn: torch.Tensor  # [L, dim] f32
    q_norm: torch.Tensor  # [L, head_dim] f32
    k_norm: torch.Tensor  # [L, head_dim] f32
    # QuantizedTensor, or Q4Tensor with the in axis packed (halved) in q.
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
    return _map_weights(weights, lambda t: t, lambda qt: type(qt)(qt.q, qt.scales.to(dtype)))


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def weights_from_jax_numpy(tree) -> Qwen3Weights:
    """The reference package's ``Qwen3Weights`` with numpy leaves → the
    port's weights (CPU tensors, same layouts, same values; its ``Q4Tensor``
    leaves become the port's)."""

    def qt(t):
        kind = Q4Tensor if type(t).__name__ == "Q4Tensor" else QuantizedTensor
        return kind(_from_numpy(t.q), _from_numpy(t.scales))

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
    device=None,
) -> KVCache | QuantizedKVCache:
    """Zeroed dense cache on ``device`` (the card unless the caller asks for
    the CPU); ``dtype="int8"`` builds the quantized cache."""
    device = resolve_device(device)
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


def _write_rows(cache, layer: int, k: torch.Tensor, v: torch.Tensor, pos: np.ndarray, write_mask) -> None:
    """Write the window's K/V rows ([B, S, kv, hd]) of ``layer`` into the
    dense cache at each request's offset, in place; requests whose
    ``write_mask`` is false write nothing."""
    s = k.shape[1]
    quant = isinstance(cache, QuantizedKVCache)
    if quant:
        (k, k_sc), (v, v_sc) = _quant_rows(k), _quant_rows(v)
    for b, p in enumerate(pos.tolist()):
        if write_mask is not None and not write_mask[b]:
            continue
        cache.k[layer, b, :, p : p + s] = k[b].transpose(0, 1)
        cache.v[layer, b, :, p : p + s] = v[b].transpose(0, 1)
        if quant:
            cache.k_scale[layer, b, :, p : p + s] = k_sc[b].transpose(0, 1)
            cache.v_scale[layer, b, :, p : p + s] = v_sc[b].transpose(0, 1)


def _page_targets(table: np.ndarray, pos: np.ndarray, s: int, page: int, write_mask, dev):
    """Where the window's rows land in the pool: (batch, window row, page id,
    page row) index tensors of the rows that are written.  Row i of request b
    sits at position p = pos[b] + i, in page ``table[b, p // page]`` at row
    ``p % page``; rows of a request whose ``write_mask`` is false, and rows
    past the table, are dropped, as the reference's scatter drops them."""
    q_pos = pos[:, None] + np.arange(s)  # [B, S]
    j = q_pos // page
    keep = j < table.shape[1]
    if write_mask is not None:
        keep &= np.asarray(write_mask, bool).reshape(-1, 1)
    bi, si = np.nonzero(keep)
    idx = (bi, si, table[bi, j[bi, si]], q_pos[bi, si] % page)
    return tuple(torch.as_tensor(a, dtype=torch.long, device=dev) for a in idx)


def _write_pages(pool, layer: int, k: torch.Tensor, v: torch.Tensor, targets) -> None:
    """Write the window's K/V rows ([B, S, kv, hd]) of ``layer`` into the
    pool at ``targets`` (``_page_targets``), in place; an INT8 pool
    quantizes them first."""
    bi, si, pids, rows = targets
    if hasattr(pool, "k_scale"):
        (k, k_sc), (v, v_sc) = _quant_rows(k), _quant_rows(v)
        pool.k_scale[layer][pids, :, rows] = k_sc[bi, si]
        pool.v_scale[layer][pids, :, rows] = v_sc[bi, si]
    pool.k[layer][pids, :, rows] = k[bi, si].to(pool.k.dtype)
    pool.v[layer][pids, :, rows] = v[bi, si].to(pool.v.dtype)


def _project(x, xq, w, mode: str) -> torch.Tensor:
    """One projection against one (codes, scales) pair ``[N, D]``, as the
    reference's ``_project`` routes it (its pipeline's layer slabs and
    classifier): fast mode ``ops.matmul.qmatmul`` (the W8A16 kernel up to 256
    rows, the dense product above), exact mode ``qmatmul_exact`` on ``xq``,
    f32 mode the dequantized f32 product; INT4 weights the dense product
    of the dequantized matrix (bf16, or f32 in f32 mode), which has no exact
    mode.  → ``[..., D]`` f32."""
    if isinstance(w, Q4Tensor):
        if mode == "exact":
            raise ValueError("INT4 weights have no reference-exact (W8A8) mode")
        dtype = torch.float32 if mode == "f32" else torch.bfloat16
        wf = dequantize_q4_inmajor(w, dtype)
        with exact_float_products():
            return x.to(dtype).float() @ wf.float()
    if mode == "exact":
        return qmatmul_exact(xq, w)
    if mode == "f32":
        return f32_matmul(x, w)
    return qmatmul(x, w)


def _project_layer(x, xq, w: QuantizedTensor, layer: int, mode: str, *, rounds_to_bf16: bool = False):
    """One projection against layer ``layer`` of stacked weights, outside
    the fused kernel: ``x [..., N]`` (``xq`` its quantized form in exact
    mode) → ``[..., D]``.

    ``rounds_to_bf16``: the caller rounds the result to bf16 before using it
    (wo and w2 before the residual add).  The xdot product is then taken in
    bf16, whose f32 sum the product rounds once, as the reference rounds its
    f32 result; otherwise it keeps an f32 result.
    """
    if mode == "exact":
        return qmatmul_exact(xq, w, layer)
    if mode == "f32":
        return f32_matmul(x, w, layer)
    n, d = w.shape[-2:]  # logical: packed INT4 codes hold n/2 rows
    g = n // w.scales.shape[-2]
    q4 = isinstance(w, Q4Tensor)
    rows = x.numel() // n
    # The reference's routes, each behind its gate; what a gate refuses
    # takes the plain projection (the reference's XLA route there).
    if rows <= MAX_ROWS:
        if supports_shapes(n, d, g, q4):
            return qmatmul_w8a16(x, w, layer)
        return qmatmul_w8a16_rows_plain(x, w, layer)
    if _xdot_prefill_wins(rows, n, d) and dequant_supported(n, d, g, q4):
        wbf = dequant_q4_stacked(w, layer) if q4 else dequant_w8_stacked(w, layer)
        xb = x.reshape(rows, n).to(torch.bfloat16)
        with exact_float_products():
            out = xb @ wbf if rounds_to_bf16 else xb.float() @ wbf.float()
        return out.reshape(*x.shape[:-1], d)
    padded = x.shape[0] * reference_rows(x.shape[1]) if x.dim() == 3 else rows
    if rows_supported(n, d, g, padded, q4):
        return qmatmul_w8a16_rows(x, w, layer)
    return qmatmul_w8a16_rows_plain(x, w, layer)


def _reference_window_rows(b: int, s: int) -> int:
    """The rows the reference engine runs for a window of ``b`` requests of
    ``s`` rows: a prefill window pads to its bucket, a decode step does not."""
    return b * (reference_rows(s) if s > 1 else 1)


def _project_layer_cols(x, xq, w: QuantizedTensor, layer: int, mode: str, c0: int, dc: int, ref_rows: int):
    """One projection against out columns ``[c0, c0+dc)`` of layer ``layer``
    → ``[..., dc]`` f32.  INT8 fast mode takes the row-blocked kernel's
    column window where the reference's gate admits it (no weight copy);
    INT4, exact and f32 modes and refused shapes slice the (codes, scales)
    pair and take the plain projection (the reference's ``_project``)."""
    n, d = w.shape[-2:]
    g = n // w.scales.shape[-2]
    if mode == "fast":
        if not isinstance(w, Q4Tensor) and rows_supported(n, dc, g, ref_rows):
            return qmatmul_w8a16_rows(x, w, layer, out_cols=(c0, dc))
        return qmatmul_w8a16_rows_plain(x, w, layer, out_cols=(c0, dc))
    w_sl = type(w)(w.q[layer, :, c0 : c0 + dc].contiguous(), w.scales[layer, :, c0 : c0 + dc].contiguous())
    return qmatmul_exact(xq, w_sl) if mode == "exact" else f32_matmul(x, w_sl)


def _row_parallel(x, xq, w: QuantizedTensor, layer: int, mode: str, ref_rows: int, tp_group):
    """A row-parallel projection (wo, w2) summed over the tp ranks → f32:
    at prefill widths in column chunks, one all-reduce each."""
    d_out = w.shape[-1]
    chunks = _tp_overlap_chunks(ref_rows, d_out)
    if chunks == 1:
        return all_reduce(_project_layer(x, xq, w, layer, mode), tp_group)
    dc = d_out // chunks
    return torch.cat([all_reduce(_project_layer_cols(x, xq, w, layer, mode, ci * dc, dc, ref_rows), tp_group)
                      for ci in range(chunks)], dim=-1)


def _embed(weights, tokens: torch.Tensor, tp_group) -> torch.Tensor:
    """The tokens' embedding rows dequantized in f32.  Under tp each rank
    holds a block of vocab rows: it gathers the tokens it holds (the others
    as zeros) and the ranks' rows are all-reduced."""
    emb = weights.embed
    if tp_group is None:
        return dequantize(QuantizedTensor(emb.q[tokens], emb.scales[tokens]))
    v_local = emb.q.shape[0]
    lid = tokens - dist.get_rank(tp_group) * v_local
    ok = (lid >= 0) & (lid < v_local)
    lid = lid.clamp(0, v_local - 1)
    x = dequantize(QuantizedTensor(emb.q[lid], emb.scales[lid]))
    return all_reduce(x * ok[..., None], tp_group)


def _head(config, weights, x, mode: str, tp_group=None) -> torch.Tensor:
    """Final norm + classifier → f32 logits over the real vocabulary.  Under
    tp the rank's vocab columns are gathered before the slice: the padding
    columns sit at the end of the last rank's block."""
    xn = rms_norm(x, weights.rms_final, config.norm_eps)
    if mode == "exact":
        logits = qmatmul_exact(quantize_activations(xn, config.group_size), weights.lm_head)
    elif mode == "f32":
        logits = f32_matmul(xn, weights.lm_head)
    else:
        logits = qmatmul(xn, weights.lm_head)
    if tp_group is not None:
        logits = all_gather_last(logits.float(), tp_group)
    return logits[..., : config.vocab_size].float()


def megakernel_route(config: ModelConfig, cache, batch: int, rows: int, mode: str = "fast",
                     paged: bool = False, q4: bool = False) -> bool:
    """Whether a forward call takes the decode megakernel: a fast-mode decode
    step (one row per request) over the dense cache, on the shapes the
    reference package's gate admits (``q4``: INT4 linear layers, admitted
    only with its opt-in).  The gate looks at shapes only, so the card and
    the CPU route alike."""
    return (not paged and mode == "fast" and rows == 1
            and megakernel_supported(config, cache.seq_len, cache.k.dtype, batch, q4=q4))


def megakernel_step(config: ModelConfig, weights: Qwen3Weights, tokens: torch.Tensor, cache, pos: torch.Tensor,
                    write_ok: torch.Tensor | None = None, *, greedy_head: bool = False,
                    skip_head: bool = False) -> torch.Tensor:
    """One decode step through the megakernel, from device tensors only (no
    host synchronisation): tokens ``[B]`` ints and pos ``[B]`` int32 on the
    weights' device, write_ok ``[B]`` or None.  Returns the logits
    ``[B, vocab_size]`` f32, or with ``greedy_head`` the first-max argmax
    ``[B]`` int32, or with ``skip_head`` the f32 residual stream ``[B, dim]``
    (the classifier not fused); the cache is updated in place.

    The embedding row is rounded to bf16, the stream's dtype in fast mode, as
    the reference casts it before its call.  Where the classifier is not
    fused, it runs after the kernel on the f32 stream."""
    c, lw = config, weights.layers
    dev = weights.embed.q.device
    tokens = tokens.reshape(-1).long()
    x = dequantize(QuantizedTensor(weights.embed.q[tokens], weights.embed.scales[tokens]))
    x = x.to(torch.bfloat16).float()
    cos_t, sin_t = rope_table(cache.seq_len, c.head_dim, c.rope_theta, dev)
    rows = pos.long().clamp(0, cache.seq_len - 1)
    fuse = not skip_head and head_phase_supported(c, weights.lm_head.q.shape[-1])
    greedy = greedy_head and fuse
    x_out, head = decode_stack_megakernel(
        c, x, lw.rms_att, lw.rms_ffn, lw.q_norm, lw.k_norm, cos_t[rows], sin_t[rows],
        lw.wqkv, lw.wo, lw.w13, lw.w2, cache.k, cache.v, pos,
        weights.rms_final if fuse else None, weights.lm_head if fuse else None, write_ok,
        k_scale=getattr(cache, "k_scale", None), v_scale=getattr(cache, "v_scale", None),
        eps=c.norm_eps, greedy=greedy,
    )
    if greedy:
        return head
    if skip_head:
        return x_out
    logits = head[:, : c.vocab_size] if fuse else _head(c, weights, x_out, "fast")
    return logits.argmax(dim=-1).to(torch.int32) if greedy_head else logits


def qwen3_forward(
    config: ModelConfig,
    weights: Qwen3Weights,
    tokens,
    cache: KVCache | QuantizedKVCache,
    pos_start,
    *,
    mode: str = "fast",
    out_idx=None,
    return_all_logits: bool = False,
    fresh_prefill: bool = False,
    page_table=None,
    write_mask=None,
    greedy_head: bool = False,
    skip_head: bool = False,
    sp_mesh=None,
    tp_group=None,
):
    """One model step: prefill when S > 1, decode when S == 1.

    ``tokens`` [B, S] ints; ``pos_start`` [B] host ints, the absolute
    position of each row's first token; ``out_idx`` [B] host ints, the window
    row whose logits are returned (default: the last).  ``fresh_prefill``
    states that every position is 0 (checked), which routes long fast-mode
    windows to the causal prefill kernel.  ``page_table`` ([B, max_pages]
    ints) makes ``cache`` a page pool (``serving/paged_cache.py``): cache
    row t of request b is row ``t % page`` of page ``page_table[b, t // page]``,
    RoPE covers ``config.seq_len`` positions, and rows past the table are
    dropped.  ``write_mask`` ([B] bools): requests whose entry is false
    write nothing into the cache (idle and mid-prefill serving slots).
    Returns (logits [B, vocab_size] f32, or [B, S, vocab_size] with
    ``return_all_logits``; cache), the cache updated in place.
    ``greedy_head`` returns the first-max argmax of those logits (int32) in
    their place; the megakernel fuses it into its classifier phase.
    ``skip_head`` returns the residual stream ``[B, S, dim]`` (``[B, 1,
    dim]`` f32 from the megakernel) in place of the logits.
    ``tp_group``: this rank's process group of a tensor-parallel forward
    (the weights and the cache its shards, ``config`` the local config;
    ``parallel/tp.py``); the logits are global.

    ``sp_mesh`` (this rank's mesh on the ``sp`` axis of N ranks, every rank
    calling the forward with the same arguments): a fresh window of S > 1
    rows that divides over N runs sequence-parallel.  Rank r takes the S/N
    rows from r·S/N through the embedding, the norms and every projection,
    and the attention is the ring over the ranks
    (``parallel.context.ring_prefill_attention_inner``) in place of the
    causal prefill kernel.  After the last layer rank 0 gathers every rank's
    K/V rows into its dense cache (rows past a request's ``out_idx`` are
    padding and write nothing) and the hidden rows the head needs from the
    ranks that hold them, and returns as above; the other ranks need no
    cache (``cache`` may be None) and return ``(None, None)``.
    """
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if greedy_head and (skip_head or tp_group is not None):
        # skip_head has no logits to reduce; under tp the classifier's columns
        # are gathered after it: the fused argmax of the reference would see
        # local ids.
        raise ValueError("greedy_head requires the full head (no skip_head/tp_axis)")
    dev = weights.embed.q.device
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape
    pos = np.asarray(torch.as_tensor(pos_start).cpu(), np.int64).reshape(b)
    paged = page_table is not None
    n_sp = sp_mesh.shape.get("sp", 1) if sp_mesh is not None else 1
    ring = fresh_prefill and n_sp > 1 and s > 1 and s % n_sp == 0
    r0, s_total = 0, s
    if ring:
        if paged or tp_group is not None:
            raise ValueError("the sequence-parallel prefill takes the dense cache and no tensor parallelism")
        s = s_total // n_sp
        r0 = sp_mesh.rank * s
        tokens = tokens[:, r0 : r0 + s]
    if paged:
        page = cache.k.shape[3]
        table = np.asarray(torch.as_tensor(page_table).cpu(), np.int64).reshape(b, -1)
        t_max, rope_len = table.shape[1] * page, config.seq_len
        bad = (pos < 0) | (pos > t_max)  # rows past the table are dropped, not refused
    elif cache is None and ring:  # an sp rank past 0: no cache (rank 0 checks the window against its own)
        t_max = rope_len = s_total
        bad = pos < 0
    else:
        t_max = rope_len = cache.seq_len
        if write_mask is not None:
            # A masked row (a finished serving slot inside a decode chunk) may
            # have run past the window: it writes nothing and its result is
            # dropped, so it reads up to the window's end.
            masked = ~np.asarray(write_mask, bool).reshape(b)
            pos = np.where(masked, np.clip(pos, 0, max(t_max - s, 0)), pos)
        bad = (pos < 0) | (pos + s_total > t_max)
    if bad.any():
        raise ValueError(
            f"window of {s_total} rows at positions {pos.tolist()} does not fit the cache of {t_max} rows"
        )
    if fresh_prefill and pos.any():
        raise ValueError(f"fresh_prefill with positions {pos.tolist()}: a fresh window starts at 0")
    if tp_group is None and not ring and megakernel_route(config, cache, b, s, mode, paged,
                                             q4=isinstance(weights.layers.wqkv, Q4Tensor)):
        ok = None if write_mask is None else torch.as_tensor(np.asarray(write_mask, bool), device=dev)
        out = megakernel_step(config, weights, tokens[:, 0], cache, torch.as_tensor(pos, dtype=torch.int32, device=dev),
                              ok, greedy_head=greedy_head, skip_head=skip_head)
        return (out[:, None] if return_all_logits or skip_head else out), cache
    c = config
    eps, g = c.norm_eps, c.group_size
    bf16 = torch.bfloat16
    exact = mode == "exact"
    cd = torch.float32 if exact else bf16  # the residual stream's dtype
    ah, kvd, hd = c.all_heads_dim, c.kv_dim, c.head_dim
    ks_all, vs_all = (cache.k_scale, cache.v_scale) if hasattr(cache, "k_scale") else (None, None)
    fast = mode == "fast"
    lw = weights.layers
    # Each kernel behind the reference's gate for it, decided from shapes
    # alone; what a gate refuses takes the plain path (the reference's XLA
    # route).  Flash decode engages below the reference's 512-row minimum
    # window too (a speed choice on its chip).
    fused = fast and b * s <= MAX_ROWS and all(
        supports_shapes(n, d, g, isinstance(w, Q4Tensor)) for w, (n, d) in zip(
            (lw.wqkv, lw.wo, lw.w13, lw.w2),
            ((c.dim, ah + 2 * kvd), (ah, c.dim), (c.dim, 2 * c.hidden_dim), (c.hidden_dim, c.dim))))
    prefill_kernel = (fast and fresh_prefill and not ring and s > MAX_ROWS
                      and splash_prefill_supported(reference_rows(s), hd, c.n_heads, c.n_kv_heads))
    paged_decode_kernel = (paged and fast and s == 1
                           and paged_decode_supported(hd, cache.k.shape[3], cache.k.dtype))
    # A small window on the pool: the reference's paged window gate.  A fresh
    # window takes the same f32 attention, but has no cache prefix to read.
    window_kernel = (paged and fast and not prefill_kernel
                     and paged_window_supported(hd, cache.k.shape[3], cache.k.dtype, s, c.kv_mul))
    flash_kernel = (not paged and fast and s == 1
                    and decode_supported(c.n_heads, c.n_kv_heads, hd, cache.seq_len, min_seq_len=0))
    ref_rows = _reference_window_rows(b, s)

    def quant(t):
        return quantize_activations(t, g) if exact else None

    def _down(t, tq, w, l):
        """A row-parallel projection (wo, w2), whose result the caller rounds
        to the stream's dtype."""
        if tp_group is None:
            return _project_layer(t, tq, w, l, mode, rounds_to_bf16=True)
        return _row_parallel(t, tq, w, l, mode, ref_rows, tp_group)

    # Embedding: gather the quantized rows, dequantize in f32.
    x = _embed(weights, tokens, tp_group).to(cd)

    # Positions past the RoPE table (padding rows past the context) take its
    # last row, as the reference's gather clamps them.
    q_pos = torch.as_tensor(np.minimum(pos[:, None] + r0 + np.arange(s), rope_len - 1), device=dev)  # [B, S]
    cos_t, sin_t = rope_table(rope_len, hd, c.rope_theta, dev)
    cos = cos_t[q_pos][:, :, None, :]  # [B, S, 1, hd/2]
    sin = sin_t[q_pos][:, :, None, :]
    pos_dev = torch.as_tensor(pos, dtype=torch.int32, device=dev) if flash_kernel or paged_decode_kernel or window_kernel else None
    if paged:
        table_dev = torch.as_tensor(table, dtype=torch.int32, device=dev)
        targets = _page_targets(table, pos, s, page, write_mask, dev)
    kv_rows = []  # the sp path's K/V rows of every layer, written by rank 0 after the last

    for l in range(c.n_layers):
        if fused:
            qkv = qmatmul_w8a16(x, lw.wqkv, l, norm_w=lw.rms_att, eps=eps)  # f32
        else:
            xn = rms_norm(x, lw.rms_att[l], eps)
            qkv = _project_layer(xn, quant(xn), lw.wqkv, l, mode)
        q = qkv[..., :ah].reshape(b, s, c.n_heads, hd)
        k = qkv[..., ah : ah + kvd].reshape(b, s, c.n_kv_heads, hd)
        v = qkv[..., ah + kvd :].reshape(b, s, c.n_kv_heads, hd)
        if c.use_qk_norm:
            q = rms_norm(q, lw.q_norm[l], eps)
            k = rms_norm(k, lw.k_norm[l], eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        pool_kw = dict(k_scale_pool=ks_all, v_scale_pool=vs_all)
        if ring:
            from ..parallel.context import ring_prefill_attention_inner  # the parallel package imports this module

            att = ring_prefill_attention_inner(q.to(cd), k.to(cd), v.to(cd), sp_mesh)
        elif paged_decode_kernel:
            # The reference rounds the paged kernels' f32 output to the stream's dtype.
            att = paged_decode(q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, table_dev, pos_dev, l, **pool_kw).to(cd)
        elif flash_kernel:
            att = flash_decode(
                q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, pos_dev, l,
                k_scale_all=ks_all, v_scale_all=vs_all,
            )
        elif prefill_kernel:
            att = causal_prefill_attention(q.to(bf16), k.to(bf16), v.to(bf16))
        elif window_kernel:
            att = paged_window_attention(q, k, v, cache.k, cache.v, table_dev, pos_dev, l, **pool_kw,
                                         fresh=fresh_prefill).to(cd)
        elif paged:
            att = gqa_attention_split_paged(
                q.to(cd), cache.k[l], cache.v[l], table_dev, k.to(cd), v.to(cd), pos,
                k_scale_pool=None if ks_all is None else ks_all[l],
                v_scale_pool=None if vs_all is None else vs_all[l],
            )
        else:
            att = gqa_attention_split(
                q.to(cd), cache.k[l], cache.v[l], k.to(cd), v.to(cd), pos,
                k_scale_cache=None if ks_all is None else ks_all[l],
                v_scale_cache=None if vs_all is None else vs_all[l],
            )
        if ring:
            kv_rows.append((k, v))
        elif paged:
            _write_pages(cache, l, k, v, targets)
        else:
            _write_rows(cache, l, k, v, pos, write_mask)
        att = att.reshape(b, s, ah)
        if fused and tp_group is None:
            x = qmatmul_w8a16(att, lw.wo, l, residual=x).to(bf16)
            gate_up = qmatmul_w8a16(x, lw.w13, l, norm_w=lw.rms_ffn, eps=eps)
            x = qmatmul_w8a16(gate_up, lw.w2, l, swiglu=True, residual=x).to(bf16)
            continue
        if fused:
            # Under tp the all-reduce sits between the product and the residual
            # add, so the residual cannot ride the kernel's epilogue.
            x = x + all_reduce(qmatmul_w8a16(att, lw.wo, l), tp_group).to(bf16)
            gate_up = qmatmul_w8a16(x, lw.w13, l, norm_w=lw.rms_ffn, eps=eps)
            x = x + all_reduce(qmatmul_w8a16(gate_up, lw.w2, l, swiglu=True), tp_group).to(bf16)
            continue
        # Unfused layer body, in the reference's dtypes: each projection's f32
        # result (under tp: summed over the ranks) is rounded to the stream's
        # dtype, then added in that dtype.
        att = att.to(cd)
        x = x + _down(att, quant(att), lw.wo, l).to(cd)
        xn = rms_norm(x, lw.rms_ffn[l], eps)
        gate_up = _project_layer(xn, quant(xn), lw.w13, l, mode)
        gate, up = gate_up[..., : c.hidden_dim], gate_up[..., c.hidden_dim :]
        h = (gate * torch.sigmoid(gate) * up).to(cd)
        x = x + _down(h, quant(h), lw.w2, l).to(cd)

    if ring:
        x = _sp_gather(cache, x, kv_rows, out_idx, write_mask, sp_mesh, s_total, return_all_logits or skip_head)
        if sp_mesh.rank != 0:
            return None, None
    if skip_head:
        return x, cache
    if not return_all_logits:
        if out_idx is None or ring:
            x = x[:, -1]
        else:
            rows = torch.as_tensor(np.asarray(out_idx, np.int64).reshape(b), device=dev)
            x = x[torch.arange(b, device=dev), rows]
    logits = _head(c, weights, x, mode, tp_group)
    if greedy_head:
        return logits.argmax(dim=-1).to(torch.int32), cache
    return logits, cache


def _sp_gather(cache, x, kv_rows, out_idx, write_mask, mesh, s_total: int, all_rows: bool):
    """The end of a sequence-parallel window on rank ``mesh.rank`` of N (each
    holding S/N rows from ``rank · S/N``): every rank sends rank 0 its K/V
    rows of every layer and, of its residual stream ``x`` ``[B, S/N, dim]``,
    every row (``all_rows``) or the rows at ``out_idx`` it holds (zeros for
    the others).  Rank 0 writes the K/V rows of each request up to its
    ``out_idx`` (default the last row; a masked request writes none) into
    its dense cache and returns the stream ``[B, S, dim]``, or the
    ``out_idx`` rows as ``[B, 1, dim]``; the other ranks return None."""
    n, rank = mesh.shape["sp"], mesh.rank
    b, s_loc = x.shape[:2]
    dev = x.device
    last = np.full(b, s_total - 1) if out_idx is None else np.asarray(out_idx, np.int64).reshape(b)
    k_all = torch.stack([k for k, _ in kv_rows])  # [L, B, S/N, kv, hd]
    v_all = torch.stack([v for _, v in kv_rows])
    if all_rows:
        part = x
    else:
        part = torch.zeros(b, 1, x.shape[-1], dtype=x.dtype, device=dev)
        for i in range(b):
            if rank * s_loc <= last[i] < (rank + 1) * s_loc:
                part[i, 0] = x[i, last[i] - rank * s_loc]
    if rank != 0:
        exchange([(k_all, 0), (v_all, 0), (part, 0)], [], mesh.group, dev)
        return None
    got = exchange([], [(t.shape, t.dtype, r) for r in range(1, n) for t in (k_all, v_all, part)], mesh.group, dev)
    ranks = [(k_all, v_all, part)] + [tuple(got[3 * j : 3 * j + 3]) for j in range(n - 1)]
    for r, (kr, vr, _) in enumerate(ranks):
        for i in range(b):
            rows = min(s_loc, int(last[i]) + 1 - r * s_loc)
            if rows <= 0 or (write_mask is not None and not write_mask[i]):
                continue
            sub = type(cache)(*(t[:, i : i + 1] for t in cache))
            for l in range(kr.shape[0]):
                _write_rows(sub, l, kr[l, i : i + 1, :rows], vr[l, i : i + 1, :rows], np.asarray([r * s_loc]), None)
    parts = [p for _, _, p in ranks]
    return torch.cat(parts, dim=1) if all_rows else sum(parts[1:], parts[0])
